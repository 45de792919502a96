"""Import hygiene and device defaults of the port.

The port (``move2kube_tpu_torch/``) and its card-side check
(``chip_smoke.py``) import torch and never JAX, flax, optax or anything of
the JAX package, even modules there that do not import JAX themselves.
Its entry points run on the card unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "move2kube_tpu")


def _port_files():
    files = sorted((REPO / "move2kube_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) >= 10 and all(f.is_file() for f in files)
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, move2kube_tpu_torch, move2kube_tpu_torch.ops."
            "_build; bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


def test_entry_points_default_to_the_card():
    _no_cuda()
    from move2kube_tpu_torch import (
        EngineConfig,
        Llama,
        ServingEngine,
        init_llama,
        llama_tiny,
    )
    from move2kube_tpu_torch._device import DEFAULT_DEVICE, resolve_device

    assert DEFAULT_DEVICE == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(llama_tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_llama(llama_tiny(), seed=0)
    model = Llama(llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, EngineConfig(quant="int8-kv"))


def test_train_step_runs_where_the_model_lies():
    """The training entry points take the card by default through the
    model (``init_llama`` above raises without CUDA); a model built with
    ``device="cpu"`` trains on the CPU, with a CPU batch."""
    import dataclasses

    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        init_llama,
        llama_tiny,
        make_lm_train_step,
    )

    cfg = dataclasses.replace(llama_tiny(), num_layers=1)
    model = init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)
    state = TrainState(model, adamw(model.parameters(), 1e-3))
    state, loss = make_lm_train_step(chunk=128)(
        state, {"input_ids": torch.zeros(2, 8, dtype=torch.long)})
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    assert state.step == 1


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the check exits non-zero and prints no result line;
    so it does alone in a directory without the port."""
    _no_cuda()
    env = dict(os.environ, PYTHONPATH="")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode != 0, res.stdout
        assert '"ok": true' not in res.stdout
