"""The port's emitted trainer (``train_gpu.py``) against the JAX package's
emitted ``train_tpu.py``, each rendered from the JAX planner's service of
a sample and run from its own payload in a subprocess on the CPU.

Llama and GPT-2, fp32, 10 steps: each side's ``port_weights.py`` ports
the same tiny HF state dict into its checkpoint and each side's trainer
starts from it on the same ``default_rng(i)`` batches. The step-10 loss
both print (4 decimals) agrees within ``LOSS_REL``, and the final
checkpoints' parameters (the JAX side's read with orbax and passed
through ``params_from_jax``) agree per leaf within ``PARAM_REL`` of relative
norm. The other families, resume, a retried fault and the refusals are
in ``tests/test_torch_emitted_families.py``.

The JAX side runs as the JAX package runs on the CPU: one device,
``M2KT_MESH_*=1``. Every subprocess runs in ``tmp_path`` with an env
holding no ``M2KT_*`` key but the ones it sets, under a timeout.
"""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.containerizer import jax_emit  # noqa: E402
from move2kube_tpu.engine.planner import create_plan  # noqa: E402
from move2kube_tpu_torch.containerizer import cuda_emit  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.models.gpt2 import GPT2Config  # noqa: E402
from move2kube_tpu_torch.models.llama import LlamaConfig  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SAMPLES = REPO / "samples" / "gpu-training"
TIMEOUT_S = 240
# the step-10 loss, printed to 4 decimals by both trainers: fp32 on both
# sides, sums taken in other orders (tests/test_torch_train.py holds the
# step losses to 1e-5); 1e-4 relative is one unit of the 4th decimal
LOSS_REL = 1e-4
# the final parameters after 10 Adam(W) steps, per leaf: the norm of the
# difference over the JAX leaf's norm. Adam divides each gradient by its
# own magnitude, so an entry whose gradient is near zero moves by up to
# the learning rate on rounding alone (tests/test_torch_families.py's
# UPDATE_REL)
PARAM_REL = 1e-3
MESH_ONE = {f"M2KT_MESH_{a}": "1" for a in ("DATA", "FSDP", "PIPE", "TENSOR",
                                            "SEQ", "EXPERT")}
LLAMA_TINY = {"M2KT_VOCAB": "256", "M2KT_DMODEL": "64", "M2KT_LAYERS": "2",
              "M2KT_HEADS": "4", "M2KT_KV_HEADS": "2", "M2KT_MLP_DIM": "128",
              "M2KT_SEQ_LEN": "32", "M2KT_BATCH_PER_DEVICE": "2"}
GPT2_TINY = {"M2KT_VOCAB": "256", "M2KT_DMODEL": "64", "M2KT_LAYERS": "2",
             "M2KT_HEADS": "4", "M2KT_MAX_LEN": "64", "M2KT_SEQ_LEN": "32",
             "M2KT_BATCH_PER_DEVICE": "2"}


def _service(sample: str):
    plan = create_plan(str(SAMPLES / sample))
    (opts,) = [o for o in plan.services.values()
               if o and o[0].accelerator is not None]
    return opts[0], plan


def _write(files: dict, out: Path) -> Path:
    for rel, text in files.items():
        path = out / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return out


def _env(tmp: Path, **knobs) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("M2KT_") and k not in ("PYTHONPATH",
                                                     "XLA_FLAGS")}
    env.update({"JAX_PLATFORMS": "cpu", "JAX_PLATFORM_NAME": "cpu",
                # one thread a process: the trainers' ranks and the
                # xdist workers share the box's cores (tiny widths)
                "OMP_NUM_THREADS": "1",
                "M2KT_METRICS_PORT": "0",
                "M2KT_PREEMPT_FILE": str(tmp / "preempt"),
                "M2KT_COMPILE_CACHE_DIR": str(tmp / "cache")})
    env.update({k: str(v) for k, v in knobs.items()})
    return env


def _run(cwd: Path, argv, env, timeout=TIMEOUT_S):
    return subprocess.run(argv, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def run_jax_trainer(cwd, env):
    return _run(cwd, [sys.executable, "-c",
                      "import jax; jax.config.update('jax_platforms','cpu');"
                      "import runpy; runpy.run_path('train_tpu.py', "
                      "run_name='__main__')"], env)


def run_port_trainer(cwd, env, supervised=False):
    argv = [sys.executable, "train_gpu.py"]
    if supervised:
        argv = [sys.executable, "-m",
                "move2kube_tpu_torch.resilience.supervisor", "--", *argv]
    return _run(cwd, argv, dict(env, M2KT_DEVICE="cpu"))


def _port_payload(svc, tmp: Path, name: str = "port") -> Path:
    return _write(cuda_emit.emit_container(svc).new_files, tmp / name)


def _hf_llama(path: Path) -> None:
    gen = np.random.default_rng(13)
    v, d, layers, h, kv, m = 256, 64, 2, 4, 2, 128
    hd = d // h

    def draw(*shape):
        return torch.from_numpy(gen.standard_normal(shape, np.float32)
                                * np.float32(0.05))

    sd = {"model.embed_tokens.weight": draw(v, d),
          "model.norm.weight": torch.ones(d), "lm_head.weight": draw(v, d)}
    for i in range(layers):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (h * hd, d)),
                            ("self_attn.k_proj", (kv * hd, d)),
                            ("self_attn.v_proj", (kv * hd, d)),
                            ("self_attn.o_proj", (d, h * hd)),
                            ("mlp.gate_proj", (m, d)), ("mlp.up_proj", (m, d)),
                            ("mlp.down_proj", (d, m))):
            sd[p + name + ".weight"] = draw(*shape)
        sd[p + "input_layernorm.weight"] = torch.ones(d)
        sd[p + "post_attention_layernorm.weight"] = torch.ones(d)
    torch.save(sd, path)


def _hf_gpt2(path: Path) -> None:
    gen = np.random.default_rng(14)
    v, d, layers, pos = 256, 64, 2, 64

    def draw(*shape, scale=0.05):
        return torch.from_numpy(gen.standard_normal(shape, np.float32)
                                * np.float32(scale))

    sd = {"transformer.wte.weight": draw(v, d),
          "transformer.wpe.weight": draw(pos, d),
          "transformer.ln_f.weight": torch.ones(d),
          "transformer.ln_f.bias": torch.zeros(d)}
    for i in range(layers):
        p = f"transformer.h.{i}."
        for name, (a, b) in (("attn.c_attn", (d, 3 * d)),
                             ("attn.c_proj", (d, d)), ("mlp.c_fc", (d, 4 * d)),
                             ("mlp.c_proj", (4 * d, d))):
            sd[p + name + ".weight"] = draw(a, b)
            sd[p + name + ".bias"] = draw(b, scale=0.01)
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = torch.ones(d)
            sd[p + ln + ".bias"] = torch.zeros(d)
    torch.save(sd, path)


def _jax_final_params(ckpt: Path, step: int, cfg) -> dict:
    """The JAX trainer's params at ``step``, as the port's state dict. Its
    ``restore_variables`` cannot read a TrainState step with the installed
    orbax (a tree-structure mismatch; it falls back to the ported step
    0), so the step is read as orbax saved it, with no target tree."""
    import jax
    import orbax.checkpoint as ocp

    raw = ocp.CheckpointManager(str(ckpt)).restore(
        step, args=ocp.args.StandardRestore())
    return params_from_jax(jax.tree.map(np.asarray, raw["params"]), cfg)


def _step_loss(out: str, step: int) -> float:
    return float(re.search(rf"\[m2kt\] step={step} loss=([-\d.]+)",
                           out).group(1))


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_emitted_trainer_agrees_with_the_jax_one(tmp_path, family):
    sample, knobs, make_hf = {
        "llama": ("llama3-8b", LLAMA_TINY, _hf_llama),
        "gpt2": ("gpt2", GPT2_TINY, _hf_gpt2)}[family]
    svc, plan = _service(sample)
    jdir = _write(jax_emit.emit_container(svc, plan).new_files,
                  tmp_path / "jax")
    pdir = _port_payload(svc, tmp_path)
    (tmp_path / "hf").mkdir()
    make_hf(tmp_path / "hf" / "pytorch_model.bin")
    env = _env(tmp_path, M2KT_STEPS=10, M2KT_PRECISION="fp32",
               M2KT_CKPT_EVERY=100, **MESH_ONE, **knobs)

    def side(cwd, ckpt, train):
        env_side = dict(env, M2KT_CKPT_DIR=str(ckpt))
        if cwd is pdir:
            env_side["M2KT_DEVICE"] = "cpu"
        ported = _run(cwd, [sys.executable, "port_weights.py",
                            str(tmp_path / "hf"), str(ckpt)], env_side)
        assert ported.returncode == 0, ported.stderr[-3000:]
        assert "[m2kt] ported" in ported.stdout
        return ported, train(cwd, env_side)

    with ThreadPoolExecutor(2) as pool:
        fj = pool.submit(side, jdir, tmp_path / "ckpt-jax", run_jax_trainer)
        fp = pool.submit(side, pdir, tmp_path / "ckpt-port",
                         run_port_trainer)
        (jp, jrun), (pp, prun) = fj.result(), fp.result()
    assert jp.stdout.split()[2] == pp.stdout.split()[2]  # arrays ported
    for run in (jrun, prun):
        assert run.returncode == 0, run.stderr[-3000:]
        assert "[m2kt] done steps=10" in run.stdout
    assert "[m2kt] loaded ported weights from checkpoint step 0" \
        in prun.stdout
    # on the CPU the attention runs the kernels' plain versions: no launch
    assert ('[m2kt] kernel launches {"flash_fwd": 0, "flash_bwd_dq": 0, '
            '"flash_bwd_dkv": 0, "paged_decode": 0, "paged_decode_int8": 0}'
            in prun.stdout.splitlines())
    lj, lp = _step_loss(jrun.stdout, 10), _step_loss(prun.stdout, 10)
    assert abs(lp - lj) <= LOSS_REL * abs(lj), (lp, lj)

    cfg = (LlamaConfig(vocab_size=256, d_model=64, num_layers=2, num_heads=4,
                       num_kv_heads=2, mlp_dim=128, max_len=32,
                       dtype=torch.float32) if family == "llama" else
           GPT2Config(vocab_size=256, n_positions=64, d_model=64,
                      num_layers=2, num_heads=4, dtype=torch.float32))
    ref = _jax_final_params(tmp_path / "ckpt-jax", 10, cfg)
    assert sorted(os.listdir(tmp_path / "ckpt-port")) == ["0", "10"]
    ours = torch.load(tmp_path / "ckpt-port" / "10" / "state.pt",
                      map_location="cpu", weights_only=True)["model"]
    assert set(ours) == set(ref)
    if family == "gpt2":
        # the key third of GPT-2's c_attn bias shifts every score of a
        # query row by the same amount, so its gradient is zero but for
        # rounding, and Adam moves each such entry by up to the learning
        # rate a step on the sign of that noise: it is held to that, and
        # the query and value thirds to PARAM_REL as every other leaf
        d = cfg.d_model
        for i in range(cfg.num_layers):
            name = f"h.{i}.c_attn.bias"
            o, r = ours.pop(name), ref.pop(name)
            for part in (slice(0, d), slice(2 * d, 3 * d)):
                ours[f"{name}[{part.start}]"] = o[part]
                ref[f"{name}[{part.start}]"] = r[part]
            assert float((o[d:2 * d] - r[d:2 * d]).abs().max()) <= \
                2 * 10 * 3e-4
    worst = max(float((ours[k] - ref[k]).norm() / ref[k].norm())
                for k in ref)
    assert worst <= PARAM_REL, worst
