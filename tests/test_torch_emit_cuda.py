"""The port's emitted programs on a card, at tiny widths: the emitter
renders the Llama training and serving payloads (``chip_smoke.py``'s
stand-in services), the emitted trainer runs 2 steps on the flash
kernels and checkpoints, and the emitted server serves one request from
that checkpoint on the flash and paged kernels.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_emit_cuda.py
"""

import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from move2kube_tpu_torch.containerizer import cuda_emit  # noqa: E402

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
TINY = {"M2KT_VOCAB": "256", "M2KT_DMODEL": "256", "M2KT_LAYERS": "2",
        "M2KT_HEADS": "2", "M2KT_KV_HEADS": "1", "M2KT_MLP_DIM": "512"}


@pytest.fixture
def payloads(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return {kind: cuda_emit.write_payload(cuda_emit.emit_container(svc),
                                          str(tmp_path / kind))
            for kind, svc in chip_smoke.emit_services(str(REPO)).items()}


def _env(tmp_path, **knobs):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("M2KT_") and k != "PYTHONPATH"}
    env.update({"M2KT_METRICS_PORT": "0", "M2KT_DIAG": "0",
                "M2KT_PREEMPT_FILE": str(tmp_path / "preempt"),
                "M2KT_COMPILE_CACHE_DIR": str(tmp_path / "kernels")},
               **TINY, **knobs)
    return env


def test_emitted_trainer_then_server_on_the_card(tmp_path, payloads):
    ckpt = tmp_path / "ckpt"
    mesh = {f"M2KT_MESH_{a}": "1" for a in ("DATA", "FSDP", "PIPE",
                                            "TENSOR", "SEQ", "EXPERT")}
    train = subprocess.run(
        [sys.executable, "train_gpu.py"], cwd=payloads["train"],
        env=_env(tmp_path, M2KT_STEPS="2", M2KT_SEQ_LEN="128",
                 M2KT_BATCH_PER_DEVICE="2", M2KT_CKPT_DIR=str(ckpt),
                 M2KT_CKPT_EVERY="1", **mesh),
        capture_output=True, text=True, timeout=600)
    assert train.returncode == 0, train.stderr[-3000:]
    assert "device=cuda" in train.stdout
    assert "[m2kt] done steps=2" in train.stdout
    # 2 steps and the cost model's held one, 2 layers, the forward twice
    # a layer (remat)
    line = next(x for x in train.stdout.splitlines()
                if x.startswith("[m2kt] kernel launches "))
    assert json.loads(line.split(" ", 3)[3]) == {
        "flash_fwd": 12, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
        "paged_decode": 0, "paged_decode_int8": 0}
    log = tmp_path / "serve.log"
    with open(log, "w") as out:
        server = subprocess.Popen(
            [sys.executable, "serve_gpu.py"], cwd=payloads["serve"],
            env=_env(tmp_path, M2KT_SERVE_PORT="0", M2KT_WEIGHTS_PORT="0",
                     M2KT_SERVE_MAX_SEQ="256", M2KT_CKPT_DIR=str(ckpt)),
            stdout=out, stderr=subprocess.STDOUT, text=True)
        try:
            port = None
            t_end = time.monotonic() + 300
            while port is None and time.monotonic() < t_end:
                assert server.poll() is None, log.read_text()[-3000:]
                for line in log.read_text().splitlines():
                    if line.startswith("[m2kt] serving on :"):
                        port = int(line.split(":")[1].split()[0])
                time.sleep(0.5)
            assert port is not None, log.read_text()[-3000:]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"prompt": [3, 1, 4, 1, 5],
                                 "max_new_tokens": 4}).encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                doc = json.loads(resp.read())
            assert len(doc["tokens"]) == 4
            assert doc["finish_reason"] == "length"
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats", timeout=60) as resp:
                stats = json.loads(resp.read())
            assert stats["device"].startswith("cuda")
            # the request's; the warm request's are a record beside
            assert stats["passes"]["prefill"] == 1
            assert stats["warm"]["passes"]["prefill"] == 1
            # after the warm request: one prefill and 3 decode passes
            assert stats["launches"] == {
                "flash_fwd": 2, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "paged_decode": 6, "paged_decode_int8": 0}
        finally:
            server.kill()
            server.wait(timeout=60)
    assert "[m2kt] weights from store" in log.read_text()
