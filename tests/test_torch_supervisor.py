"""The port's supervisor (``move2kube_tpu_torch/resilience/
supervisor.py``) over the port's minitrain on the CPU, as the JAX
package's ``tests/test_resilience.py`` drives the reference's: a SIGKILL
at step 5 is classified retryable and the restarted attempt resumes from
the step-4 checkpoint, with the exit file, goodput file and flight doc
of the reference's shape and the losses of an uninterrupted run, bit for
bit; retry exhaustion reports the last rc; the SIGTERM handler comes
back on every way out; minitrain refuses forced CPU ranks on a card and a
missing card.

Hygiene: every subprocess runs with ``cwd`` under ``tmp_path``, an env
copied from ``os.environ`` with every ``M2KT_*`` key removed and then set
explicitly, and a timeout; faults that end a process fire only in
children; no process group is initialized in the test process; the
SIGTERM handler, ``os.environ`` and the kernel build directory are
checked unchanged after every test.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread
# torch sets TORCHINDUCTOR_CACHE_DIR in os.environ once, when _dynamo first
# loads (an optimizer's first step loads it): load it before any test
# snapshots the environment
import torch._dynamo  # noqa: E402,F401

from move2kube_tpu_torch.ops import _build  # noqa: E402
from move2kube_tpu_torch.resilience import faults  # noqa: E402
from move2kube_tpu_torch.resilience import minitrain  # noqa: E402
from move2kube_tpu_torch.resilience import supervisor  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240


def _environ() -> dict:
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    handler = signal.getsignal(signal.SIGTERM)
    env = _environ()
    build = _build.build_dir()
    yield
    assert signal.getsignal(signal.SIGTERM) == handler
    assert _environ() == env
    assert _build.build_dir() == build
    assert not torch.distributed.is_initialized()


def child_env(**knobs) -> dict:
    """``os.environ`` without any ``M2KT_*`` key, then ``knobs``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env["PYTHONPATH"] = REPO
    # one thread a child: the xdist workers share the box's cores
    env["OMP_NUM_THREADS"] = "1"
    env.update({k: str(v) for k, v in knobs.items()})
    return env


# -- the supervisor over the port's minitrain ----------------------------------


def _supervise(tmp_path, **knobs):
    """Start the supervisor over minitrain on the CPU under ``tmp_path``;
    returns the process (the caller waits)."""
    env = child_env(
        M2KT_DEVICE="cpu", M2KT_RETRY_BACKOFF_S="0.1",
        M2KT_EXIT_FILE=tmp_path / "exit.json",
        M2KT_GOODPUT_FILE=tmp_path / "goodput.json",
        M2KT_FLIGHT_PATH=tmp_path / "flight.json",
        M2KT_PREEMPT_FILE=tmp_path / "preempt", **knobs)
    return subprocess.Popen(
        [sys.executable, "-m", "move2kube_tpu_torch.resilience.supervisor",
         "--", sys.executable, "-m", "move2kube_tpu_torch.resilience.minitrain"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    """Both supervised runs, started together: a SIGKILL at step 5 with a
    marker (resumes), and an exit-7 fault at step 2 on every attempt with
    a planted numerics sidecar (exhausts its retries)."""
    kill_dir = tmp_path_factory.mktemp("sigkill")
    exhaust_dir = tmp_path_factory.mktemp("exhaust")
    planted = {"step": 1, "first_bad_group": "layer_0"}
    (exhaust_dir / "flight.json.numerics").write_text(json.dumps(planted))
    procs = {
        "sigkill": (kill_dir, _supervise(
            kill_dir, M2KT_STEPS=8, M2KT_CKPT_DIR=kill_dir / "ckpt",
            M2KT_CKPT_EVERY=2, M2KT_FAULT_STEP=5, M2KT_FAULT_KIND="sigkill",
            M2KT_FAULT_MARKER=kill_dir / "fault-fired", M2KT_RETRY_MAX=2)),
        "exhaust": (exhaust_dir, _supervise(
            exhaust_dir, M2KT_STEPS=4, M2KT_FAULT_STEP=2,
            M2KT_FAULT_KIND="exit", M2KT_FAULT_EXIT_CODE=7,
            M2KT_RETRY_MAX=1)),
    }
    done = {}
    try:
        for name, (d, p) in procs.items():
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            done[name] = (d, p.returncode, out, err)
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    done["planted"] = planted
    return done


def test_sigkill_at_step_5_resumes_from_step_4(supervised):
    d, rc, out, err = supervised["sigkill"]
    assert rc == 0, err
    assert "FAULT: injected sigkill at step 5" in out
    assert "resumed from step 4" in out  # N, not 0
    assert "done steps=8" in out
    summary = json.loads((d / "exit.json").read_text())
    assert summary["exit_class"] == "ok"
    assert [a["class"] for a in summary["attempts"]] == ["retryable", "ok"]
    assert summary["attempts"][0]["returncode"] == -signal.SIGKILL
    assert summary["attempts"][1]["report"]["resumed_from"] == 4
    merged = summary["goodput"]
    assert merged["last_saved_step"] == 8
    assert merged["seconds"]["lost"] > 0
    assert merged["seconds"]["retry"] > 0
    assert 0 < merged["goodput_fraction"] < 1
    final = json.loads((d / "goodput.json").read_text())
    assert final["resumed_from"] == 4 and final["last_saved_step"] == 8
    flight = json.loads((d / "flight.json").read_text())
    assert flight["exit_class"] == "retryable"
    assert flight["returncode"] == -signal.SIGKILL
    assert flight["attempt"] == 1
    assert flight["goodput"]["last_saved_step"] == 4
    # nothing planted and nothing non-finite: no numerics forensics
    assert flight["numerics"] == {} and flight["memory"] == {}
    assert faults.step_dirs(str(d / "ckpt"))[-1][0] == 8
    # nothing of the run lands outside its directory's named files
    assert sorted(p.name for p in d.iterdir()) == [
        "ckpt", "exit.json", "fault-fired", "flight.json", "flight.json.ring",
        "goodput.json"]


def test_resumed_losses_equal_an_uninterrupted_run(supervised):
    """Steps 1-4 (attempt 1) and 5-8 (attempt 2, restored from step 4)
    print the same loss bits as 8 uninterrupted steps of the same model,
    batches and step function."""
    _, rc, out, _ = supervised["sigkill"]
    assert rc == 0
    printed = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[:2] == ["[m2kt]", "step"]:
            printed[int(parts[2])] = parts[4]
    assert sorted(printed) == list(range(1, 9))
    state = minitrain.build_state("cpu")
    train_step = minitrain.make_step()
    for i in range(1, 9):
        state, loss = train_step(state, minitrain.make_batch(i, 4, "cpu"))
        assert float(loss).hex() == printed[i], i


def test_retry_exhaustion_reports_last_rc(supervised):
    d, rc, out, err = supervised["exhaust"]
    assert rc == 7, err
    summary = json.loads((d / "exit.json").read_text())
    assert summary["exit_class"] == "retries_exhausted"
    assert summary["returncode"] == 7
    assert len(summary["attempts"]) == 2  # first try + one retry
    assert [a["returncode"] for a in summary["attempts"]] == [7, 7]
    flight = json.loads((d / "flight.json").read_text())
    assert flight["attempt"] == 2 and flight["exit_class"] == "retryable"
    assert flight["numerics"] == supervised["planted"]


def test_minitrain_refuses_multislice_and_a_missing_card(monkeypatch):
    """The multislice drill runs (``tests/test_torch_dist_train.py``);
    forced ranks are CPU ranks, so ``M2KT_FORCE_DEVICES`` on a card is
    refused, and without a card and ``M2KT_DEVICE=cpu`` minitrain raises
    before it starts a rank, with or without slices."""
    from move2kube_tpu_torch.parallel.mesh import local_device_count

    monkeypatch.setenv("M2KT_FORCE_DEVICES", "8")
    with pytest.raises(ValueError, match="M2KT_DEVICE=cpu"):
        local_device_count("cuda")
    assert local_device_count("cpu") == 8
    monkeypatch.delenv("M2KT_DEVICE", raising=False)
    monkeypatch.setenv("M2KT_NUM_SLICES", "2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            minitrain.main()
    monkeypatch.delenv("M2KT_NUM_SLICES")
    monkeypatch.delenv("M2KT_FORCE_DEVICES")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            minitrain.main()


def test_supervisor_restores_sigterm_handler(tmp_path):
    """``run`` puts the previous SIGTERM handler back, on the ok path and
    when the child raises out of ``_run_once``."""
    sup = supervisor.Supervisor([sys.executable, "-c", "pass"],
                                max_retries=0, backoff_s=0.0,
                                exit_file=str(tmp_path / "exit.json"))
    before = signal.getsignal(signal.SIGTERM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("M2KT_GOODPUT_FILE", str(tmp_path / "gp.json"))
        mp.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "flight.json"))
        mp.delenv("M2KT_METRICS_DIR", raising=False)
        # no goodput span into this process's recorder
        mp.setenv("M2KT_TRACE", "0")
        assert sup.run() == 0
        assert signal.getsignal(signal.SIGTERM) == before
        broken = supervisor.Supervisor(
            [str(tmp_path / "no-such-program")], max_retries=0,
            exit_file=str(tmp_path / "exit2.json"))
        with pytest.raises(OSError):
            broken.run()
        assert signal.getsignal(signal.SIGTERM) == before
    assert json.loads((tmp_path / "exit.json").read_text())[
        "exit_class"] == "ok"
