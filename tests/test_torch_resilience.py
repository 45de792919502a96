"""The port's resilience package (``move2kube_tpu_torch/resilience``)
against the JAX package's (``move2kube_tpu/resilience``): the exit
classification over the reference's whole table, the goodput ledger and
its merge under one fixed clock, the preemption watcher (SIGTERM,
sentinel, env, grace period), the stop-step agreement in a two-process
gloo world, and the fault kinds that end a process (each in a child).
The supervisor over the port's minitrain is in
``tests/test_torch_supervisor.py``.

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
import socket
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.resilience import goodput as jgoodput  # noqa: E402
from move2kube_tpu.resilience import preemption as jpreempt  # noqa: E402
from move2kube_tpu.resilience import supervisor as jsup  # noqa: E402
from move2kube_tpu_torch.ops import _build  # noqa: E402
from move2kube_tpu_torch.resilience import faults  # noqa: E402
from move2kube_tpu_torch.resilience import goodput  # noqa: E402
from move2kube_tpu_torch.resilience import preemption  # noqa: E402
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


# -- exit classification -----------------------------------------------------


def _classification_cases():
    """Every row of the reference's table: the return codes, and each
    pattern of each table alone, with the codes that outrank it."""
    cases = [(0, ""), (-signal.SIGTERM, ""), (143, ""), (83, ""),
             (-signal.SIGKILL, ""), (137, ""), (1, ""), (2, "nothing known"),
             (1, "something unprecedented"), (0, "ImportError"),
             (143, "ImportError"), (137, "ImportError"),
             (137, "slice lost"), (83, "ImportError")]
    for pat in (jsup.SLICE_LOST_PATTERNS + jsup.FATAL_PATTERNS
                + jsup.RETRYABLE_PATTERNS):
        cases.append((1, f"Traceback ...\n{pat}: detail\n"))
    cases.append((1, "ImportError ... DEADLINE_EXCEEDED"))
    cases.append((1, "slice lost ... ImportError"))
    return cases


def test_pattern_tables_are_the_references():
    assert supervisor.SLICE_LOST_PATTERNS == jsup.SLICE_LOST_PATTERNS
    assert supervisor.FATAL_PATTERNS == jsup.FATAL_PATTERNS
    assert supervisor.RETRYABLE_PATTERNS == jsup.RETRYABLE_PATTERNS
    assert (supervisor.OK, supervisor.PREEMPTED, supervisor.SLICE_LOST,
            supervisor.RETRYABLE, supervisor.FATAL) == (
        jsup.OK, jsup.PREEMPTED, jsup.SLICE_LOST, jsup.RETRYABLE, jsup.FATAL)
    assert faults.SLICE_LOST_EXIT_CODE == 83


@pytest.mark.parametrize("rc,tail", _classification_cases())
def test_classification_matches_reference(rc, tail):
    assert supervisor.classify(rc, tail) == jsup.classify(rc, tail)


@pytest.mark.parametrize("rc,tail,expected", [
    (0, "", "ok"), (-signal.SIGTERM, "", "preempted"), (143, "", "preempted"),
    (-signal.SIGKILL, "", "retryable"), (137, "", "retryable"),
    (83, "", "slice_lost"), (1, "ImportError: No module named x", "fatal"),
    (1, "ValueError: global batch 7 not divisible by 8", "fatal"),
    (1, "DEADLINE_EXCEEDED: barrier timed out", "retryable"),
    (1, "FaultInjected: injected transient fault", "retryable"),
    (1, "something unprecedented", "retryable"),
])
def test_classification_table(rc, tail, expected):
    assert supervisor.classify(rc, tail) == expected


def test_exit_file_path_env(monkeypatch, tmp_path):
    monkeypatch.setenv("M2KT_EXIT_FILE", str(tmp_path / "e.json"))
    assert supervisor.exit_file_path() == jsup.exit_file_path()
    monkeypatch.delenv("M2KT_EXIT_FILE")
    monkeypatch.setenv("M2KT_METRICS_DIR", str(tmp_path))
    assert supervisor.exit_file_path() == str(tmp_path / "m2kt-exit.json")
    assert supervisor.exit_file_path() == jsup.exit_file_path()


def test_elastic_replan_env_arithmetic(monkeypatch):
    """The re-plan's env arithmetic is the reference's (slice count,
    forced devices, per-device batch, the floor)."""
    for num, force, bpd, floor in [("4", "16", "6", "1"), ("3", "12", "4", "1"),
                                   ("2", "", "", "1"), ("2", "8", "3", "2")]:
        monkeypatch.setenv("M2KT_NUM_SLICES", num)
        monkeypatch.setenv("M2KT_FORCE_DEVICES", force)
        monkeypatch.setenv("M2KT_BATCH_PER_DEVICE", bpd)
        monkeypatch.setenv("M2KT_ELASTIC_MIN_SLICES", floor)
        ours = supervisor.Supervisor(["true"], exit_file="unused")
        theirs = jsup.Supervisor(["true"], exit_file="unused")
        for _ in range(2):
            assert ours._plan_elastic_restart(1) == \
                theirs._plan_elastic_restart(1)
            assert ours._env_overrides == theirs._env_overrides
        assert ours._replan_events == theirs._replan_events


# -- goodput -----------------------------------------------------------------


def test_goodput_docs_equal_reference_under_fixed_clock(monkeypatch, tmp_path):
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    docs = []
    for mod in (goodput, jgoodput):
        gp = mod.GoodputTracker()
        gp.note_resume(4)
        gp.add("compile", 1.0, steps=1)
        gp.add("productive", 3.0, steps=6)
        gp.add("save", 0.25)
        gp.note_saved(10)
        gp.note_saved(8)
        now[0] += 5.5
        docs.append(gp.report())
        path = gp.write(str(tmp_path / f"{mod.__name__}.json"))
        assert mod.read_report(path) == docs[-1]
        now[0] -= 5.5
    assert docs[0] == docs[1]
    assert docs[0]["steps_done"] == 11 and docs[0]["last_saved_step"] == 10
    assert goodput.read_report(str(tmp_path / "absent.json")) is None


def test_goodput_merge_equals_reference():
    flushed = {"seconds": {"productive": 2.0, "compile": 1.0},
               "steps_done": 4, "last_saved_step": 4}
    attempts = [
        {"report": flushed, "wall_seconds": 5.0, "ok": False},
        {"report": {"seconds": {"productive": 3.0}, "steps_done": 8,
                    "last_saved_step": 8}, "wall_seconds": 4.0, "ok": True},
        {"report": None, "wall_seconds": 1.0, "ok": False},
    ]
    merged = goodput.merge_attempts(attempts)
    assert merged == jgoodput.merge_attempts(attempts)
    assert merged["seconds"]["lost"] == pytest.approx(3.0)
    assert merged["goodput_fraction"] == pytest.approx(0.5)


def test_goodput_report_path_env(monkeypatch, tmp_path):
    monkeypatch.setenv("M2KT_GOODPUT_FILE", "/x/y.json")
    assert goodput.report_path() == jgoodput.report_path() == "/x/y.json"
    monkeypatch.delenv("M2KT_GOODPUT_FILE")
    monkeypatch.setenv("M2KT_METRICS_DIR", str(tmp_path))
    assert goodput.report_path() == str(tmp_path / "m2kt-goodput.json")


def test_goodput_mirrors():
    from move2kube_tpu_torch.obs.metrics import Registry
    from move2kube_tpu_torch.obs.tracing import SpanRecorder

    rep = {"seconds": {"productive": 2.5, "lost": 0.125},
           "goodput_fraction": 0.75, "steps_done": 8, "last_saved_step": 6}
    reg = Registry()
    goodput.mirror_to_obs(rep, reg)
    text = reg.render()
    assert "m2kt_goodput_fraction 0.75" in text
    assert 'm2kt_goodput_seconds{category="productive"} 2.5' in text
    rec = SpanRecorder()
    goodput.mirror_to_trace(rep, recorder=rec)
    (span,) = rec.snapshot()
    assert span["name"] == "goodput"
    assert span["attrs"] == {"goodput.productive_ms": 2500,
                             "goodput.lost_ms": 125,
                             "goodput.steps_done": 8,
                             "goodput.fraction_bp": 7500}


# -- fault injection -----------------------------------------------------------


def test_fault_marker_fires_exactly_once(tmp_path, monkeypatch):
    marker = tmp_path / "marker"
    monkeypatch.setenv("M2KT_FAULT_STEP", "3")
    monkeypatch.setenv("M2KT_FAULT_KIND", "raise")
    monkeypatch.setenv("M2KT_FAULT_MARKER", str(marker))
    faults.maybe_inject(2)  # off-step: no-op
    with pytest.raises(faults.FaultInjected):
        faults.maybe_inject(3)
    assert marker.exists()
    faults.maybe_inject(3)  # second hit: marker claims it, no fault


def test_fault_unconfigured_is_inert(monkeypatch):
    monkeypatch.delenv("M2KT_FAULT_STEP", raising=False)
    faults.maybe_inject(1)
    monkeypatch.setenv("M2KT_FAULT_STEP", "banana")
    faults.maybe_inject(1)


@pytest.mark.parametrize("kind,rc", [("exit", 5), ("slice_loss", 83),
                                     ("sigkill", -signal.SIGKILL)])
def test_fault_kinds_end_the_child(tmp_path, kind, rc):
    """The process-ending kinds, each in a child of its own (which loads
    the stdlib-only module from its file, without the package)."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('f', sys.argv[1])\n"
            "faults = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(faults)\n"
            "faults.maybe_inject(1)\nfaults.maybe_inject(2)\n"
            "print('survived')\n")
    res = subprocess.run(
        [sys.executable, "-c", code, faults.__file__], cwd=tmp_path, capture_output=True,
        text=True, timeout=CHILD_TIMEOUT_S,
        env=child_env(M2KT_FAULT_STEP=2, M2KT_FAULT_KIND=kind,
                      M2KT_FAULT_EXIT_CODE=5))
    assert res.returncode == rc, res.stderr
    assert "survived" not in res.stdout
    assert f"FAULT: injected {kind} at step 2" in res.stdout
    if kind == "slice_loss":
        assert supervisor.classify(res.returncode, res.stderr) == "slice_lost"


# -- preemption watcher --------------------------------------------------------


def test_watcher_sigterm_triggers_stop(tmp_path):
    w = preemption.PreemptionWatcher(
        grace_seconds=30.0, sentinel=str(tmp_path / "nope"))
    w.install()
    try:
        assert not w.requested()
        assert not w.should_stop(1)
        os.kill(os.getpid(), signal.SIGTERM)
        assert w.requested()
        assert w.should_stop(2)  # world of one: no cadence wait
        left = w.time_left()
        assert left is not None and 0 < left <= 30.0
    finally:
        w.uninstall()


def test_watcher_sentinel_file(tmp_path):
    sentinel = tmp_path / "m2kt-preempt"
    w = preemption.PreemptionWatcher(sentinel=str(sentinel))
    assert not w.requested()
    sentinel.touch()  # what the emitted preStop hook does
    assert w.requested()
    assert w.should_stop(7)


def test_watcher_from_env_matches_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("M2KT_PREEMPT", "0")
    assert preemption.from_env() is None and jpreempt.from_env() is None
    monkeypatch.setenv("M2KT_PREEMPT", "1")
    monkeypatch.setenv("M2KT_PREEMPT_GRACE_S", "77")
    monkeypatch.setenv("M2KT_PREEMPT_FILE", str(tmp_path / "s"))
    monkeypatch.setenv("M2KT_PREEMPT_SYNC_EVERY", "5")
    ours, theirs = preemption.from_env(), jpreempt.from_env()
    assert (ours.grace_seconds, ours.sentinel, ours.sync_every) == (
        theirs.grace_seconds, theirs.sentinel, theirs.sync_every) == (
        77.0, str(tmp_path / "s"), 5)
    monkeypatch.setenv("M2KT_PREEMPT_GRACE_S", "soon")
    monkeypatch.setenv("M2KT_PREEMPT_SYNC_EVERY", "often")
    ours, theirs = preemption.from_env(), jpreempt.from_env()
    assert (ours.grace_seconds, ours.sync_every) == (
        theirs.grace_seconds, theirs.sync_every)


@pytest.mark.parametrize("grace,budget", [("", ""), ("", "100"), ("42", "100"),
                                          ("bad", "x"), ("0", "")])
def test_grace_period_matches_reference(monkeypatch, grace, budget):
    for key, val in (("M2KT_GRACE_PERIOD_S", grace),
                     ("M2KT_CKPT_BUDGET_S", budget)):
        if val:
            monkeypatch.setenv(key, val)
        else:
            monkeypatch.delenv(key, raising=False)
    assert preemption.grace_period_seconds() == \
        jpreempt.grace_period_seconds()


_AGREEMENT = """
import json, os, sys
import torch.distributed as dist
from move2kube_tpu_torch.resilience.preemption import PreemptionWatcher

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
try:
    sentinel = os.path.join(out, f"sentinel-{rank}")
    w = PreemptionWatcher(sentinel=sentinel, sync_every=2)
    seen = []
    for step in range(1, 7):
        if rank == 1 and step == 3:
            open(sentinel, "w").close()   # rank 1 alone is told to stop
        seen.append([w.requested(), w.should_stop(step)])
    with open(os.path.join(out, f"rank-{rank}.json"), "w") as f:
        json.dump(seen, f)
finally:
    dist.destroy_process_group()
"""


def test_stop_step_agreement_in_a_gloo_world(tmp_path):
    """Rank 1 alone sees the sentinel at step 3; both ranks agree to stop
    at step 4, the next step on the ``sync_every=2`` cadence (and again at
    6), and rank 0 adopts the notice."""
    script = tmp_path / "agree.py"
    script.write_text(_AGREEMENT)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = child_env()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(port), str(tmp_path)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    seen = [json.loads((tmp_path / f"rank-{r}.json").read_text())
            for r in (0, 1)]
    stops = [[stop for _, stop in s] for s in seen]
    # off the cadence a world above one answers False whatever it was told
    assert stops == [[False, False, False, True, False, True]] * 2
    # rank 0 learns of the notice inside step 4's agreement
    assert [req for req, _ in seen[0]] == [False] * 4 + [True] * 2
    assert [req for req, _ in seen[1]] == [False, False] + [True] * 4
