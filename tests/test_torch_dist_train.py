"""The port's mesh paths around the step: the loader's host and rank split,
the checkpoint in worlds of 2 and 1, preemption in a world of 2, and the
elastic multislice drill of ``resilience/minitrain.py`` under the port's
supervisor, all on the CPU.

- The loader: with 2 local ranks on one host, the ranks' batches in rank
  order concatenate to the JAX ``HostShardedLoader``'s global batch over
  two epochs; with 2 hosts x 2 ranks (the layout the JobSet's env gives)
  they match the JAX loader with ``jax.process_count``/``process_index``
  patched to 2 and the host's index.
- The checkpoint: a tiny Llama ``TrainState`` saved in a world of 2 and
  restored in a world of 1, then the reverse: parameters and Adam moments
  equal by SHA-256, and only rank 0 writes.
- Preemption: SIGTERM to rank 1 of minitrain's 2 ranks stops both at the
  step they agree on, with one checkpoint, and the supervisor reports the
  exit class ``preempted``.
- The drill: ``tests/test_elastic.py``'s two-slice drill at
  ``M2KT_FORCE_DEVICES=4`` and ``M2KT_NUM_SLICES=2`` (4 gloo ranks, then
  2 after the slice loss), every one of its assertions, and its terminal
  case without ``M2KT_ELASTIC``.

Gloo worlds run in spawned processes (each destroys its group), every
subprocess under ``tmp_path`` with an env holding no ``M2KT_*`` key but
the ones it sets and a timeout; the test's process holds no group.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from move2kube_tpu.models import data as jdata  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu_torch.models import data as tdata  # noqa: E402
from move2kube_tpu_torch.parallel.mesh import ProcessLayout  # noqa: E402
from move2kube_tpu_torch.resilience import faults  # noqa: E402
from move2kube_tpu_torch.resilience.faults import (  # noqa: E402
    SLICE_LOST_EXIT_CODE,
)
from tests.test_torch_ring import (  # noqa: E402,F401
    _process_state_unchanged,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def child_env(**knobs) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env["PYTHONPATH"] = REPO
    env.update({k: str(v) for k, v in knobs.items()})
    return env


# ------------------------------------------------------------- the loader


def _npz(tmp_path, n=40, seq=6):
    rng = np.random.default_rng(11)
    path = tmp_path / "tokens.npz"
    np.savez(path, input_ids=rng.integers(0, 1000, (n, seq)).astype(np.int32),
             label=np.arange(n, dtype=np.int64))
    return str(path)


def _layouts(hosts, local):
    return [[ProcessLayout(hosts * local, h * local + r, local, r, hosts, h)
             for r in range(local)] for h in range(hosts)]


@pytest.mark.parametrize("hosts,local", [(1, 2), (2, 2), (1, 4)])
def test_ranks_batches_concatenate_to_the_jax_global_batch(
        tmp_path, monkeypatch, hosts, local):
    """Over two epochs of 40 examples at global batch 8: each host's
    ranks, in rank order, hold the JAX loader's batch of that host (its
    process-local rows), and the hosts' in host order the global one."""
    path = _npz(tmp_path)
    mesh = make_mesh(MeshConfig(data=jax.device_count()))
    steps = 2 * 40 // 8 + 1
    for host, layouts in enumerate(_layouts(hosts, local)):
        monkeypatch.setattr(jax, "process_count", lambda: hosts)
        monkeypatch.setattr(jax, "process_index", lambda h=host: h)
        ref = jdata.HostShardedLoader(jdata.load_arrays(path), 8, mesh,
                                      seed=2, to_device=False)
        ranks = [tdata.HostShardedLoader(tdata.load_arrays(path), 8, seed=2,
                                         layout=lay) for lay in layouts]
        for _ in range(steps):
            want = next(ref)
            got = [next(r) for r in ranks]
            for key in want:
                np.testing.assert_array_equal(
                    np.concatenate([g[key] for g in got]), want[key])
        assert {r.rank_batch for r in ranks} == {8 // (hosts * local)}
        assert {r.local_batch for r in ranks} == {ref.local_batch}


def test_synthetic_batches_are_split_by_rank():
    """The emitted trainers' synthetic source makes the global batch; each
    rank keeps its rows."""
    def fn(i):
        return {"x": np.arange(8) + 100 * i}

    got = [next(tdata._Synthetic(fn, ProcessLayout(4, r, 2, r % 2, 2,
                                                   r // 2)))["x"].tolist()
           for r in range(4)]
    assert got == [[0, 1], [2, 3], [4, 5], [6, 7]]


# --------------------------------------------------------- the checkpoint

CKPT_WORKER = r'''
import hashlib, json, sys
import numpy as np
import torch
import torch.distributed as dist

n, store, ckpt, mode, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4], sys.argv[5])
rank = int(sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    import dataclasses

    from move2kube_tpu_torch.models import checkpoint, llama
    from move2kube_tpu_torch.models import train as T
    from move2kube_tpu_torch.models.convert import init_llama
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    cfg = dataclasses.replace(llama.llama_tiny(), dtype=torch.float32)
    model = init_llama(cfg, seed=3 if mode == "save" else 9, device="cpu",
                       dtype=torch.float32)
    state = T.TrainState(model, T.adam(model.parameters(), 1e-3))
    mngr = checkpoint.CheckpointManager(ckpt, every=2)
    if mode == "save":
        mesh = make_mesh(MeshConfig(data=n), device="cpu") if n > 1 else None
        step = T.make_lm_train_step(remat=False, chunk=128, mesh=mesh)
        rng = np.random.default_rng(0)
        for i in range(1, 3):
            ids = torch.from_numpy(rng.integers(0, 512, (4, 16)))
            per = 4 // n
            state, _ = step(state, {"input_ids": ids[rank * per:
                                                     (rank + 1) * per]})
            mngr.maybe_save(i, state)
        mngr.close()
    else:
        state, start = mngr.restore_or_init(state)
        assert start == 2, start
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
        for v in state.optimizer.inner.state[p].values():
            h.update(v.numpy().tobytes())
    with open(f"{out}-{rank}.json", "w") as f:
        json.dump({"sha": h.hexdigest(), "step": state.step}, f)
finally:
    dist.destroy_process_group()
'''


def _ckpt_world(tmp_path, tag, n, ckpt, mode):
    script = tmp_path / "ckpt_worker.py"
    script.write_text(CKPT_WORKER)
    out = tmp_path / tag
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(n), str(tmp_path / f"{tag}.store"),
         str(ckpt), mode, str(out), str(r)], cwd=tmp_path, env=child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        done = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, done):
        assert p.returncode == 0, err[-3000:]
    return [json.loads((tmp_path / f"{tag}-{r}.json").read_text())
            for r in range(n)]


@pytest.mark.parametrize("save_n,restore_n", [(2, 1), (1, 2)])
def test_checkpoint_restores_into_a_world_of_another_size(tmp_path, save_n,
                                                          restore_n):
    ckpt = tmp_path / "ckpt"
    saved = _ckpt_world(tmp_path, "save", save_n, ckpt, "save")
    assert len({d["sha"] for d in saved}) == 1
    # only rank 0 wrote: one directory a committed step, nothing else
    assert sorted(os.listdir(ckpt)) == ["2"]
    assert sorted(os.listdir(ckpt / "2")) == ["meta.json", "state.pt"]
    restored = _ckpt_world(tmp_path, "restore", restore_n, ckpt, "restore")
    assert {d["sha"] for d in restored} == {saved[0]["sha"]}
    assert {d["step"] for d in restored} == {2}


# ------------------------------------------------------------- preemption


def _children_of(pid: int) -> list[int]:
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(name))
    return out


def _rank_pid(root: int, rank: int) -> int | None:
    """The pid of local rank ``rank`` among ``root``'s descendants."""
    stack = [root]
    while stack:
        pid = stack.pop()
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            env = []
        if f"M2KT_LOCAL_RANK={rank}".encode() in env:
            return pid
        stack.extend(_children_of(pid))
    return None


def _supervised(tmp_path, **knobs):
    env = child_env(M2KT_DEVICE="cpu", M2KT_RETRY_BACKOFF_S="0.1",
                    M2KT_EXIT_FILE=tmp_path / "exit.json",
                    M2KT_GOODPUT_FILE=tmp_path / "goodput.json",
                    M2KT_FLIGHT_PATH=tmp_path / "flight.json",
                    M2KT_PREEMPT_FILE=tmp_path / "preempt", **knobs)
    return subprocess.Popen(
        [sys.executable, "-m", "move2kube_tpu_torch.resilience.supervisor",
         "--", sys.executable, "-m", "move2kube_tpu_torch.resilience.minitrain"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_sigterm_to_rank_1_stops_both_at_the_agreed_step(tmp_path):
    proc = _supervised(tmp_path, M2KT_FORCE_DEVICES=2, M2KT_STEPS=60,
                       M2KT_STEP_SLEEP_S="0.1", M2KT_PREEMPT_SYNC_EVERY=4,
                       M2KT_CKPT_DIR=tmp_path / "ckpt", M2KT_CKPT_EVERY=1000)
    try:
        deadline = time.monotonic() + TIMEOUT_S
        lines = []
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("[m2kt] step 3 "):
                pid = _rank_pid(proc.pid, 1)
                assert pid is not None
                os.kill(pid, signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + out
    assert proc.returncode == 143, err[-3000:]
    stop = int(re.search(r"last-chance checkpoint at step (\d+)",
                         out).group(1))
    assert stop % 4 == 0 and 4 <= stop < 60
    # both ranks stopped there: rank 0's last step line is the stop step
    assert re.findall(r"\[m2kt\] step (\d+) ", out)[-1] == str(stop)
    assert [s for s, _ in faults.step_dirs(str(tmp_path / "ckpt"))] == [stop]
    summary = json.loads((tmp_path / "exit.json").read_text())
    assert summary["exit_class"] == "preempted"
    assert len(summary["attempts"]) == 1


# -------------------------------------------------------------- the drill


def _run_supervised(workdir, extra: dict) -> subprocess.Popen:
    env = child_env(M2KT_DEVICE="cpu", **extra)
    return subprocess.Popen(
        [sys.executable, "-m", "move2kube_tpu_torch.resilience.supervisor",
         "--", sys.executable, "-m", "move2kube_tpu_torch.resilience.minitrain"],
        env=env, cwd=str(workdir), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def test_elastic_drill_two_slices_lose_one(tmp_path):
    """2 slices x 2 ranks x batch 2 (global 8); slice_loss at step 5. The
    supervisor re-plans to 1 slice x 2 ranks x batch 4 (global 8
    preserved), resumes from the step-4 checkpoint, and the final loss is
    the never-faulted 2-rank control run's. The control runs alongside."""
    common = dict(M2KT_STEPS="8", M2KT_CKPT_EVERY="2",
                  M2KT_RETRY_BACKOFF_S="0.1")
    control = tmp_path / "control"
    control.mkdir()
    drill = _run_supervised(tmp_path, dict(
        common,
        M2KT_CKPT_DIR=str(tmp_path / "ckpt"),
        M2KT_FORCE_DEVICES="4",
        M2KT_NUM_SLICES="2",
        M2KT_BATCH_PER_DEVICE="2",
        M2KT_ELASTIC="1",
        M2KT_FAULT_STEP="5",
        M2KT_FAULT_KIND="slice_loss",
        M2KT_FAULT_MARKER=str(tmp_path / "fault-fired"),
        M2KT_PREEMPT_FILE=str(tmp_path / "preempt"),
        M2KT_EXIT_FILE=str(tmp_path / "exit.json"),
        M2KT_GOODPUT_FILE=str(tmp_path / "goodput.json"),
    ))
    ctrl = _run_supervised(control, dict(
        common,
        M2KT_CKPT_DIR=str(control / "ckpt"),
        M2KT_FORCE_DEVICES="2",
        M2KT_BATCH_PER_DEVICE="4",
        M2KT_PREEMPT_FILE=str(control / "preempt"),
        M2KT_EXIT_FILE=str(control / "exit.json"),
        M2KT_GOODPUT_FILE=str(control / "goodput.json"),
    ))
    res, res_c = _finish(drill), _finish(ctrl)
    assert res.returncode == 0, res.stderr[-3000:]
    # attempt 1: the full 2-slice world
    assert "dcn_dp=2" in res.stdout
    assert "devices=4 global_batch=8" in res.stdout
    assert "FAULT: slice_loss" in res.stderr
    assert "elastic re-plan 2->1" in res.stdout
    # attempt 2: half the ranks, same global batch, resumed not restarted
    assert "devices=2 global_batch=8" in res.stdout
    assert "resumed from step 4" in res.stdout
    assert "done steps=8" in res.stdout

    summary = json.loads((tmp_path / "exit.json").read_text())
    assert summary["exit_class"] == "ok"
    assert [a["class"] for a in summary["attempts"]] == ["slice_lost", "ok"]
    assert summary["attempts"][0]["returncode"] == SLICE_LOST_EXIT_CODE
    assert summary["attempts"][1]["report"]["resumed_from"] == 4
    [event] = summary["replan_events"]
    assert event == {"attempt": 1, "from_slices": 2, "to_slices": 1,
                     "batch_per_device": 4, "global_batch_preserved": True}
    merged = summary["goodput"]
    assert merged["last_saved_step"] == 8
    # the re-plan pause is its own ledger category, not a retry
    assert merged["seconds"]["replan"] > 0
    assert merged["seconds"]["retry"] == 0

    # loss continuity: the never-faulted control run on the survivor world
    assert res_c.returncode == 0, res_c.stderr[-3000:]
    assert "devices=2 global_batch=8" in res_c.stdout

    def final_loss(out: str) -> float:
        return float(re.findall(r"loss=([0-9.]+)", out)[-1])

    assert final_loss(res.stdout) == pytest.approx(
        final_loss(res_c.stdout), abs=1e-5)


def test_slice_loss_without_elastic_is_terminal(tmp_path):
    """Elastic off: the supervisor surfaces exit code 83 / class
    slice_lost without retrying."""
    res = _finish(_run_supervised(tmp_path, dict(
        M2KT_STEPS="4",
        M2KT_FORCE_DEVICES="2",
        M2KT_NUM_SLICES="2",
        M2KT_BATCH_PER_DEVICE="2",
        M2KT_FAULT_STEP="2",
        M2KT_FAULT_KIND="slice_loss",
        M2KT_RETRY_BACKOFF_S="0.05",
        M2KT_PREEMPT_FILE=str(tmp_path / "preempt"),
        M2KT_EXIT_FILE=str(tmp_path / "exit.json"),
        M2KT_GOODPUT_FILE=str(tmp_path / "goodput.json"),
    )))
    assert res.returncode == SLICE_LOST_EXIT_CODE
    assert "FAULT: slice_loss" in res.stderr
    summary = json.loads((tmp_path / "exit.json").read_text())
    assert summary["exit_class"] == "slice_lost"
    assert len(summary["attempts"]) == 1
    assert summary["replan_events"] == []

