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
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

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
    # the ranks share the box's cores: one thread each (tiny widths)
    env["OMP_NUM_THREADS"] = "1"
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
rank, kind = int(sys.argv[6]), sys.argv[7]
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    import dataclasses

    from move2kube_tpu_torch.models import checkpoint, llama
    from move2kube_tpu_torch.models import train as T
    from move2kube_tpu_torch.models.convert import init_llama
    from move2kube_tpu_torch.parallel import overlap
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    cfg = dataclasses.replace(llama.llama_tiny(), dtype=torch.float32)
    seed = 3 if mode.startswith("save") else 9
    mesh = None
    if n > 1:
        mesh = make_mesh(MeshConfig(**{kind: n}), device="cpu")
    if kind == "fsdp" and mesh is not None:
        state = T.create_sharded_state(
            cfg, mesh, lambda ps: T.adam(ps, 1e-3), seed=seed, device="cpu")
        layout = state.model.fsdp_layout
        ring = overlap.mesh_ring_group(mesh, ("fsdp",))
    else:
        model = init_llama(cfg, seed=seed, device="cpu", dtype=torch.float32)
        state = T.TrainState(model, T.adam(model.parameters(), 1e-3))
        layout = None
    model = state.model

    def whole(name, t):
        dim = layout.dims[name] if layout is not None else None
        if dim is None or t.ndim == 0:
            return t
        return overlap.ring_all_gather(t.contiguous(), ring, dim)

    def digest():
        """SHA-256 of the parameters and Adam moments at their global
        shapes (each sharded leaf gathered), in the model's order."""
        h = hashlib.sha256()
        for name, p in model.named_parameters():
            h.update(whole(name, p.detach()).numpy().tobytes())
            for v in state.optimizer.inner.state[p].values():
                h.update(whole(name, v).numpy().tobytes())
        return h.hexdigest()

    mngr = checkpoint.CheckpointManager(ckpt, every=2)
    doc = {}
    if mode == "exit":
        # the emitted trainer's loop: the default (background) save, the
        # goodput ledger flushed when a save starts, and the exit flush
        from move2kube_tpu_torch.resilience.goodput import GoodputTracker

        gp = GoodputTracker()
        mngr.install_exit_flush()
    if mode.startswith("save") or mode == "exit":
        step = T.make_lm_train_step(remat=False, chunk=128, mesh=mesh)
        rng = np.random.default_rng(0)
        for i in range(1, 5 if mode == "save4" else 3):
            ids = torch.from_numpy(rng.integers(0, 512, (4, 16)))
            per = 4 // n
            state, _ = step(state, {"input_ids": ids[rank * per:
                                                     (rank + 1) * per]})
            if mngr.maybe_save(i, state) and mode == "exit":
                gp.note_saved(i)
                if rank == 0:
                    gp.write(f"{out}-goodput.json")
            if i == 2:
                doc["sha2"] = digest()
        if mode == "exit":
            # one step after the save, then a slice-loss death: no close,
            # no barrier; teardown runs the exit flush
            ids = torch.from_numpy(rng.integers(0, 512, (4, 16)))
            state, _ = step(state, {"input_ids": ids[rank * 2:
                                                     (rank + 1) * 2]})
            with open(f"{out}-{rank}.json", "w") as f:
                json.dump(doc, f)
            sys.exit(83)
        mngr.close()
    else:
        state, start = mngr.restore_or_init(state)
        doc["start"] = start
        # the serving read of the same step, into this rank's shards
        sd = model.state_dict()
        got = checkpoint.restore_variables(ckpt, sd, layout)
        doc["variables_equal"] = sorted(got) == sorted(sd) and all(
            torch.equal(got[k], v) for k, v in sd.items())
    doc.update(sha=digest(), step=state.step)
    with open(f"{out}-{rank}.json", "w") as f:
        json.dump(doc, f)
finally:
    dist.destroy_process_group()
'''


def _start_ckpt_world(tmp_path, tag, n, ckpt, mode, kind="data"):
    """CKPT_WORKER in a gloo world of ``n`` on a ``kind`` (data or fsdp)
    mesh, started: "save" trains 2 steps and saves step 2, "save4" 4 steps
    and saves 2 and 4, "restore" restores the newest readable step.
    :func:`_collect` waits for it."""
    script = tmp_path / "ckpt_worker.py"
    script.write_text(CKPT_WORKER)
    out = tmp_path / tag
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(n), str(tmp_path / f"{tag}.store"),
         str(ckpt), mode, str(out), str(r), kind], cwd=tmp_path,
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
        for r in range(n)]
    return tmp_path, tag, procs


def _collect(world, returncode: int = 0) -> list:
    tmp_path, tag, procs = world
    try:
        done = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, done):
        assert p.returncode == returncode, err[-3000:]
    return [json.loads((tmp_path / f"{tag}-{r}.json").read_text())
            for r in range(len(procs))]


def _ckpt_world(tmp_path, tag, n, ckpt, mode, kind="data"):
    return _collect(_start_ckpt_world(tmp_path, tag, n, ckpt, mode, kind))


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


# the restore worlds of the sharded checkpoints: (world, mesh, checkpoint)
RESTORES = {"one": (1, "data", "fsdp2"), "fsdp2": (2, "fsdp", "fsdp2"),
            "fsdp4": (4, "fsdp", "fsdp2"), "data2": (2, "data", "fsdp2"),
            "data-into-fsdp2": (2, "fsdp", "data2"),
            "damaged": (2, "fsdp", "damaged"), "exit": (2, "fsdp", "exit")}


def _start_fsdp_minitrain(tmp):
    """Minitrain at ``M2KT_MESH_FSDP=2`` under the supervisor, twice at
    once: SIGKILLed at step 5 ("killed"), and uninterrupted ("whole")."""
    runs = {}
    for tag, fault in (("killed", True), ("whole", False)):
        work = tmp / tag
        work.mkdir()
        knobs = dict(M2KT_FORCE_DEVICES=2, M2KT_MESH_FSDP=2, M2KT_STEPS=8,
                     M2KT_CKPT_DIR=work / "ckpt", M2KT_CKPT_EVERY=2)
        if fault:
            knobs.update(M2KT_FAULT_STEP=5, M2KT_FAULT_KIND="sigkill",
                         M2KT_FAULT_MARKER=work / "fired")
        runs[tag] = (work, _supervised(work, **knobs))
    return runs


@pytest.fixture(scope="module")
def sharded_ckpts(tmp_path_factory):
    """A tiny Llama trained 4 steps at fsdp=2 and saved sharded at steps 2
    and 4, one trained 2 steps at data=2 and saved whole at step 2, and
    one at fsdp=2 saved in the background at step 2 and dead of a slice
    loss (exit 83) one step later (the three worlds at once); then a copy
    of the first whose step 4 lacks rank 1's shard; then every restore
    world of RESTORES at once. The fsdp minitrain runs
    (:func:`_start_fsdp_minitrain`) run meanwhile."""
    import shutil

    tmp = tmp_path_factory.mktemp("sharded")
    minitrain = _start_fsdp_minitrain(tmp)
    ckpts = {"fsdp2": tmp / "fsdp2", "data2": tmp / "data2",
             "damaged": tmp / "damaged", "exit": tmp / "exit"}
    saves = [_start_ckpt_world(tmp, "save-fsdp2", 2, ckpts["fsdp2"],
                               "save4", "fsdp"),
             _start_ckpt_world(tmp, "save-data2", 2, ckpts["data2"], "save",
                               "data"),
             _start_ckpt_world(tmp, "save-exit", 2, ckpts["exit"], "exit",
                               "fsdp")]
    saved = dict(zip(("fsdp2", "data2"), [_collect(w) for w in saves[:2]]))
    saved["exit"] = _collect(saves[2], returncode=SLICE_LOST_EXIT_CODE)
    saved["exit-goodput"] = json.loads(
        (tmp / "save-exit-goodput.json").read_text())
    shutil.copytree(ckpts["fsdp2"], ckpts["damaged"])
    (ckpts["damaged"] / "4" / "shard-1.pt").unlink()
    worlds = {name: _start_ckpt_world(tmp, f"restore-{name}", n,
                                      ckpts[ckpt], "restore", kind)
              for name, (n, kind, ckpt) in RESTORES.items()}
    restored = {name: _collect(w) for name, w in worlds.items()}
    finished = {tag: (work, _finish(proc))
                for tag, (work, proc) in minitrain.items()}
    return ckpts, saved, restored, finished


def test_sharded_checkpoint_layout(sharded_ckpts):
    """Each fsdp rank's shards in a file of its own, rank 0's replicated
    leaves and metadata beside them, nothing else; the leaves' global
    shapes, sharded dimensions and extent in ``meta.json``."""
    ckpts, saved, _, _ = sharded_ckpts
    ckpt = ckpts["fsdp2"]
    assert len({d["sha"] for d in saved["fsdp2"]}) == 1
    assert len({d["sha2"] for d in saved["fsdp2"]}) == 1
    assert sorted(os.listdir(ckpt)) == ["2", "4"]
    assert sorted(os.listdir(ckpt / "4")) == [
        "meta.json", "shard-0.pt", "shard-1.pt", "state.pt"]
    meta = json.loads((ckpt / "4" / "meta.json").read_text())
    assert meta["step"] == 4 and meta["sharded"]["extent"] == 2
    leaves = meta["sharded"]["leaves"]
    assert leaves["layers.0.qkv.weight"] == {"shape": [256, 128], "dim": 1,
                                             "extent": 2}
    assert leaves["embed.weight"] == {"shape": [512, 128], "dim": None,
                                      "extent": 1}
    shard = torch.load(ckpt / "4" / "shard-1.pt", weights_only=True)
    assert tuple(shard["model"]["layers.0.qkv.weight"].shape) == (256, 64)
    assert tuple(shard["optimizer"]["layers.0.qkv.weight"]["exp_avg"]
                 .shape) == (256, 64)
    state = torch.load(ckpt / "4" / "state.pt", weights_only=True)
    assert "layers.0.qkv.weight" not in state["model"]
    assert "embed.weight" in state["model"]


@pytest.mark.parametrize("name", ["one", "fsdp2", "fsdp4", "data2"])
def test_sharded_checkpoint_restores_into_other_worlds(sharded_ckpts, name):
    """A checkpoint saved at fsdp=2 restores at 1, at fsdp 2 and 4 and at
    data=2: parameters and Adam moments, gathered, equal by SHA-256; and
    ``restore_variables`` reads it into each world's parameters (whole,
    or each rank's shards) with the restored state's bits."""
    _, saved, restored, _ = sharded_ckpts
    assert {d["sha"] for d in restored[name]} == {saved["fsdp2"][0]["sha"]}
    assert {(d["start"], d["step"]) for d in restored[name]} == {(4, 4)}
    # restore_variables reads the sharded step whole, or into the shards
    assert all(d["variables_equal"] for d in restored[name])


def test_data_checkpoint_restores_into_fsdp(sharded_ckpts):
    """Saved whole by a data=2 world, restored into fsdp=2 shards."""
    _, saved, restored, _ = sharded_ckpts
    assert len({d["sha"] for d in saved["data2"]}) == 1
    assert {d["sha"] for d in restored["data-into-fsdp2"]} == {
        saved["data2"][0]["sha"]}
    assert {d["start"] for d in restored["data-into-fsdp2"]} == {2}


def test_a_step_missing_a_shard_falls_back(sharded_ckpts):
    """Step 4 without rank 1's shard is damaged: every rank restores step
    2, the state the run had there."""
    _, saved, restored, _ = sharded_ckpts
    assert {(d["start"], d["sha"]) for d in restored["damaged"]} == {
        (2, saved["fsdp2"][0]["sha2"])}
    assert all(d["variables_equal"] for d in restored["damaged"])


def test_sharded_save_commits_before_a_slice_loss_exit(sharded_ckpts):
    """An fsdp=2 run saves step 2 in the background and dies of a slice
    loss one step later: the exit flush commits step 2 (every part had
    landed or lands in the flush), the goodput ledger's last saved step,
    and a new world resumes from it with the state the run had there."""
    ckpts, saved, restored, _ = sharded_ckpts
    assert sorted(os.listdir(ckpts["exit"])) == ["2"]
    assert saved["exit-goodput"]["last_saved_step"] == 2
    assert len({d["sha2"] for d in saved["exit"]}) == 1
    assert {(d["start"], d["sha"]) for d in restored["exit"]} == {
        (2, saved["exit"][0]["sha2"])}


def _step_files(step_dir) -> dict:
    """Every tensor of a committed step's files, by file and path."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        elif torch.is_tensor(node):
            out[prefix] = node

    for name in sorted(os.listdir(step_dir)):
        if name.endswith(".pt"):
            walk(name, torch.load(step_dir / name, weights_only=True))
    return out


def test_fsdp_run_killed_after_a_save_resumes_bit_for_bit(sharded_ckpts):
    """Minitrain at ``M2KT_MESH_FSDP=2`` under the supervisor, SIGKILLed
    at step 5 and resumed from step 4's sharded checkpoint, ends with the
    uninterrupted run's losses and final checkpoint, bit for bit."""
    out = {}
    for tag, (work, res) in sharded_ckpts[3].items():
        assert res.returncode == 0, res.stderr[-3000:]
        out[tag] = res.stdout
    killed, whole = sharded_ckpts[3]["killed"][0], \
        sharded_ckpts[3]["whole"][0]
    assert "mesh=1x2x1x1x1x1" in out["whole"]
    assert "resumed from step 4" in out["killed"]
    summary = json.loads((killed / "exit.json").read_text())
    assert [a["class"] for a in summary["attempts"]] == ["retryable", "ok"]

    def losses(text):
        return dict(re.findall(r"\[m2kt\] step (\d+) loss (\S+)", text))

    for i in ("5", "6", "7", "8"):
        assert losses(out["killed"])[i] == losses(out["whole"])[i], i
    mine = _step_files(killed / "ckpt" / "8")
    theirs = _step_files(whole / "ckpt" / "8")
    assert sorted(mine) == sorted(theirs)
    assert any(k.startswith("shard-1.pt/model/") for k in mine)
    for key, t in mine.items():
        assert t.numpy().tobytes() == theirs[key].numpy().tobytes(), key


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

