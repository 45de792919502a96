"""The port's input pipeline (``move2kube_tpu_torch/models/data.py``)
against the JAX package's (``move2kube_tpu/models/data.py``): the same
npz, seed and global batch give equal batches over three epochs, across
the reshuffles; ``skip`` and ``AccumLoader`` as the reference's; the
prefetch loader's order, skip rule and terminal contracts; jsonl, npy and
directory sources; the synthetic loader; the port's case of the
reference's context-manager test; and every pump thread joined after
``close``.

Everything runs on the CPU (``device="cpu"``); the card's pinned, side-
stream path is held in ``tests/test_torch_resilience_cuda.py``. Paths
live under ``tmp_path``; the SIGTERM handler, ``os.environ`` and the
kernel build directory are checked unchanged after every test.
"""

import itertools
import json
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.models import data as jdata  # noqa: E402
from move2kube_tpu.native import gather_rows as jgather  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu_torch.models import data as tdata  # noqa: E402
from move2kube_tpu_torch.ops import _build  # noqa: E402


def _environ() -> dict:
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    handler = signal.getsignal(signal.SIGTERM)
    env = _environ()
    build = _build.build_dir()
    threads = set(threading.enumerate())
    yield
    assert signal.getsignal(signal.SIGTERM) == handler
    assert _environ() == env
    assert _build.build_dir() == build
    # every pump thread a test started is joined by its close()
    assert not [t for t in threading.enumerate()
                if t not in threads and t.is_alive()]


@pytest.fixture(scope="module")
def mesh():
    import jax

    return make_mesh(MeshConfig(data=jax.device_count()))


def _npz(tmp_path, n=40, seq=6, seed=11):
    rng = np.random.default_rng(seed)
    path = tmp_path / "tokens.npz"
    np.savez(path, input_ids=rng.integers(0, 1000, (n, seq)).astype(np.int32),
             label=np.arange(n, dtype=np.int64))
    return str(path)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("seed,batch", [(0, 8), (3, 12)])
def test_batches_equal_the_jax_loaders_over_three_epochs(tmp_path, mesh,
                                                         prefetch, seed,
                                                         batch):
    """40 examples in batches of 8 or 12: three epochs' worth of batches,
    with the reshuffle at each epoch's end (12 leaves 4 rows unused an
    epoch, as the reference does)."""
    path = _npz(tmp_path)
    steps = 3 * (40 // batch)
    ref = jdata.HostShardedLoader(jdata.load_arrays(path), batch, mesh,
                                  seed=seed, to_device=False)
    want = [next(ref) for _ in range(steps)]
    with tdata.make_loader(path, batch, device="cpu", seed=seed,
                           prefetch=prefetch) as port:
        assert isinstance(port, tdata.PrefetchLoader) == prefetch
        for i, w in enumerate(want):
            got = next(port)
            assert set(got) == set(w)
            for k in w:
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(got[k].numpy(), w[k],
                                              err_msg=f"batch {i} {k}")
        assert port.position() == steps
    per = 40 // batch
    orders = {tuple(np.concatenate([w["label"] for w in want[e * per:
                                                              (e + 1) * per]]))
              for e in range(3)}
    assert len(orders) == 3  # each epoch its own permutation


def test_skip_matches_the_reference_across_epochs(tmp_path, mesh):
    path = _npz(tmp_path, n=20)
    for n in (0, 1, 2, 5, 7):
        ref = jdata.HostShardedLoader(jdata.load_arrays(path), 8, mesh,
                                      seed=3, to_device=False)
        port = tdata.HostShardedLoader(tdata.load_arrays(path), 8, seed=3)
        ref.skip(n)
        port.skip(n)
        assert port.position() == n
        for _ in range(3):
            a, b = next(ref), next(port)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_gather_rows_is_the_references():
    rng = np.random.default_rng(0)
    for src in (rng.standard_normal((50, 3, 2)).astype(np.float32),
                rng.integers(0, 9, (40,)).astype(np.int16),
                np.asfortranarray(rng.standard_normal((30, 4)))):
        idx = rng.integers(-len(src), len(src), 17)
        want = jgather(src, idx)
        got = tdata.gather_rows(src, idx)
        assert got.flags.c_contiguous and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        out = np.empty_like(want)
        assert tdata.gather_rows(src, idx, out=out) is out
        np.testing.assert_array_equal(out, want)


def test_sources_load_as_the_reference_loads_them(tmp_path):
    rows = [{"input_ids": [i, i + 1, i + 2], "label": i % 3}
            for i in range(16)]
    (tmp_path / "tok.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\n\n")
    np.save(tmp_path / "x.npy", np.arange(24.0).reshape(8, 3))
    d = tmp_path / "dir"
    d.mkdir()
    for i in range(2):
        np.savez(d / f"part{i}.npz", input=np.full((4, 2), i, np.float32))
    (d / "notes.txt").write_text("ignored")
    for path in (tmp_path / "tok.jsonl", tmp_path / "x.npy", d):
        want = jdata.load_arrays(str(path))
        got = tdata.load_arrays(str(path))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="unsupported"):
        tdata.load_arrays(str(tmp_path / "notes.csv"))
    (tmp_path / "e").mkdir()
    assert tdata.load_arrays(str(tmp_path / "e")) == {}


def test_npz_is_memory_mapped(tmp_path):
    """A stored npz's members are memory-mapped, a compressed one's read;
    both equal the reference's arrays."""
    rng = np.random.default_rng(2)
    arrays = {"a": rng.standard_normal((7, 3)).astype(np.float32),
              "b": np.asfortranarray(rng.integers(0, 5, (4, 6))),
              "c": np.arange(5, dtype=np.int16)}
    np.savez(tmp_path / "s.npz", **arrays)
    np.savez_compressed(tmp_path / "z.npz", **arrays)
    for name, mapped in (("s.npz", True), ("z.npz", False)):
        got = tdata.load_arrays(str(tmp_path / name))
        want = jdata.load_arrays(str(tmp_path / name))
        assert set(got) == set(want) == set(arrays)
        for k, v in arrays.items():
            assert isinstance(got[k], np.memmap) == mapped
            np.testing.assert_array_equal(got[k], v)
            np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_loader_and_skip():
    with tdata.make_loader(
            "", 4, device="cpu",
            synthetic_fn=lambda i: {"x": torch.full((4, 2), i)}) as loader:
        assert int(next(loader)["x"][0, 0]) == 0
        assert int(next(loader)["x"][0, 0]) == 1
        loader.skip(5)
        assert loader.position() == 7
        assert int(next(loader)["x"][0, 0]) == 7
    with pytest.raises(ValueError, match="no synthetic fn"):
        tdata.make_loader("", 4, device="cpu")


def test_make_loader_defaults_to_the_card(tmp_path):
    path = _npz(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdata.make_loader(path, 8)


def test_indivisible_or_small_shard_rejected(tmp_path):
    arrays = {"input": np.zeros((8, 2))}
    with pytest.raises(ValueError, match="needs >= 16"):
        tdata.HostShardedLoader(arrays, 16)
    with pytest.raises(ValueError, match="no arrays"):
        tdata.HostShardedLoader({}, 4)


def test_prefetch_preserves_order_and_skip(tmp_path):
    n, d = 64, 4
    arrays = {"input": np.arange(n * d, dtype=np.float32).reshape(n, d)}
    direct = tdata.HostShardedLoader(dict(arrays), 8, seed=5)
    want = [next(direct)["input"] for _ in range(6)]
    with tdata.PrefetchLoader(tdata.HostShardedLoader(dict(arrays), 8,
                                                      seed=5)) as pre:
        got = [next(pre)["input"] for _ in range(6)]
        assert pre.position() == 6
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    direct2 = tdata.HostShardedLoader(dict(arrays), 8, seed=5)
    direct2.skip(3)
    with tdata.PrefetchLoader(tdata.HostShardedLoader(dict(arrays), 8,
                                                      seed=5),
                              device="cpu") as pre2:
        pre2.skip(3)
        got = next(pre2)["input"]
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(next(direct2)["input"], got.numpy())
        with pytest.raises(RuntimeError):
            pre2.skip(1)  # iteration already started


def test_prefetch_error_and_exhaustion_keep_raising():
    class Boom:
        def __iter__(self):
            return self

        def __next__(self):
            raise ValueError("corrupt shard")

    with tdata.PrefetchLoader(Boom()) as pre:
        for _ in range(3):
            with pytest.raises(ValueError, match="corrupt shard"):
                next(pre)
    with tdata.PrefetchLoader(iter([{"x": 1}, {"x": 2}])) as pre:
        assert next(pre)["x"] == 1 and next(pre)["x"] == 2
        for _ in range(3):
            with pytest.raises(StopIteration):
                next(pre)


def test_prefetch_close_joins_the_pump_thread():
    with tdata.PrefetchLoader(itertools.repeat({"x": 1}), depth=1) as pre:
        assert next(pre)["x"] == 1  # starts the pump; the queue fills
        pump = pre._thread
        assert pump.is_alive()
    assert not pump.is_alive()
    with pytest.raises(StopIteration):
        next(pre)


def test_accum_loader_stacks_and_skips_as_the_reference():
    class Counting:
        def __init__(self, mk):
            self.i = 0
            self.skipped = 0
            self.closed = False
            self.mk = mk

        def __iter__(self):
            return self

        def __next__(self):
            self.i += 1
            return {"input_ids": self.mk(self.i)}

        def skip(self, n):
            self.skipped += n

        def position(self):
            return self.i + self.skipped

        def close(self):
            self.closed = True

    import jax.numpy as jnp

    theirs = Counting(lambda i: jnp.full((4, 8), i))
    ours = Counting(lambda i: torch.full((4, 8), i))
    with jdata.AccumLoader(theirs, 2) as jl, tdata.AccumLoader(ours, 2) as tl:
        for _ in range(2):
            a, b = next(jl), next(tl)
            assert tuple(b["input_ids"].shape) == a["input_ids"].shape \
                == (2, 4, 8)
            np.testing.assert_array_equal(np.asarray(a["input_ids"]),
                                          b["input_ids"].numpy())
        jl.skip(3)
        tl.skip(3)
        assert ours.skipped == theirs.skipped == 6
        assert tl.position() == 5
    assert ours.closed and theirs.closed
    with pytest.raises(ValueError, match="accumulation factor"):
        tdata.AccumLoader(ours, 0)
    host = tdata.AccumLoader(Counting(lambda i: np.full((2,), i)), 3)
    np.testing.assert_array_equal(next(host)["input_ids"],
                                  [[1, 1], [2, 2], [3, 3]])


def test_every_loader_variant_is_a_context_manager(tmp_path):
    """The port's case of the reference's
    ``tests/test_resilience.py::test_every_loader_variant_is_a_context_
    manager``: synthetic, prefetched and plain loaders all close."""
    with tdata.make_loader(
            "", 8, device="cpu",
            synthetic_fn=lambda i: {"x": torch.zeros((8, 2))}) as loader:
        assert tuple(next(iter(loader))["x"].shape) == (8, 2)
    np.savez(tmp_path / "d.npz", x=np.zeros((32, 2), np.float32))
    with tdata.make_loader(str(tmp_path / "d.npz"), 8,
                           device="cpu") as loader:
        assert tuple(next(iter(loader))["x"].shape) == (8, 2)
    # the pump thread is down: iterating a closed prefetch loader raises
    with pytest.raises((StopIteration, RuntimeError)):
        for _ in range(10):
            next(loader)
    with tdata.make_loader(str(tmp_path / "d.npz"), 8, device="cpu",
                           prefetch=False) as plain:
        assert isinstance(plain, tdata.HostShardedLoader)
        assert tuple(next(plain)["x"].shape) == (8, 2)


def test_prefetch_knob_turns_prefetch_off(tmp_path, monkeypatch):
    np.savez(tmp_path / "d.npz", x=np.zeros((32, 2), np.float32))
    monkeypatch.setenv("M2KT_PREFETCH", "0")
    with tdata.make_loader(str(tmp_path / "d.npz"), 8,
                           device="cpu") as loader:
        assert isinstance(loader, tdata.HostShardedLoader)


_SHARDS = """
import json, sys
import numpy as np
import torch.distributed as dist
from move2kube_tpu_torch.models.data import HostShardedLoader

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
try:
    arrays = {"label": np.arange(20)}
    loader = HostShardedLoader(arrays, 8, seed=1)
    got = [next(loader)["label"].tolist() for _ in range(4)]
    with open(f"{out}/rank-{rank}.json", "w") as f:
        json.dump({"range": [loader.start, loader.stop],
                   "local": loader.local_batch, "batches": got}, f)
finally:
    dist.destroy_process_group()
"""


def test_shards_follow_the_process_group(tmp_path):
    """In a two-process gloo world of two hosts (one rank each) each
    process reads its own host's contiguous half with the reference's
    permutation of it."""
    import socket
    import subprocess
    import sys

    script = tmp_path / "shards.py"
    script.write_text(_SHARDS)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env["PYTHONPATH"] = repo
    # the host count is the launcher's; the ranks of a host are consecutive
    env["M2KT_NUM_HOSTS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(tmp_path)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    for r, (start, stop) in enumerate([(0, 10), (10, 20)]):
        doc = json.loads((tmp_path / f"rank-{r}.json").read_text())
        assert doc["range"] == [start, stop] and doc["local"] == 4
        epoch = 0
        want = []
        while len(want) < 4:
            idx = np.arange(start, stop)
            np.random.default_rng(1 + epoch).shuffle(idx)
            want += [idx[i:i + 4].tolist() for i in (0, 4)]
            epoch += 1
        assert doc["batches"] == want[:4]
