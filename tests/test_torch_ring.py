"""The port's bucketed ring all-reduce
(``move2kube_tpu_torch/parallel/overlap.py``) in gloo worlds of 2-4
processes on the CPU, at n = 2, 3 and 4, at widths 3 (the pad path) and 16
and on a tree of fp32 and bf16 leaves: every rank's result has the same
bits as every other rank's and as the JAX package's ``ring_all_reduce``
under ``shard_map`` on the first n of the 8 forced CPU devices, fed the
same inputs (``tests/test_topology.py``'s way of running it). The
data-parallel steps over it are ``tests/test_torch_dp_steps.py``; both
files run their worlds with :class:`World` and ``WORKER``.

Each world runs in spawned processes on a ``FileStore`` under
``tmp_path``, each rank destroys its group, and the test's process holds
no group (ROADMAP.md's test hygiene).
"""

import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from move2kube_tpu.parallel.compat import shard_map  # noqa: E402
from move2kube_tpu.parallel.overlap import (  # noqa: E402
    ring_all_gather as jgather,
    ring_all_reduce as jring,
    ring_reduce_scatter as jscatter,
)
from move2kube_tpu_torch.ops import _build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240


def _environ() -> dict:
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    import torch.distributed as dist

    handler = signal.getsignal(signal.SIGTERM)
    env = _environ()
    build = _build.build_dir()
    yield
    assert signal.getsignal(signal.SIGTERM) == handler
    assert _environ() == env
    assert _build.build_dir() == build
    assert not dist.is_initialized()


WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, n, store, spec_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    spec = json.load(open(spec_path))
    data = np.load(spec["inputs"])
    out = {}
    if spec["job"] == "ring":
        from move2kube_tpu_torch.parallel.overlap import (
            ring_all_gather,
            ring_all_reduce,
            ring_reduce_scatter,
        )

        for case in spec["cases"]:
            tree = {name: torch.from_numpy(data[f"{case}/{name}"][rank]).to(
                getattr(torch, dtype))
                for name, dtype in spec["leaves"][case]}
            for name, t in ring_all_reduce(tree).items():
                out[f"{case}/{name}"] = t.float().numpy()
        for case in spec.get("fsdp_cases", []):
            kind, dim, dtype = case.split("-")
            x = torch.from_numpy(data[case][rank]).to(getattr(torch, dtype))
            fn = ring_all_gather if kind == "ag" else ring_reduce_scatter
            got = fn(x, None, int(dim[1:]))
            assert got.dtype == x.dtype
            out[case] = got.float().numpy()
        if spec.get("mesh_groups"):
            from move2kube_tpu_torch.parallel.mesh import (
                MeshConfig,
                make_mesh,
            )
            from move2kube_tpu_torch.parallel.overlap import mesh_ring_group

            for extents, axes in spec["mesh_groups"]:
                mesh = make_mesh(MeshConfig(**extents), device="cpu")
                group = mesh_ring_group(mesh, tuple(axes))
                key = "group/" + "x".join(f"{a}{v}" for a, v in
                                          sorted(extents.items()))
                out[f"{key}/{'+'.join(axes)}"] = np.asarray(
                    dist.get_process_group_ranks(group))
    else:
        import dataclasses
        import os

        from move2kube_tpu_torch.models import bert, gpt2, llama, resnet
        from move2kube_tpu_torch.models import train as T
        from move2kube_tpu_torch.models.convert import params_from_jax
        from move2kube_tpu_torch.obs.numerics import health_from_state
        from move2kube_tpu_torch.parallel import overlap
        from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh
        from move2kube_tpu_torch.parallel.sharding import shard_params

        extents = spec.get("mesh", {"data": n})
        mesh = make_mesh(MeshConfig(**extents), device="cpu")
        fsdp = extents.get("fsdp", 1) > 1
        fsdp_ring = (overlap.mesh_ring_group(mesh, ("fsdp",)) if fsdp
                     else None)

        def tree(prefix):
            flat = {k[len(prefix):]: data[k] for k in data.files
                    if k.startswith(prefix)}
            root = {}
            for key, v in flat.items():
                node = root
                *head, leaf = key.split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[leaf] = v
            return root

        for case in spec["cases"]:
            fam, k = case["family"], case["grad_accum"]
            if fam == "llama":
                cfg = dataclasses.replace(llama.llama_tiny(),
                                          dtype=torch.float32,
                                          attn_impl="flash")
                model = llama.Llama(cfg, device="cpu")
            elif fam == "gpt2":
                cfg = dataclasses.replace(gpt2.gpt2_tiny(),
                                          dtype=torch.float32)
                model = gpt2.GPT2(cfg, device="cpu")
            elif fam == "bert":
                cfg = bert.bert_tiny(dtype=torch.float32)
                model = bert.BertEncoder(cfg, device="cpu")
            else:
                cfg = resnet.resnet18_ish(num_classes=10,
                                          dtype=torch.float32)
                model = resnet.ResNet(cfg, device="cpu")
            model.load_state_dict(params_from_jax(tree(fam + "/init/"), cfg))
            os.environ["M2KT_FSDP_PREFETCH"] = case.get("prefetch", "auto")
            layout = shard_params(model, mesh) if fsdp else None
            if fam in ("llama", "gpt2"):
                step = T.make_lm_train_step(remat=False, grad_accum=k,
                                            chunk=case["chunk"], mesh=mesh)
            elif fam == "bert":
                step = T.make_bert_train_step(mesh=mesh)
            else:
                step = T.make_classifier_train_step(
                    has_batch_stats=True, grad_accum=k, mesh=mesh)
            opt = T.Optimizer(torch.optim.SGD(model.parameters(),
                                              lr=case["lr"]))
            state = T.TrainState(model, T.instrument_optimizer(opt)
                                 if fsdp else opt)
            name, batches = case["name"], case.get("batches", case["name"])
            losses = []
            for t in range(2):
                batch = {}
                for key in case["keys"]:
                    a = data[f"{batches}/batch{t}/{key}"]
                    axis = 1 if k > 1 else 0
                    per = a.shape[axis] // n
                    rows = slice(rank * per, (rank + 1) * per)
                    a = a[:, rows] if axis else a[rows]
                    batch[key] = torch.from_numpy(np.ascontiguousarray(a))
                state, loss = step(state, batch)
                losses.append(float(loss))
            out[f"{name}/losses"] = np.asarray(losses, np.float64)
            for key, t in model.state_dict().items():
                dim = layout.dims.get(key) if layout is not None else None
                if fsdp:
                    out[f"{name}/shard/{key}"] = t.numpy()
                    if dim is not None:
                        t = overlap.ring_all_gather(t, fsdp_ring, dim)
                out[f"{name}/sd/{key}"] = t.numpy()
            if fsdp:
                out[f"{name}/grad_norm"] = np.asarray(
                    T.grad_norm_from_state(state))
                for field, v in health_from_state(state)._asdict().items():
                    out[f"{name}/health/{field}"] = v.numpy()
    np.savez(out_path, **out)
finally:
    dist.destroy_process_group()
'''


class World:
    """``script`` (default WORKER) in a gloo world of ``n`` spawned
    processes, started at once; :meth:`outputs` waits and returns each
    rank's outputs."""

    def __init__(self, tmp_path, tag: str, n: int, spec: dict,
                 script_text: str = WORKER) -> None:
        script = tmp_path / f"{tag}-worker.py"
        script.write_text(script_text)
        spec_path = tmp_path / f"{tag}.json"
        spec_path.write_text(json.dumps(spec))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("M2KT_")}
        env["PYTHONPATH"] = REPO
        # the ranks share the box's cores: one thread each (tiny widths)
        env["OMP_NUM_THREADS"] = "1"
        self.outs = [tmp_path / f"{tag}-out-{r}.npz" for r in range(n)]
        # each rank writes to a file of its own: a pipe nobody reads while
        # the test's process compiles its references would block a rank
        # that writes more than the pipe holds, and its peers with it
        self.logs = [tmp_path / f"{tag}-rank-{r}.log" for r in range(n)]
        self.procs = []
        for r in range(n):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(r), str(n),
                     str(tmp_path / f"{tag}.store"), str(spec_path),
                     str(self.outs[r])],
                    cwd=tmp_path, env=env, stdout=log,
                    stderr=subprocess.STDOUT))

    def outputs(self) -> list[dict]:
        try:
            for p in self.procs:
                p.wait(timeout=WORLD_TIMEOUT_S)
        finally:
            self.kill()
        for p, log in zip(self.procs, self.logs):
            assert p.returncode == 0, log.read_text()[-3000:]
        return [dict(np.load(o)) for o in self.outs]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# -------------------------------------------------------------- the ring

RING_CASES = {
    "w3": [("a", "float32")],
    "w16": [("a", "float32")],
    "tree": [("bias", "bfloat16"), ("kernel", "float32"),
             ("scale", "float32")],
}
RING_SHAPES = {"w3": {"a": (3,)}, "w16": {"a": (16,)},
               "tree": {"bias": (5,), "kernel": (4, 3), "scale": (7,)}}


def _ring_inputs(n: int) -> dict:
    rng = np.random.default_rng(n)
    out = {}
    for case, leaves in RING_CASES.items():
        for name, dtype in leaves:
            a = rng.normal(size=(n,) + RING_SHAPES[case][name]).astype(
                np.float32)
            if dtype == "bfloat16":  # values a bf16 leaf holds exactly
                a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
            out[f"{case}/{name}"] = a
    return out


def _jax_ring(n: int, inputs: dict) -> dict:
    """The reference's ring on each case's tree (one ``ring_all_reduce``
    call a case, all cases in one ``shard_map``)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    trees = {case: {name: jnp.asarray(inputs[f"{case}/{name}"],
                                      getattr(jnp, dtype))
                    for name, dtype in leaves}
             for case, leaves in RING_CASES.items()}

    def f(ts):
        return {case: jax.tree.map(lambda a: a[None], jring(
            jax.tree.map(lambda a: a[0], t), "x")) for case, t in ts.items()}

    got = shard_map(f, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"))(trees)
    return {f"{case}/{name}": np.asarray(v.astype(jnp.float32))
            for case, t in got.items() for name, v in t.items()}


# the FSDP rings: "<ag|rs>-d<dim>-<dtype>"; each rank's input is a shard
# (all-gather) or a whole leaf whose dimension n divides (reduce-scatter)
FSDP_RING_CASES = [f"{kind}-d{dim}-{dtype}" for kind in ("ag", "rs")
                   for dim in (0, 1) for dtype in ("float32", "bfloat16")]


def _fsdp_shape(case: str, n: int) -> tuple:
    kind, dim, _ = case.split("-")
    if kind == "ag":
        return (3, 5) if dim == "d0" else (4, 3)
    return (2 * n, 5) if dim == "d0" else (3, 2 * n)


def _fsdp_ring_inputs(n: int) -> dict:
    rng = np.random.default_rng(100 + n)
    out = {}
    for case in FSDP_RING_CASES:
        a = rng.normal(size=(n,) + _fsdp_shape(case, n)).astype(np.float32)
        if case.endswith("bfloat16"):  # values a bf16 leaf holds exactly
            a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        out[case] = a
    return out


def _jax_fsdp_rings(n: int, inputs: dict) -> dict:
    """The reference's ``ring_all_gather`` and ``ring_reduce_scatter`` on
    each case, all in one ``shard_map``."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    xs = {case: jnp.asarray(inputs[case], getattr(jnp, case.split("-")[2]))
          for case in FSDP_RING_CASES}

    def f(ts):
        out = {}
        for case, t in ts.items():
            kind, dim, _ = case.split("-")
            fn = jgather if kind == "ag" else jscatter
            out[case] = fn(t[0], "x", int(dim[1:]))[None]
        return out

    got = shard_map(f, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"))(xs)
    return {case: np.asarray(v.astype(jnp.float32))
            for case, v in got.items()}


# mesh_ring_group's cases: (world, mesh extents, axes) and the ranks of
# each rank's group; a rank's mesh coordinates are (data, fsdp) in
# row-major order, rank = 2 data + fsdp on the 2 x 2 mesh
MESH_GROUPS = [
    (4, {"data": 2, "fsdp": 2}, ["data"]),
    (4, {"data": 2, "fsdp": 2}, ["fsdp"]),
    (4, {"data": 2, "fsdp": 2}, ["data", "fsdp"]),
    (2, {"fsdp": 2}, ["fsdp"]),
]
MESH_GROUP_RANKS = [
    [[0, 2], [1, 3], [0, 2], [1, 3]],
    [[0, 1], [0, 1], [2, 3], [2, 3]],
    [[0, 1, 2, 3]] * 4,
    [[0, 1], [0, 1]],
]


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    inputs, worlds = {}, {}
    try:
        for n in (2, 3, 4):
            inputs[n] = {**_ring_inputs(n), **_fsdp_ring_inputs(n)}
            np.savez(tmp / f"ring{n}.npz", **inputs[n])
            worlds[n] = World(tmp, f"ring{n}", n, {
                "job": "ring", "inputs": str(tmp / f"ring{n}.npz"),
                "cases": list(RING_CASES), "leaves": RING_CASES,
                "fsdp_cases": FSDP_RING_CASES,
                "mesh_groups": [(extents, axes) for m, extents, axes
                                in MESH_GROUPS if m == n]})
        # the six references compile three at a time while the worlds run:
        # XLA's compiles are most of this file's time and run outside the
        # GIL (on an idle box 29.8 s six at a time, 31.5 s three, 95 s one)
        with ThreadPoolExecutor(3) as pool:
            jobs = {n: [pool.submit(fn, n, inputs[n])
                        for fn in (_jax_ring, _jax_fsdp_rings)]
                    for n in worlds}
            want = {n: {k: v for job in js for k, v in job.result().items()}
                    for n, js in jobs.items()}
        return {n: (inputs[n], worlds[n].outputs(), want[n])
                for n in worlds}
    finally:
        for w in worlds.values():
            w.kill()


@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_ring_is_bit_equal_across_ranks_and_to_the_reference(rings, n, case):
    inputs, got, want = rings[n]
    for name, dtype in RING_CASES[case]:
        key = f"{case}/{name}"
        for r in range(n):
            assert got[r][key].tobytes() == got[0][key].tobytes(), (key, r)
            assert got[r][key].tobytes() == want[key][r].tobytes(), (key, r)
        # and it is the sum: fp32 rounding in the ring's order, then the
        # leaf's own type (bf16 keeps 8 bits)
        rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(got[0][key], inputs[key].sum(0),
                                   rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("case", FSDP_RING_CASES)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_fsdp_rings_are_bit_equal_to_the_reference(rings, n, case):
    """``ring_all_gather`` and ``ring_reduce_scatter``: every rank's
    result has the bits of the reference's on the same device, and is the
    whole leaf (the shards in rank order along ``dim``) or this rank's
    slice of the sum (in the leaf's dtype: bf16 keeps 8 bits a hop)."""
    inputs, got, want = rings[n]
    kind, dim, dtype = case.split("-")
    dim = int(dim[1:])
    x = inputs[case]
    for r in range(n):
        assert got[r][case].tobytes() == want[case][r].tobytes(), (case, r)
        if kind == "ag":
            np.testing.assert_array_equal(
                got[r][case], np.concatenate(list(x), axis=dim))
        else:
            size = x.shape[1 + dim] // n
            exact = np.take(x.sum(0), np.arange(r * size, (r + 1) * size),
                            axis=dim)
            bound = (n * 2.0 ** -8 * np.abs(x).sum(0) if dtype == "bfloat16"
                     else 1e-6 * np.abs(x).sum(0))
            bound = np.take(bound, np.arange(r * size, (r + 1) * size),
                            axis=dim)
            assert np.all(np.abs(got[r][case] - exact) <= bound), (case, r)


@pytest.mark.parametrize("case", range(len(MESH_GROUPS)))
def test_mesh_ring_group_holds_the_ranks_off_its_axes(rings, case):
    """``mesh_ring_group(mesh, axes)``: each rank's group is the ranks that
    share its coordinates on every other axis of the mesh, in rank
    order (the rings' neighbours)."""
    n, extents, axes = MESH_GROUPS[case]
    _, got, _ = rings[n]
    key = ("group/" + "x".join(f"{a}{v}" for a, v in sorted(extents.items()))
           + "/" + "+".join(axes))
    assert [got[r][key].tolist() for r in range(n)] == MESH_GROUP_RANKS[case]
