"""The collectives of a split model (``parallel/overlap.py``), the
vocab-parallel loss (``ops/crossentropy.py``), the MoE's routing over a
batch group (``models/moe.py``), the collective decode matmul and the
checkpoint of a two-axis layout (``models/checkpoint.py``), in gloo worlds
of 2 and 4 on the CPU.

- ``column_entry``/``row_exit`` around a column-split and a row-split
  product, ``gather_split`` and ``sum_over``: the values and gradients of
  autograd on the plain whole products, within 1e-6 (fp32 sums over ranks
  in another order).
- The vocab-parallel head-folded loss on each rank's head rows against
  ``reference_cross_entropy`` on the whole logits, its value and its
  gradients, within 1e-6; the same bits on every rank.
- The routing of each rank's tokens over the group against the JAX
  package's ``top_k_routing`` over the concatenated batch: the same kept
  pairs and global queue positions, gates and aux loss within 1e-6
  (``tests/test_torch_moe.py``'s ``ROUTE_ATOL``), tokens dropped.
- ``collective_decode_matmul`` in worlds of 2 and 4 against ``x @ w`` on
  the reference test's shapes (``tests/test_kernels.py``), the padded
  100- and 102-column cases among them, within 1e-4, the same bits on
  every rank; ``select_decode_matmul`` off a ``model`` axis is ``x @ w``.
- A checkpoint saved at ``fsdp=2 x tensor=2`` (Adam moments included)
  restores bit for bit into ``tensor=2`` and into one rank.
- Minitrain (``resilience/minitrain.py``) under the supervisor in a
  tensor=2 and an expert=2 world, its losses one rank's bits.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread
import torch._dynamo  # noqa: E402,F401 - before any optimizer steps

import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import moe as jmoe  # noqa: E402
from tests.test_torch_ring import (  # noqa: E402,F401
    World,
    _process_state_unchanged,
)

GRAD_ATOL = 1e-6
ROUTE_ATOL = 1e-6
MATMUL_ATOL = 1e-4
MATMUL_SHAPES = [(4, 64, 100), (4, 64, 102), (2, 64, 128)]
E, K, ROUTE_T, ROUTE_CAP = 4, 2, 12, 5

WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

rank, n, store, spec_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    from move2kube_tpu_torch.parallel import overlap
    spec = json.load(open(spec_path))
    data = np.load(spec["inputs"]) if spec.get("inputs") else None
    group = dist.group.WORLD
    out = {}
    if "ops" in spec["jobs"]:
        from move2kube_tpu_torch.models.moe import top_k_routing
        from move2kube_tpu_torch.ops.crossentropy import (
            fused_linear_cross_entropy)

        t = lambda k: torch.from_numpy(data[k]).clone()
        x = t("x").requires_grad_(True)
        w1, w2 = t("w1"), t("w2")
        r1 = w1.shape[0] // n
        w1r = w1[rank * r1:(rank + 1) * r1].clone().requires_grad_(True)
        r2 = w2.shape[1] // n
        w2r = w2[:, rank * r2:(rank + 1) * r2].clone().requires_grad_(True)
        h = torch.tanh(F.linear(overlap.column_entry(x, group), w1r))
        y = overlap.row_exit(F.linear(h, w2r), group)
        (y * y).sum().backward()
        out["y"], out["dx"] = y.detach().numpy(), x.grad.numpy()
        out["dw1"], out["dw2"] = w1r.grad.numpy(), w2r.grad.numpy()
        part = t("x")[:, rank * 2:(rank + 1) * 2].requires_grad_(True)
        whole = overlap.gather_split(part, group, 1)
        (whole * t("x")[:, :2 * n]).sum().backward()
        out["gathered"], out["dpart"] = whole.detach().numpy(), part.grad.numpy()
        s = t("x")[rank].requires_grad_(True)
        total = overlap.sum_over(s, group)
        (total * total).sum().backward()
        out["sum"], out["dsum"] = total.detach().numpy(), s.grad.numpy()
        hid = t("hidden").requires_grad_(True)
        head = t("head")
        v = head.shape[0] // n
        head_r = head[rank * v:(rank + 1) * v].clone().requires_grad_(True)
        loss = fused_linear_cross_entropy(
            hid, head_r, torch.from_numpy(data["labels"]), 8, group, rank)
        loss.backward()
        out["ce"] = loss.detach().numpy()
        out["dhidden"], out["dhead"] = hid.grad.numpy(), head_r.grad.numpy()
        logits = t("logits")[rank]
        d, c, aux = top_k_routing(logits, spec["E"], spec["K"], spec["cap"],
                                  group)
        out["keep"] = (d.sum(-1) > 0).numpy()
        out["slot"] = d.argmax(-1).numpy()
        out["gates"] = c.sum(-1).numpy()
        out["aux"] = aux.numpy()
    if "matmul" in spec["jobs"]:
        from move2kube_tpu_torch.parallel.overlap import (
            collective_decode_matmul)
        from move2kube_tpu_torch.serving.engine import select_decode_matmul

        for b, i, o in spec["shapes"]:
            x = torch.from_numpy(data[f"mm/{b}x{i}x{o}/x"])
            w = torch.from_numpy(data[f"mm/{b}x{i}x{o}/w"])
            rows = i // n
            y = collective_decode_matmul(group, x,
                                         w[rank * rows:(rank + 1) * rows])
            out[f"mm/{b}x{i}x{o}"] = y.numpy()
            out[f"plain/{b}x{i}x{o}"] = select_decode_matmul(None)(x, w).numpy()
    if "save" in spec["jobs"] or "restore" in spec["jobs"]:
        import dataclasses

        from move2kube_tpu_torch.models import checkpoint as C
        from move2kube_tpu_torch.models import llama
        from move2kube_tpu_torch.models import train as T
        from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh
        from move2kube_tpu_torch.parallel.sharding import gather_full, layout_of

        cfg = dataclasses.replace(llama.llama_tiny(), dtype=torch.float32,
                                  attn_impl="flash")
        mesh = make_mesh(MeshConfig(**spec["mesh"]), device="cpu")
        save = "save" in spec["jobs"]
        state = T.create_sharded_state(
            cfg, mesh, lambda ps: T.adam(ps, 1e-3), seed=0 if save else 7,
            device="cpu")
        mgr = C.CheckpointManager(spec["ckpt"], every=1)
        if save:
            step = T.make_lm_train_step(remat=False, chunk=128, mesh=mesh)
            ids = torch.from_numpy(data["ids"])
            state, _ = step(state, {"input_ids": ids})
            assert mgr.maybe_save(1, state, force=True)
            mgr.close()
        else:
            state, start = mgr.restore_or_init(state)
            assert start == 1, start
        lay = layout_of(state.model)
        inner = state.optimizer.inner
        for name, p in state.model.named_parameters():
            out[f"sd/{name}"] = gather_full(lay, name, p.data, mesh).numpy()
            for slot in ("exp_avg", "exp_avg_sq"):
                out[f"opt/{name}/{slot}"] = gather_full(
                    lay, name, inner.state[p][slot], mesh).numpy()
            out[f"part/{name}"] = p.data.numpy()
            out[f"take/{name}"] = lay.take(
                name, torch.from_numpy(out[f"sd/{name}"])).numpy()
    np.savez(out_path, **out)
finally:
    dist.destroy_process_group()
'''


def _inputs(n):
    rng = np.random.default_rng(40 + n)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    out = {"x": f(4, 8), "w1": f(6 * n, 8),
           "w2": f(8, 6 * n), "hidden": f(10, 8), "head": f(16 * n, 8),
           "labels": rng.integers(0, 16 * n, 10),
           "logits": f(n, ROUTE_T, E)}
    for b, i, o in MATMUL_SHAPES:
        out[f"mm/{b}x{i}x{o}/x"] = f(b, i)
        out[f"mm/{b}x{i}x{o}/w"] = f(i, o)
    return out


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpops")
    inputs, worlds = {}, {}
    try:
        for n in (2, 4):
            inputs[n] = _inputs(n)
            np.savez(tmp / f"in{n}.npz", **inputs[n])
            worlds[n] = World(tmp, f"ops{n}", n, {
                "inputs": str(tmp / f"in{n}.npz"), "jobs": ["ops", "matmul"],
                "E": E, "K": K, "cap": ROUTE_CAP,
                "shapes": MATMUL_SHAPES}, WORKER)
        np.savez(tmp / "ids.npz", ids=np.random.default_rng(5).integers(
            0, 512, (4, 32)))
        worlds["save"] = World(tmp, "save", 4, {
            "inputs": str(tmp / "ids.npz"), "jobs": ["save"],
            "mesh": {"fsdp": 2, "tensor": 2}, "ckpt": str(tmp / "ckpt")},
            WORKER)
        out = {n: worlds[n].outputs() for n in (2, 4)}
        saved = worlds["save"].outputs()
        worlds["restore"] = World(tmp, "restore", 2, {
            "jobs": ["restore"], "mesh": {"tensor": 2},
            "ckpt": str(tmp / "ckpt")}, WORKER)
        restored = worlds["restore"].outputs()
        return inputs, out, saved, restored, tmp / "ckpt"
    finally:
        for w in worlds.values():
            w.kill()


@pytest.mark.parametrize("n", [2, 4])
def test_column_entry_and_row_exit_match_autograd(ops, n):
    inputs, out, _, _, _ = ops
    t = {k: torch.from_numpy(v) for k, v in inputs[n].items()
         if not k.startswith("mm/")}
    x = t["x"].clone().requires_grad_(True)
    w1 = t["w1"].clone().requires_grad_(True)
    w2 = t["w2"].clone().requires_grad_(True)
    y = torch.nn.functional.linear(torch.tanh(
        torch.nn.functional.linear(x, w1)), w2)
    (y * y).sum().backward()
    r1, r2 = w1.shape[0] // n, w2.shape[1] // n
    for r, got in enumerate(out[n]):
        np.testing.assert_allclose(got["y"], y.detach().numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_ATOL)
        np.testing.assert_allclose(got["dx"], x.grad.numpy(), atol=1e-5,
                                   rtol=GRAD_ATOL)
        np.testing.assert_allclose(got["dw1"],
                                   w1.grad[r * r1:(r + 1) * r1].numpy(),
                                   atol=1e-5, rtol=GRAD_ATOL)
        np.testing.assert_allclose(got["dw2"],
                                   w2.grad[:, r * r2:(r + 1) * r2].numpy(),
                                   atol=1e-5, rtol=GRAD_ATOL)
        assert got["y"].tobytes() == out[n][0]["y"].tobytes()
        # gather_split: the whole activation; backward keeps the slice
        np.testing.assert_array_equal(got["gathered"],
                                      inputs[n]["x"][:, :2 * n])
        np.testing.assert_array_equal(
            got["dpart"], inputs[n]["x"][:, r * 2:(r + 1) * 2])
        # sum_over: the sum, and the gradients summed back
        total = inputs[n]["x"][:n].sum(0)
        np.testing.assert_allclose(got["sum"], total, atol=GRAD_ATOL)
        np.testing.assert_allclose(got["dsum"], 2 * n * total, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_loss_matches_the_reference(ops, n):
    from move2kube_tpu_torch.ops.crossentropy import reference_cross_entropy

    inputs, out, _, _, _ = ops
    hid = torch.from_numpy(inputs[n]["hidden"]).requires_grad_(True)
    head = torch.from_numpy(inputs[n]["head"]).requires_grad_(True)
    loss = reference_cross_entropy(hid @ head.T,
                                   torch.from_numpy(inputs[n]["labels"]))
    loss.backward()
    v = head.shape[0] // n
    for r, got in enumerate(out[n]):
        np.testing.assert_allclose(float(got["ce"]), float(loss.detach()),
                                   rtol=GRAD_ATOL)
        assert got["ce"].tobytes() == out[n][0]["ce"].tobytes()
        np.testing.assert_allclose(got["dhidden"], hid.grad.numpy(),
                                   atol=GRAD_ATOL)
        np.testing.assert_allclose(got["dhead"],
                                   head.grad[r * v:(r + 1) * v].numpy(),
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_moe_routing_over_the_group_matches_jax_on_the_whole_batch(ops, n):
    inputs, out, _, _, _ = ops
    logits = inputs[n]["logits"].reshape(n * ROUTE_T, E)
    d, c, aux = jmoe.top_k_routing(jnp.asarray(logits), E, K, ROUTE_CAP)
    d, c = np.asarray(d), np.asarray(c)
    keep = d.sum(-1) > 0
    assert keep.sum() < n * ROUTE_T * K  # the capacity drops tokens
    routed = np.zeros(E, np.int64)
    for r, got in enumerate(out[n]):
        rows = slice(r * ROUTE_T, (r + 1) * ROUTE_T)
        np.testing.assert_array_equal(got["keep"], keep[rows])
        # global queue position = local slot + the earlier ranks' routed
        # tokens of that expert
        slot = np.where(got["keep"], got["slot"] + routed[None], 0)
        np.testing.assert_array_equal(slot, np.where(keep[rows],
                                                     d[rows].argmax(-1), 0))
        np.testing.assert_allclose(got["gates"], c[rows].sum(-1),
                                   atol=ROUTE_ATOL)
        np.testing.assert_allclose(float(got["aux"]), float(aux),
                                   atol=ROUTE_ATOL)
        routed += _mask(inputs[n]["logits"][r]).sum(0)


def _mask(logits):
    """Each token's top-K experts as a 0/1 ``[T, E]`` mask."""
    top = np.argsort(-logits, axis=-1)[:, :K]
    m = np.zeros_like(logits, dtype=np.int64)
    np.put_along_axis(m, top, 1, axis=-1)
    return m


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", MATMUL_SHAPES,
                         ids=[f"{b}x{i}x{o}" for b, i, o in MATMUL_SHAPES])
def test_collective_decode_matmul_matches_the_plain_product(ops, n, shape):
    inputs, out, _, _, _ = ops
    key = "x".join(str(v) for v in shape)
    x, w = inputs[n][f"mm/{key}/x"], inputs[n][f"mm/{key}/w"]
    want = x @ w
    for got in out[n]:
        assert got[f"mm/{key}"].shape == want.shape
        assert np.abs(got[f"mm/{key}"] - want).max() < MATMUL_ATOL
        assert got[f"mm/{key}"].tobytes() == out[n][0][f"mm/{key}"].tobytes()
        np.testing.assert_allclose(got[f"plain/{key}"], want, atol=1e-5)


def test_checkpoint_at_fsdp_x_tensor_restores_into_tensor_and_one_rank(ops):
    from move2kube_tpu_torch.models import checkpoint as C
    from move2kube_tpu_torch.models import llama
    from move2kube_tpu_torch.models import train as T

    _, _, saved, restored, ckpt = ops
    meta = json.loads((ckpt / "1" / "meta.json").read_text())
    assert meta["sharded"]["axes"] == [["fsdp", 2], ["tensor", 2]]
    assert sorted(p.name for p in (ckpt / "1").iterdir()
                  if p.name.startswith("shard-")) == [
        f"shard-{r}.pt" for r in range(4)]
    qkv = meta["sharded"]["leaves"]["layers.0.qkv.weight"]["cuts"]
    assert qkv == [["tensor", 0, 2, [128, 64, 64]], ["fsdp", 1, 2, [128]]]
    keys = [k for k in saved[0] if k.startswith(("sd/", "opt/"))]
    for out in saved + restored:
        for k in keys:
            assert out[k].tobytes() == saved[0][k].tobytes(), k
        for k in out:
            if k.startswith("part/"):
                assert out[k].tobytes() == out["take/" + k[5:]].tobytes()
    model = llama.Llama(dataclasses.replace(
        llama.llama_tiny(), dtype=torch.float32, attn_impl="flash"),
        device="cpu")
    for p in model.parameters():
        torch.nn.init.zeros_(p)
    state = T.TrainState(model, T.adam(model.parameters(), 1e-3))
    state, start = C.CheckpointManager(str(ckpt)).restore_or_init(state)
    assert start == 1
    inner = state.optimizer.inner
    for name, p in model.named_parameters():
        assert p.detach().numpy().tobytes() == saved[0][f"sd/{name}"].tobytes()
        for slot in ("exp_avg", "exp_avg_sq"):
            assert inner.state[p][slot].numpy().tobytes() == saved[0][
                f"opt/{name}/{slot}"].tobytes(), (name, slot)


@pytest.mark.parametrize("knobs,mesh", [
    ({"M2KT_MESH_TENSOR": 2}, "1x1x1x2x1x1"),
    ({"M2KT_MESH_EXPERT": 2}, "1x1x1x1x1x2")], ids=["tensor2", "expert2"])
def test_minitrain_trains_a_tensor_or_expert_world(tmp_path, knobs, mesh):
    """Minitrain plans a tensor or an expert axis from the planner's env:
    the rules cut none of its leaves over it, so its two ranks take the
    same rows and train as copies; each step's loss has the bits of one
    rank's run on the same global batch."""
    from tests.test_torch_dist_train import _finish, _supervised

    losses = {}
    for tag, world in (("world", dict(M2KT_FORCE_DEVICES=2, **knobs)),
                       ("one", {})):
        work = tmp_path / tag
        work.mkdir()
        run = _finish(_supervised(work, M2KT_STEPS=4, OMP_NUM_THREADS=1,
                                  **world))
        assert run.returncode == 0, run.stderr[-3000:]
        if tag == "world":
            assert f"mesh={mesh} " in run.stdout, run.stdout[-3000:]
            assert "global_batch=4" in run.stdout
        losses[tag] = [x for x in run.stdout.splitlines()
                       if x.startswith("[m2kt] step ") and " loss 0x" in x]
    assert len(losses["one"]) == 4
    assert losses["world"] == losses["one"]
