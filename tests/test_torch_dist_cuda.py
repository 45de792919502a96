"""The port's data-parallel and FSDP steps on a card: two gloo ranks share
``cuda:0`` (each ring hop through pinned host memory) and train the tiny
Llama two steps through the overlapped path (``grad_accum`` 2, the
attention in the flash kernels). Their parameters end with the same bits;
the ring's result on the card has the bits of the same ring on CPU
tensors; each rank's kernel launches are its passes.

FSDP (fsdp=2, ``create_sharded_state``): the all-gather and reduce-scatter
rings on card tensors have the bits of the same rings on CPU tensors;
through two steps of the prefetched schedule each rank's shards are its
slices of the gathered tree, bit for bit, the gathered tree and the
replicated leaves have the same bits on both ranks, the optimizer's
moments are shards, and the launches are the passes. (The step itself
cannot have the CPU step's bits: on the card the attention is the flash
kernel and the products cuBLAS's, on the CPU their plain versions.)

Tensor parallelism (tensor=2): one layer of Llama-8B's widths split
over the two ranks trains two steps; the parts are their slices of the
gathered tree, which has one digest on both ranks, and the fp32 loss is
one rank's on the same batch.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = r'''
import dataclasses, hashlib, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, n, store, out = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    from move2kube_tpu_torch.models import llama
    from move2kube_tpu_torch.models import train as T
    from move2kube_tpu_torch.models.convert import init_llama
    from move2kube_tpu_torch.ops.attention import KERNELS, reset_launch_counts
    from move2kube_tpu_torch.parallel import overlap
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.cuda.set_device(0)
    rng = np.random.default_rng(rank + 5)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3,), (64, 5))]
    on_card = overlap.ring_all_reduce([torch.from_numpy(a).cuda()
                                       for a in leaves])
    cpu_group = dist.new_group([0, 1], backend="gloo")
    on_cpu = overlap.ring_all_reduce([torch.from_numpy(a) for a in leaves],
                                     cpu_group)
    ring_same = all(a.cpu().numpy().tobytes() == b.numpy().tobytes()
                    for a, b in zip(on_card, on_cpu))
    mesh = make_mesh(MeshConfig(data=n), device="cuda")
    # head_dim 64, a width the kernels take
    cfg = dataclasses.replace(llama.llama_tiny(), dtype=torch.float32,
                              num_heads=2, num_kv_heads=2,
                              attn_impl="flash")
    model = init_llama(cfg, seed=rank, device="cuda", dtype=torch.float32)
    state = T.TrainState(model, T.adamw(model.parameters(), 1e-3))
    step = T.make_lm_train_step(grad_accum=2, mesh=mesh)
    ids = np.random.default_rng(0).integers(0, 512, (2, 2, 4, 64))
    reset_launch_counts()
    shas = []
    for t in range(2):
        local = torch.from_numpy(ids[t][:, rank * 2:(rank + 1) * 2]).cuda()
        state, loss = step(state, {"input_ids": local})
        h = hashlib.sha256()
        for p in model.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
        shas.append(h.hexdigest())
    with open(f"{out}-{rank}.json", "w") as f:
        json.dump({"ring_same": ring_same, "shas": shas,
                   "launches": {k.name: k.launches for k in KERNELS},
                   "loss": float(loss)}, f)
finally:
    dist.destroy_process_group()
'''


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_two_ranks_on_one_card_train_bit_identically(cuda, tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         str(tmp_path / "out")], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        done = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, done):
        assert p.returncode == 0, err[-3000:]
    docs = [json.loads((tmp_path / f"out-{r}.json").read_text())
            for r in (0, 1)]
    assert all(d["ring_same"] for d in docs)
    assert docs[0]["shas"] == docs[1]["shas"]
    assert docs[0]["loss"] == docs[1]["loss"]
    # 2 steps x 2 microbatches x 2 layers: the forward and its remat
    # recompute, and each backward kernel once
    layers, passes = 2, 2 * 2
    for d in docs:
        assert d["launches"] == {
            "flash_fwd": 2 * layers * passes,
            "flash_bwd_dq": layers * passes,
            "flash_bwd_dkv": layers * passes, "paged_decode": 0,
            "paged_decode_int8": 0}


FSDP_RANK = r'''
import dataclasses, hashlib, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, n, store, out = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    from move2kube_tpu_torch.models import llama
    from move2kube_tpu_torch.models import train as T
    from move2kube_tpu_torch.ops.attention import KERNELS, reset_launch_counts
    from move2kube_tpu_torch.parallel import overlap
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.cuda.set_device(0)
    cpu_group = dist.new_group([0, 1], backend="gloo")
    rng = np.random.default_rng(rank + 11)
    same = []
    for dim, shape in ((0, (6, 5)), (1, (3, 8))):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            a = a.to(dtype)
            for fn in (overlap.ring_all_gather, overlap.ring_reduce_scatter):
                card = fn(a.cuda(), None, dim).cpu()
                host = fn(a, cpu_group, dim)
                same.append(card.dtype == host.dtype
                            and card.view(torch.uint8).numpy().tobytes()
                            == host.view(torch.uint8).numpy().tobytes())
    mesh = make_mesh(MeshConfig(fsdp=n), device="cuda")
    ring = overlap.mesh_ring_group(mesh, ("fsdp",))
    # head_dim 64, a width the kernels take
    cfg = dataclasses.replace(llama.llama_tiny(), dtype=torch.float32,
                              num_heads=2, num_kv_heads=2,
                              attn_impl="flash")
    state = T.create_sharded_state(cfg, mesh, lambda ps: T.adamw(ps, 1e-3),
                                   seed=0, device="cuda")
    lay = state.model.fsdp_layout
    step = T.make_lm_train_step(grad_accum=2, mesh=mesh)
    ids = np.random.default_rng(0).integers(0, 512, (2, 2, 4, 64))
    reset_launch_counts()
    steps = []
    for t in range(2):
        local = torch.from_numpy(ids[t][:, rank * 2:(rank + 1) * 2]).cuda()
        state, loss = step(state, {"input_ids": local})
        whole, rep, slices = hashlib.sha256(), hashlib.sha256(), True
        for name, p in state.model.named_parameters():
            p = p.detach()
            dim = lay.dims[name]
            full = p if dim is None else overlap.ring_all_gather(p, ring, dim)
            if dim is None:
                rep.update(p.cpu().numpy().tobytes())
            else:
                slices &= torch.equal(lay.take(name, full), p)
            whole.update(full.cpu().numpy().tobytes())
        steps.append({"whole": whole.hexdigest(), "rep": rep.hexdigest(),
                      "slices": bool(slices), "loss": float(loss)})
    moments_sharded = all(
        v.shape == p.shape for p in state.model.parameters()
        for k, v in state.optimizer.inner.state[p].items() if k != "step")
    with open(f"{out}-{rank}.json", "w") as f:
        json.dump({"rings_same": same, "steps": steps,
                   "moments_sharded": moments_sharded,
                   "sharded": len(lay.sharded()),
                   "launches": {k.name: k.launches for k in KERNELS}}, f)
finally:
    dist.destroy_process_group()
'''


def test_two_fsdp_ranks_on_one_card_hold_their_shards(cuda, tmp_path):
    script = tmp_path / "fsdp_rank.py"
    script.write_text(FSDP_RANK)
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         str(tmp_path / "out")], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        done = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, done):
        assert p.returncode == 0, err[-3000:]
    docs = [json.loads((tmp_path / f"out-{r}.json").read_text())
            for r in (0, 1)]
    for d in docs:
        assert d["rings_same"] and all(d["rings_same"])
        assert d["moments_sharded"] and d["sharded"] > 0
        assert all(s["slices"] for s in d["steps"])
    assert docs[0]["steps"] == docs[1]["steps"]
    layers, passes = 2, 2 * 2
    for d in docs:
        assert d["launches"] == {
            "flash_fwd": 2 * layers * passes,
            "flash_bwd_dq": layers * passes,
            "flash_bwd_dkv": layers * passes, "paged_decode": 0,
            "paged_decode_int8": 0}


TP_RANK = r'''
import dataclasses, hashlib, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, n, store, out = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    from move2kube_tpu_torch.models import llama
    from move2kube_tpu_torch.models import train as T
    from move2kube_tpu_torch.models.convert import init_llama
    from move2kube_tpu_torch.ops.attention import KERNELS, reset_launch_counts
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from move2kube_tpu_torch.parallel.sharding import gather_full, layout_of

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(MeshConfig(tensor=n), device="cuda")
    # Llama-8B's widths, one layer: 16 query and 4 KV heads a rank
    cfg = dataclasses.replace(llama.llama_8b(), num_layers=1, max_len=512,
                              attn_impl="flash")
    state = T.create_sharded_state(cfg, mesh, lambda ps: T.adamw(ps, 1e-4),
                                   seed=0, device="cuda")
    lay = layout_of(state.model)
    step = T.make_lm_train_step(grad_accum=2, mesh=mesh)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 1, 512))).cuda()
    reset_launch_counts()
    steps = []
    for t in range(2):
        state, loss = step(state, {"input_ids": ids[t]})
        whole, slices = hashlib.sha256(), True
        for name, p in state.model.named_parameters():
            full = gather_full(lay, name, p.detach(), mesh)
            slices &= torch.equal(lay.take(name, full), p.detach())
            whole.update(full.cpu().numpy().tobytes())
        steps.append({"whole": whole.hexdigest(), "slices": bool(slices),
                      "loss": float(loss)})
    launches = {k.name: k.launches for k in KERNELS}
    del state
    # one rank's whole tree on the same batch
    model = init_llama(cfg, seed=0, device="cuda", dtype=torch.float32)
    one = T.TrainState(model, T.adamw(model.parameters(), 1e-4))
    one_step = T.make_lm_train_step(grad_accum=2)
    one_losses = []
    for t in range(2):
        one, loss = one_step(one, {"input_ids": ids[t]})
        one_losses.append(float(loss))
    with open(f"{out}-{rank}.json", "w") as f:
        json.dump({"steps": steps, "one_losses": one_losses,
                   "cut": len(lay.sharded()), "launches": launches}, f)
finally:
    dist.destroy_process_group()
'''


def test_two_tensor_ranks_on_one_card_split_llama_8b_widths(cuda, tmp_path):
    """Item 9c: one layer of Llama-8B's widths at tensor=2 (the flash
    kernels on each rank's 16 query and 4 KV heads): each rank's parts
    are its slices of the gathered tree and the tree has one digest on
    both ranks after every step; the fp32 loss is one rank's within
    1e-5; the launches are the passes."""
    script = tmp_path / "tp_rank.py"
    script.write_text(TP_RANK)
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         str(tmp_path / "out")], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        done = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, done):
        assert p.returncode == 0, err[-3000:]
    docs = [json.loads((tmp_path / f"out-{r}.json").read_text())
            for r in (0, 1)]
    assert docs[0]["steps"] == docs[1]["steps"]
    for d in docs:
        assert d["cut"] > 0 and all(s["slices"] for s in d["steps"])
        for s, want in zip(d["steps"], d["one_losses"]):
            assert abs(s["loss"] - want) <= 1e-5 * abs(want), (s, want)
        layers, passes = 1, 2 * 2
        assert d["launches"] == {
            "flash_fwd": 2 * layers * passes,
            "flash_bwd_dq": layers * passes,
            "flash_bwd_dkv": layers * passes, "paged_decode": 0,
            "paged_decode_int8": 0}
