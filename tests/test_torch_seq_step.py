"""The port's sequence-parallel LM step (``models/train.py``'s
``seq_shard`` and loss weight, the models' ring, Ulysses and dense
attention over a seq group, ``models/moe.py``'s routing over the batch x
seq group) in gloo worlds of 2 and 4 on the CPU, against the JAX
package's one-device step over the global batch (the reference's
single-device math, as item 9 is held): two SGD steps from the flax init
on 4 rows of 32 tokens, each rank of a seq group holding the rows whole
and running its shard of their tokens.

Meshes: ``seq=2`` (the tiny Llama with ring, dense and flash attention,
the tiny GPT-2 with Ulysses and flash, the tiny MoE Llama at a capacity factor of
0.5 that drops tokens, routed over the global batch's tokens in their
order); ``data=2 x seq=2`` (GPT-2 with ring, ``grad_accum`` 1 and 2, and
the MoE) and ``fsdp=2 x seq=2`` (the Llama with Ulysses, ``grad_accum``
1 and 2: the fsdp reduce-scatter then the sum over seq). One world a
size runs every case of its meshes; the references are
``tests/test_torch_tp.py``'s, one JAX compile a family, vocab and
``grad_accum``.

Tolerances (fp32, ``tests/test_torch_tp.py``'s): the loss within 1e-5
relative, and each leaf's update within 1e-3 of the norm of the JAX
update; across ranks, after every step, the same bits.

The fsdp=2 x seq=2 Llama's state, saved after its steps, holds one
shard file an fsdp coordinate (the seq ranks hold copies) and reads back
whole as the ranks' tree. The BERT, ResNet and UNet steps refuse a seq
axis with
``NotImplementedError`` naming item 9d (the reference leaves them to
GSPMD).

The mutation check: a ``seq=2`` Llama run whose loss weight is patched
to 1 in its rank processes (each rank's loss the mean over its own
targets, the shard means averaged over the seq ranks) must fail the
loss gate: the last shard has one target fewer than the first.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread
import torch._dynamo  # noqa: E402,F401 - before any optimizer steps

from tests.test_torch_ring import (  # noqa: E402,F401
    World,
    _process_state_unchanged,
)
from tests.test_torch_tp import (  # noqa: E402
    CAPACITY_FACTOR,
    CHUNK,
    LOSS_REL,
    LR,
    UPDATE_REL,
    _batches,
    _dropped,
    _init,
    _jax_steps,
    _port_cfg,
)

MESHES = {"seq2": {"seq": 2}, "data2xseq2": {"data": 2, "seq": 2},
          "fsdp2xseq2": {"fsdp": 2, "seq": 2}}
# (mesh, family, vocab, grad_accum, attn_impl)
CASES = [("seq2", "llama", 512, 1, "ring"),
         ("seq2", "llama", 512, 1, "dense"),
         ("seq2", "llama", 512, 1, "flash"),
         ("seq2", "gpt2", 256, 1, "ulysses"),
         ("seq2", "gpt2", 256, 1, "flash"),
         ("seq2", "moe", 512, 1, "ring"),
         ("data2xseq2", "gpt2", 256, 1, "ring"),
         ("data2xseq2", "gpt2", 256, 2, "ring"),
         ("data2xseq2", "moe", 512, 1, "ring"),
         ("fsdp2xseq2", "llama", 512, 1, "ulysses"),
         ("fsdp2xseq2", "llama", 512, 2, "ulysses")]
MUTANT = ("seq2", "llama", 512, 1, "ring")
# its state is saved after the two steps
CKPT_CASE = ("fsdp2xseq2", "llama", 512, 1, "ulysses")


def _name(mesh, fam, vocab, k, impl, mutant=False) -> str:
    return (f"{mesh}-{fam}{vocab}-{impl}-accum{k}"
            + ("-shard-means" if mutant else ""))


WORKER = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, n, store, spec_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    from move2kube_tpu_torch.models import gpt2, llama
    from move2kube_tpu_torch.models import train as T
    from move2kube_tpu_torch.models.moe import MoEMlp
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from move2kube_tpu_torch.parallel.sharding import gather_full, layout_of

    spec = json.load(open(spec_path))
    data = np.load(spec["inputs"])
    out = {}
    weight = T.seq_loss_weight
    for case in spec["cases"]:
        fam, k, name = case["family"], case["grad_accum"], case["name"]
        extents = case["mesh"]
        mesh = make_mesh(MeshConfig(**extents), device="cpu")
        rows_n = extents.get("data", 1) * extents.get("fsdp", 1)
        # the ranks of one batch coordinate (the inner axes) take its rows
        coord = rank // (n // rows_n)
        # the mutant: each rank's loss the mean over its own targets
        T.seq_loss_weight = ((lambda n_targets, s, sp: 1.0)
                             if case["mutant"] else weight)
        if fam == "gpt2":
            cfg = dataclasses.replace(gpt2.gpt2_tiny(), dtype=torch.float32,
                                      vocab_size=case["vocab"],
                                      attn_impl=case["impl"])
        else:
            cfg = dataclasses.replace(llama.llama_tiny(), dtype=torch.float32,
                                      attn_impl=case["impl"],
                                      vocab_size=case["vocab"],
                                      moe_experts=4 if fam == "moe" else 0)
        full = {key[len(case["params"]):]: torch.from_numpy(data[key])
                for key in data.files if key.startswith(case["params"])}
        state = T.create_sharded_state(
            cfg, mesh, lambda ps: T.Optimizer(torch.optim.SGD(
                ps, lr=case["lr"])), device="cpu", params=full)
        for m in state.model.modules():
            if isinstance(m, MoEMlp):
                m.capacity_factor = case["capacity_factor"]
        step = T.make_lm_train_step(remat=True, grad_accum=k,
                                    chunk=case["chunk"], mesh=mesh)
        lay = layout_of(state.model)
        losses = []
        for t in range(2):
            a = data[f"{case['batches']}/batch{t}"]
            axis = 1 if k > 1 else 0
            per = a.shape[axis] // rows_n
            rows = slice(coord * per, (coord + 1) * per)
            a = a[:, rows] if axis else a[rows]
            state, loss = step(state, {"input_ids": torch.from_numpy(
                np.ascontiguousarray(a))})
            losses.append(float(loss))
            for key, p in state.model.named_parameters():
                whole = gather_full(lay, key, p.data, mesh)
                out[f"{name}/step{t}/sd/{key}"] = whole.numpy()
        out[f"{name}/losses"] = np.asarray(losses, np.float64)
        if case["ckpt"]:
            from move2kube_tpu_torch.models import checkpoint as C

            mgr = C.CheckpointManager(case["ckpt"], every=1)
            assert mgr.maybe_save(2, state, force=True)
            mgr.close()
    # the family steps refuse a seq axis before they touch their batch
    lin = torch.nn.Linear(2, 2)
    state = T.TrainState(lin, T.Optimizer(torch.optim.SGD(
        lin.parameters(), lr=0.1)))
    for fam, make in (("classifier", T.make_classifier_train_step),
                      ("bert", T.make_bert_train_step),
                      ("diffusion", T.make_diffusion_train_step)):
        if not spec["refusals"]:
            break
        try:
            make(mesh=make_mesh(MeshConfig(seq=n), device="cpu"))(state, {})
        except NotImplementedError as e:
            out[f"refusal/{fam}"] = np.asarray(str(e))
    np.savez(out_path, **out)
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def seq_steps(tmp_path_factory):
    """One world a size runs its meshes' cases while the JAX steps run
    here, once for each family, vocab and ``grad_accum``."""
    from move2kube_tpu_torch.models.convert import params_from_jax

    tmp = tmp_path_factory.mktemp("seqstep")
    mp = pytest.MonkeyPatch()
    inputs, inits, batches = {}, {}, {}
    specs = {2: [], 4: []}
    for case in CASES + [MUTANT + (True,)]:
        mesh, fam, vocab, k, impl = case[:5]
        key, bkey = f"{fam}-{vocab}", f"{fam}-{vocab}-{k}"
        if key not in inits:
            inits[key] = _init(fam, vocab)
            sd = params_from_jax(inits[key][1], _port_cfg(fam, vocab))
            for leaf, t in sd.items():
                inputs[f"{key}/init/{leaf}"] = t.numpy()
        if bkey not in batches:
            batches[bkey] = _batches(vocab, k, 10 * k + vocab % 7)
            for t, ids in enumerate(batches[bkey]):
                inputs[f"{bkey}/batch{t}"] = ids
        n = int(np.prod(list(MESHES[mesh].values())))
        specs[n].append({
            "name": _name(*case), "mesh": MESHES[mesh], "family": fam,
            "vocab": vocab, "grad_accum": k, "impl": impl,
            "mutant": len(case) > 5, "params": f"{key}/init/",
            "batches": bkey, "lr": LR, "chunk": CHUNK,
            "capacity_factor": CAPACITY_FACTOR,
            "ckpt": str(tmp / "ckpt") if case == CKPT_CASE else ""})
    np.savez(tmp / "seq.npz", **inputs)
    worlds = {}
    try:
        for n, cases in specs.items():
            worlds[n] = World(tmp, f"seq{n}", n, {
                "inputs": str(tmp / "seq.npz"), "cases": cases,
                "refusals": n == 2}, WORKER)
        refs = {}
        for bkey, bs in batches.items():
            fam, vocab, k = bkey.split("-")
            model, variables = inits[f"{fam}-{vocab}"]
            refs[bkey] = (_jax_steps(model, variables, int(k), bs, mp),
                          variables, bs)
        got = {}
        for w in worlds.values():
            for r, out in enumerate(w.outputs()):
                got.setdefault(r, {}).update(out)
        return got, refs, tmp / "ckpt"
    finally:
        mp.undo()
        for w in worlds.values():
            w.kill()


def _losses_hold(got, refs, case) -> bool:
    mesh, fam, vocab, k = case[:4]
    (jlosses, _), _, _ = refs[f"{fam}-{vocab}-{k}"]
    losses = got[0][f"{_name(*case)}/losses"]
    return all(abs(a - b) <= LOSS_REL * abs(b)
               for a, b in zip(losses, jlosses))


IDS = [_name(*c) for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_step_matches_the_jax_one_device_step(seq_steps, case):
    from move2kube_tpu_torch.models.convert import params_from_jax

    got, refs, _ = seq_steps
    mesh, fam, vocab, k, impl = case
    name = _name(*case)
    (jlosses, jparams), variables, batches = refs[f"{fam}-{vocab}-{k}"]
    assert _losses_hold(got, refs, case), (got[0][f"{name}/losses"],
                                           jlosses)
    cfg = _port_cfg(fam, vocab)
    ref = params_from_jax(jparams, cfg)
    init = params_from_jax(variables, cfg)
    for key, t in ref.items():
        mine = got[0][f"{name}/step1/sd/{key}"]
        upd = np.linalg.norm(t.numpy() - init[key].numpy())
        err = np.linalg.norm(mine - t.numpy()) / upd
        assert err < UPDATE_REL, (key, err)
    if fam == "moe":
        # the capacity drops tokens on the global batch
        first = batches[0] if k == 1 else batches[0][0]
        assert _dropped(variables, vocab, first) > 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_seq_ranks_end_every_step_with_one_tree(seq_steps, case):
    got, _, _ = seq_steps
    mesh = case[0]
    n = int(np.prod(list(MESHES[mesh].values())))
    name = _name(*case)
    for t in range(2):
        prefix = f"{name}/step{t}/sd/"
        keys = [key for key in got[0] if key.startswith(prefix)]
        assert keys
        for r in range(1, n):
            for key in keys:
                assert got[r][key].tobytes() == got[0][key].tobytes(), (
                    key, r)


def test_shard_means_averaged_over_seq_fail_the_loss_gate(seq_steps):
    """The wrong loss (each seq rank's mean over its own targets, the
    ranks' means averaged) is caught by the gate the right one passes."""
    got, refs, _ = seq_steps
    assert _losses_hold(got, refs, MUTANT)
    assert not _losses_hold(got, refs, MUTANT + (True,))


@pytest.mark.parametrize("fam", ["classifier", "bert", "diffusion"])
def test_family_steps_refuse_a_seq_axis_naming_9d(seq_steps, fam):
    """ResNet's, BERT's and the UNet's steps do not shard their inputs
    over a seq axis: they raise ``NotImplementedError`` naming item 9d,
    in a world of 2 at seq=2."""
    got, _, _ = seq_steps
    msg = str(got[0].get(f"refusal/{fam}", ""))
    assert "seq=2" in msg and "item 9d" in msg, msg


def test_fsdp_x_seq_checkpoint_holds_one_copy_of_each_shard(seq_steps):
    """On fsdp=2 x seq=2 the seq ranks hold copies of their fsdp shards:
    the step saved after training has one shard file an fsdp coordinate
    (2, not 4) beside rank 0's ``state.pt``, and reads back whole
    (``restore_variables``) as the ranks' gathered tree."""
    from move2kube_tpu_torch.models.checkpoint import restore_variables
    from move2kube_tpu_torch.models.llama import Llama

    got, _, ckpt = seq_steps
    step = ckpt / "2"
    assert sorted(p.name for p in step.iterdir()) == [
        "meta.json", "shard-0.pt", "shard-1.pt", "state.pt"]
    model = Llama(_port_cfg("llama", 512), device="cpu")
    back = restore_variables(str(ckpt), model.state_dict())
    name = _name(*CKPT_CASE)
    for key, t in back.items():
        assert t.numpy().tobytes() == got[0][
            f"{name}/step1/sd/{key}"].tobytes(), key
