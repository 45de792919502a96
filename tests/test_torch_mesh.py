"""The port's planner, memory plan and plan report
(``move2kube_tpu_torch/parallel/topology.py``, ``mesh.py``, ``memory.py``,
``sharding.py``, the plan report of ``obs/costmodel.py``) against the JAX
package's, on the reference's own cases. Pure functions: no process
group, no device.

- The planner: ``infer_mesh_config``, ``plan_parallelism`` and
  ``resolve_mesh_plan`` over ``tests/test_topology.py``'s cases. The
  extents, ``dcn_dp`` and ``source`` are the reference's; the port's
  device order is the identity and its layout empty (no torus to lay axes
  onto), so its plan line is the reference's with ``layout=[]``.
- The memory plan: Llama-3-8B at ``{fsdp: 64}`` and ``{data: 8}``
  (``tests/test_memory_plan.py``'s build), GPT-2 small, BERT-base and
  ResNet-50 at ``{data: 8}`` and ``{fsdp: 2}``: params, grads, optimizer
  state and activations equal to the byte, and every leaf's bytes under
  its flax name (the port's models built on the meta device, their names
  and ``Linear``/``Conv`` shapes mapped by ``convert.flax_params``).
- ``hbm_budget_bytes`` on every alias the reference accepts, and the
  H100 row from the port's cost model.
- FSDP's pure functions: ``is_pure_fsdp`` and ``fsdp_prefetch_mode`` on
  the reference's cases (``tests/test_crossentropy.py``), each leaf's
  sharded dimension (``overlap._fsdp_leaf_dims``) against the reference's
  on the tiny Llama, GPT-2 and BERT trees through the flax-to-port
  dimension map, and each rank's bytes of parameters and Adam moments
  after ``shard_params`` against the memory plan at ``{fsdp: 2}`` and
  ``{fsdp: 4}``, to the byte.
- The plan report: ``build_plan_report`` on the same memory and mesh plans
  gives the reference's keys and values, the chip rows apart (both sides
  budget on the same chip numbers here); ``render_plan_markdown`` and
  ``write_plan_report`` write the same files.
"""

import dataclasses
import json
import re

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import bert as jbert  # noqa: E402
from move2kube_tpu.models import gpt2 as jgpt2  # noqa: E402
from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.models import resnet as jresnet  # noqa: E402
from move2kube_tpu.obs import costmodel as jcost  # noqa: E402
from move2kube_tpu.parallel import memory as jmem  # noqa: E402
from move2kube_tpu.parallel import mesh as jmesh  # noqa: E402
from move2kube_tpu.parallel import topology as jtopo  # noqa: E402
from move2kube_tpu_torch.models import bert as tbert  # noqa: E402
from move2kube_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models import resnet as tresnet  # noqa: E402
from move2kube_tpu_torch.models.convert import meta_model  # noqa: E402
from move2kube_tpu_torch.obs import costmodel as tcost  # noqa: E402
from move2kube_tpu_torch.parallel import memory as tmem  # noqa: E402
from move2kube_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from move2kube_tpu_torch.parallel import topology as ttopo  # noqa: E402

# ------------------------------------------------------------- planner

# (n_devices, plan_parallelism keywords): tests/test_topology.py's cases
PLAN_CASES = [
    (1, {}),                                                  # single chip
    (8, {"topology": "2x4"}),                                 # 2x4 data
    (8, {"topology": "2x4", "zero_stage": 3}),                # ZeRO-3
    (8, {"topology": "2x4", "tensor_parallel": 2}),           # tensor 2
    (8, {"topology": "4x2", "tensor_parallel": 2}),
    (64, {"topology": "4x4x4", "zero_stage": 3, "tensor_parallel": 4}),
    (8, {"topology": "2x4", "slice_type": "tpu-v5-lite-podslice",
         "param_bytes": int(30e9)}),                          # memory split
    (8, {"topology": "2x2"}),                                 # mismatched
    (8, {"topology": "2xbanana"}),
    (16, {"topology": "2x4", "num_slices": 2}),               # multislice
    (16, {"topology": "2x4", "tensor_parallel": 2, "num_slices": 2}),
    (16, {"topology": "2x4", "slice_type": "tpu-v5-lite-podslice",
          "param_bytes": int(30e9), "num_slices": 2}),
    (8, {"topology": "2x4", "num_slices": 3}),                # indivisible
    (8, {"topology": "2x4", "seq_parallel": 2, "expert_parallel": 2,
         "pipeline_parallel": 2}),
    (6, {"tensor_parallel": 4}),                              # dropped
    (4, {"topology": "2x2", "slice_type": "nvidia-h100-80gb",
         "param_bytes": int(100e9)}),
]


def _same_plan(mine, ref):
    assert mine.config.dims() == ref.config.dims()
    assert mine.dcn_dp == ref.dcn_dp
    assert mine.source == ref.source
    assert (mine.topology is None) == (ref.topology is None)
    if ref.topology is not None:
        assert mine.topology.dims == ref.topology.dims
    n = mine.config.total()
    assert mine.perm == tuple(range(n)) and mine.layout == {}
    assert mine.describe() == re.sub(r"layout=\[[^\]]*\]", "layout=[]",
                                     ref.describe())


@pytest.mark.parametrize("n,kw", PLAN_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(PLAN_CASES)])
def test_plan_parallelism_matches_the_reference(n, kw):
    _same_plan(ttopo.plan_parallelism(n, **kw),
               jtopo.plan_parallelism(n, **kw))


@pytest.mark.parametrize("n,env,kw", [
    (8, {"M2KT_TPU_TOPOLOGY": "2x4"}, {}),
    (8, {"M2KT_MESH_DATA": "2", "M2KT_MESH_TENSOR": "4"},
     {"default_topology": "2x4"}),
    (8, {"M2KT_MESH_DATA": "4"}, {"default_topology": "2x4"}),
    (16, {"M2KT_TPU_TOPOLOGY": "2x4", "M2KT_NUM_SLICES": "2"}, {}),
    (8, {"M2KT_TPU_TOPOLOGY": "2x4", "M2KT_NUM_SLICES": "banana"}, {}),
    (1, {}, {"default_topology": "4x4x4", "zero_stage": 3}),
    (2, {"M2KT_NUM_SLICES": "2"}, {"default_topology": "2x4"}),
    (4, {"M2KT_MESH_DATA": "x"}, {}),
])
def test_resolve_mesh_plan_matches_the_reference(n, env, kw):
    _same_plan(ttopo.resolve_mesh_plan(n, env=env, **kw),
               jtopo.resolve_mesh_plan(n, env=env, **kw))


@pytest.mark.parametrize("n", [1, 2, 6, 8, 64])
@pytest.mark.parametrize("kw", [
    {}, {"zero_stage": 3}, {"tensor_parallel": 2}, {"seq_parallel": 4},
    {"pipeline_parallel": 2, "expert_parallel": 2}, {"tensor_parallel": 3},
])
def test_infer_mesh_config_matches_the_reference(n, kw):
    mine = tmesh.infer_mesh_config(n, **kw)
    assert mine.dims() == jmesh.infer_mesh_config(n, **kw).dims()
    assert tmesh.MeshConfig.AXES == jmesh.MeshConfig.AXES


def test_parse_topology_and_device_order():
    assert ttopo.parse_topology("4x4x4") == (4, 4, 4)
    for bad in ("", "0x4", "-2x4", "2xbanana", "x4"):
        with pytest.raises(ValueError):
            ttopo.parse_topology(bad)
    plan = ttopo.plan_parallelism(8, topology="2x4")
    assert plan.device_order(list("abcdefgh")) == list("abcdefgh")
    assert plan.device_order([1, 2]) == [1, 2]


def test_process_layout_from_the_jobset_env():
    """World and rank from the pod's env: hosts x slices x local ranks,
    rank = host index x local ranks + local rank; torchrun's env wins;
    forced CPU ranks are one pod."""
    lay = tmesh.process_layout({
        "M2KT_NUM_HOSTS": "2", "M2KT_NUM_SLICES": "2", "M2KT_SLICE_ID": "1",
        "JOB_COMPLETION_INDEX": "1", "M2KT_LOCAL_WORLD": "4",
        "M2KT_LOCAL_RANK": "3"})
    assert lay == tmesh.ProcessLayout(world=16, rank=15, local_world=4,
                                      local_rank=3, hosts=4, host=3)
    assert tmesh.process_layout({
        "WORLD_SIZE": "8", "RANK": "5", "LOCAL_WORLD_SIZE": "4",
        "LOCAL_RANK": "1", "M2KT_NUM_HOSTS": "9"}) == tmesh.ProcessLayout(
            8, 5, 4, 1, 2, 1)
    assert tmesh.process_layout({
        "M2KT_FORCE_DEVICES": "4", "M2KT_NUM_SLICES": "2",
        "M2KT_LOCAL_WORLD": "4", "M2KT_LOCAL_RANK": "2"}).world == 4
    assert tmesh.process_layout({}) == tmesh.ProcessLayout()
    with pytest.raises(ValueError, match="no rendezvous"):
        tmesh.check_rendezvous(tmesh.process_layout({"M2KT_NUM_HOSTS": "2"}),
                               {})
    assert tmesh.rendezvous({"M2KT_COORDINATOR": "h:1"}) == "tcp://h:1"
    assert tmesh.rendezvous({"MASTER_ADDR": "a", "MASTER_PORT": "2"}) == \
        "tcp://a:2"
    assert tmesh.rendezvous({"M2KT_LOCAL_STORE": "127.0.0.1:5"}) == \
        "tcp://127.0.0.1:5"


@pytest.mark.parametrize("dims,slices", [
    ((1, 2, 1, 1, 1, 1), []), ((2, 1, 2, 1, 1, 1), ["9e"]),
    ((1, 1, 1, 1, 2, 1), []), ((8, 1, 1, 1, 1, 1), []),
    ((1, 1, 1, 2, 1, 1), []), ((1, 1, 1, 1, 1, 2), []),
    ((1, 2, 1, 2, 1, 2), []), ((1, 1, 2, 2, 2, 2), ["9e"])])
def test_unported_axes_name_their_slice(dims, slices):
    cfg = tmesh.MeshConfig(*dims)
    if not slices:
        tmesh.check_ported_mesh(cfg)
        return
    with pytest.raises(NotImplementedError) as e:
        tmesh.check_ported_mesh(cfg)
    assert re.findall(r"item (9\w)", str(e.value)) == slices


# --------------------------------------------------------- memory plan

SEQ = 8192


def _llama3_8b(mod, dtype):
    return mod.LlamaConfig(
        vocab_size=128256, d_model=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, mlp_dim=14336, max_len=SEQ, rope_theta=500000.0,
        attn_impl="flash", dtype=dtype)


def _ext(**kw):
    return {**dict.fromkeys(tmesh.MeshConfig.AXES, 1), **kw}


MEM_CASES = {
    "llama3-8b": (lambda: (jllama.Llama(_llama3_8b(jllama, jnp.bfloat16)),
                           {"input_ids": jnp.zeros((1, SEQ), jnp.int32)}),
                  lambda: _llama3_8b(tllama, torch.bfloat16),
                  {"seq_len": SEQ, "d_model": 4096, "num_layers": 32,
                   "vocab_size": 128256}),
    "gpt2-small": (lambda: (jgpt2.GPT2(jgpt2.gpt2_small()),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)}),
                   tgpt2.gpt2_small,
                   {"seq_len": 1024, "d_model": 768, "num_layers": 12,
                    "vocab_size": 50257, "batch_per_chip": 8}),
    "bert-base": (lambda: (jbert.bert_base(),
                           {"input_ids": jnp.zeros((1, 8), jnp.int32)}),
                  tbert.bert_base, {}),
    "resnet50": (lambda: (jresnet.resnet50(),
                          {"x": jnp.zeros((1, 32, 32, 3)), "train": False}),
                 tresnet.resnet50, {}),
}
def _mixtral(mod, dtype):
    """Mixtral's widths (8 experts, top 2) cut to 2 layers."""
    return mod.LlamaConfig(
        vocab_size=32000, d_model=4096, num_layers=2, num_heads=32,
        num_kv_heads=8, mlp_dim=14336, max_len=4096, moe_experts=8,
        moe_top_k=2, attn_impl="flash", dtype=dtype)


MEM_CASES["mixtral-2l"] = (
    lambda: (jllama.Llama(_mixtral(jllama, jnp.bfloat16)),
             {"input_ids": jnp.zeros((1, 8), jnp.int32)}),
    lambda: _mixtral(tllama, torch.bfloat16),
    {"seq_len": 4096, "d_model": 4096, "num_layers": 2,
     "vocab_size": 32000})
MEM_EXTENTS = {"data8": _ext(data=8), "fsdp2": _ext(fsdp=2),
               "fsdp64": _ext(fsdp=64), "tensor2": _ext(tensor=2),
               "fsdp2xtensor2": _ext(fsdp=2, tensor=2),
               "expert2": _ext(expert=2),
               "fsdp2xtensor2xexpert4": _ext(fsdp=2, tensor=2, expert=4)}
# the tensor and expert cells: the gpt2-tp and llama-moe samples' axes
MEM_PAIRS = ([("llama3-8b", "fsdp64"), ("llama3-8b", "data8")]
             + [(m, e) for m in ("gpt2-small", "bert-base", "resnet50")
                for e in ("data8", "fsdp2")]
             + [("llama3-8b", "tensor2"), ("llama3-8b", "fsdp2xtensor2"),
                ("gpt2-small", "tensor2"), ("mixtral-2l", "expert2"),
                ("mixtral-2l", "fsdp2xtensor2xexpert4")])


def _plans(model, ext, top_n=5):
    jbuild, tcfg, kw = MEM_CASES[model]
    jmodel, sample = jbuild()
    ref = jmem.train_memory_plan(jmodel, sample, MEM_EXTENTS[ext],
                                 top_n=top_n, **kw)
    mine = tmem.train_memory_plan(meta_model(tcfg()), MEM_EXTENTS[ext],
                                  top_n=top_n, **kw)
    return mine, ref


@pytest.mark.parametrize("model,ext", MEM_PAIRS,
                         ids=[f"{m}-{e}" for m, e in MEM_PAIRS])
def test_train_memory_plan_matches_the_reference(model, ext):
    mine, ref = _plans(model, ext, top_n=10 ** 6)
    assert (mine.params, mine.grads, mine.opt_state, mine.activations) == (
        ref.params, ref.grads, ref.opt_state, ref.activations)
    assert mine.total == ref.total
    # every leaf, in flax's order, under its flax name
    assert mine.breakdown == ref.breakdown
    short, ref_short = _plans(model, ext)
    assert short.breakdown == ref_short.breakdown
    assert mine.fits("tpu-v5p-slice") == ref.fits("tpu-v5p-slice")


def test_meta_model_holds_no_memory_and_fp32_masters():
    model = meta_model(_llama3_8b(tllama, torch.bfloat16))
    assert {p.device.type for p in model.parameters()} == {"meta"}
    assert {p.dtype for p in model.parameters()} == {torch.float32}


ALIASES = ["tpu-v5-lite-podslice", "tpu-v5p-slice", "tpu-v4-podslice",
           "tpu-v6e-slice", "v5e", "v5litepod-8", "TPU v5p", "v5p-128",
           "tpu-v5-lite-device", "v4", "TPU v4", "v6e", "trillium",
           "TPU v6e", "v5lite", "tpuv5e", "", "unknown-accelerator",
           "a100"]


@pytest.mark.parametrize("acc", ALIASES)
def test_hbm_budget_bytes_matches_the_reference(acc):
    assert tmem.hbm_budget_bytes(acc) == jmem.hbm_budget_bytes(acc)


@pytest.mark.parametrize("acc", ["NVIDIA H100 80GB HBM3",
                                 "nvidia-h100-80gb", "h100", "H100-SXM"])
def test_hbm_budget_of_the_h100_is_the_cost_models_row(acc):
    row = tcost.CHIP_SPECS["nvidia-h100-80gb"].hbm_bytes
    assert tmem.hbm_budget_bytes(acc) == row == tmem.HBM_BYTES[
        "nvidia-h100-80gb"]
    for key in jmem.HBM_BYTES:
        assert tmem.HBM_BYTES[key] == jmem.HBM_BYTES[key]


# ---------------------------------------------------------- plan report

REPORT_CASES = [("gpt2-small", "data8", "tpu-v5-lite-podslice", 8),
                ("llama3-8b", "data8", "tpu-v5-lite-podslice", 8),
                ("llama3-8b", "fsdp64", "tpu-v5p-slice", 64)]


def _reports(monkeypatch, model, ext, acc, n, tmp_path):
    """Both reports on the same memory plans and mesh plans, the port's
    budgeting on the reference's chip row for ``acc``."""
    spec, assumed = jcost.chip_spec(acc)
    monkeypatch.setattr(tcost, "chip_spec", lambda a="": (
        tcost.ChipSpec(**dataclasses.asdict(spec)), assumed))
    mine_plan, ref_plan = _plans(model, ext)
    zero = 3 if ext == "fsdp64" else 0
    mine_mesh = ttopo.plan_parallelism(n, zero_stage=zero)
    ref_mesh = jtopo.plan_parallelism(n, zero_stage=zero)
    mine = tcost.build_plan_report(mine_plan, acc, mesh_plan=mine_mesh,
                                   n_devices=n)
    ref = jcost.build_plan_report(ref_plan, acc, mesh_plan=ref_mesh,
                                  n_devices=n)
    return mine, ref


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}/")
    return out


@pytest.mark.parametrize("model,ext,acc,n", REPORT_CASES,
                         ids=[f"{m}-{e}" for m, e, _, _ in REPORT_CASES])
def test_build_plan_report_matches_the_reference(monkeypatch, tmp_path,
                                                 model, ext, acc, n):
    mine, ref = _reports(monkeypatch, model, ext, acc, n, tmp_path)
    assert _keys(mine) == _keys(ref)
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in ("accelerator", "mesh")}
    assert strip(mine) == strip(ref)
    assert mine["mesh"]["describe"] == re.sub(
        r"layout=\[[^\]]*\]", "layout=[]", ref["mesh"]["describe"])
    assert {k: v for k, v in mine["mesh"].items() if k != "describe"} == {
        k: v for k, v in ref["mesh"].items() if k != "describe"}
    assert mine["schema"] == "m2kt-plan-report/v1"
    # the chip rows: the same numbers here, the port's resolution of the
    # name (an H100's, where the reference knows TPU names)
    assert {k: v for k, v in mine["accelerator"].items()
            if k != "resolved"} == {k: v for k, v in ref[
                "accelerator"].items() if k != "resolved"}


@pytest.mark.parametrize("model,ext,acc,n", REPORT_CASES,
                         ids=[f"{m}-{e}" for m, e, _, _ in REPORT_CASES])
def test_render_and_write_plan_report_as_the_reference(
        monkeypatch, tmp_path, capsys, model, ext, acc, n):
    mine, ref = _reports(monkeypatch, model, ext, acc, n, tmp_path)
    mine_md = tcost.render_plan_markdown(mine)
    ref_md = jcost.render_plan_markdown(ref)
    assert mine_md == re.sub(r"layout=\[[^\]]*\]", "layout=[]", ref_md)
    monkeypatch.delenv("M2KT_PLAN_REPORT_STRICT", raising=False)
    paths = tcost.write_plan_report(mine, str(tmp_path / "port"))
    ref_paths = jcost.write_plan_report(ref, str(tmp_path / "jax"))
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        p.rsplit("/", 1)[1] for p in ref_paths] == [
        "m2kt-plan-report.json", "m2kt-plan-report.md"]
    assert json.loads(open(paths[0]).read()) == mine
    assert open(paths[1]).read() == mine_md
    err = capsys.readouterr().err
    if mine["verdict"] == "over-budget":
        assert "exceeds" in err and mine["suggestion"] == ref["suggestion"]
        with pytest.raises(SystemExit):
            tcost.write_plan_report(mine, str(tmp_path / "strict"),
                                    strict=True)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "m2kt-plan-report.json", "m2kt-plan-report.md"]


def test_plan_report_dir_and_the_h100_budget(monkeypatch, tmp_path):
    monkeypatch.delenv("M2KT_PLAN_REPORT", raising=False)
    assert tcost.plan_report_dir() is None
    assert tcost.write_plan_report({"verdict": "fit"}) is None
    monkeypatch.setenv("M2KT_PLAN_REPORT", "1")
    monkeypatch.setenv("M2KT_METRICS_DIR", str(tmp_path))
    assert tcost.plan_report_dir() == str(tmp_path)
    monkeypatch.setenv("M2KT_PLAN_REPORT", str(tmp_path / "x"))
    assert tcost.plan_report_dir() == str(tmp_path / "x")
    plan, _ = _plans("gpt2-small", "data8")
    rep = tcost.build_plan_report(plan, "NVIDIA H100 80GB HBM3")
    assert rep["accelerator"]["chip"] == "h100-sxm"
    assert not rep["accelerator"]["assumed_default"]
    assert rep["fit"]["budget_bytes"] == int(80e9 * 0.9)
    assert rep["verdict"] == "fit" and "suggestion" not in rep


# ---------------------------------------------------------------- fsdp

FSDP_PURE = [((1, 8, 1, 1, 1, 1), True), ((8, 1, 1, 1, 1, 1), False),
             ((2, 4, 1, 1, 1, 1), False), ((1, 4, 1, 2, 1, 1), False),
             ((1, 1, 1, 1, 1, 1), False)]


@pytest.mark.parametrize("dims,pure", FSDP_PURE)
def test_is_pure_fsdp_matches_the_reference(dims, pure):
    """``tests/test_crossentropy.py::test_is_pure_fsdp_cases`` (which
    fails on this JAX's ``AbstractMesh``), on a mesh with a ``shape``."""
    from types import SimpleNamespace

    from move2kube_tpu.parallel.overlap import is_pure_fsdp as jpure
    from move2kube_tpu_torch.parallel.overlap import is_pure_fsdp

    mesh = SimpleNamespace(shape=dims, mesh_dim_names=tmesh.MeshConfig.AXES)
    ref = jpure(SimpleNamespace(shape=dict(zip(tmesh.MeshConfig.AXES,
                                               dims))))
    assert is_pure_fsdp(mesh) is ref is pure
    assert is_pure_fsdp(object()) is jpure(object()) is False


def test_fsdp_prefetch_mode_spellings_match_the_reference(monkeypatch):
    from move2kube_tpu.parallel.overlap import fsdp_prefetch_mode as jmode
    from move2kube_tpu_torch.parallel.overlap import fsdp_prefetch_mode

    monkeypatch.delenv("M2KT_FSDP_PREFETCH", raising=False)
    assert fsdp_prefetch_mode() == jmode() == "auto"
    for raw, want in (("on", "on"), ("1", "on"), ("TRUE", "on"),
                      ("off", "off"), ("0", "off"), ("FALSE", "off"),
                      (" Off ", "off"), ("banana", "auto"), ("", "auto")):
        monkeypatch.setenv("M2KT_FSDP_PREFETCH", raw)
        assert fsdp_prefetch_mode() == jmode() == want, raw


def _tiny(fam):
    """(the flax model and its init args, the port's config) of a tiny
    family member."""
    ids = jnp.zeros((1, 8), jnp.int32)
    if fam == "llama":
        return (jllama.Llama(jllama.llama_tiny()), (ids,),
                dataclasses.replace(tllama.llama_tiny(),
                                    dtype=torch.float32))
    if fam == "gpt2":
        return (jgpt2.GPT2(jgpt2.gpt2_tiny()), (ids,),
                dataclasses.replace(tgpt2.gpt2_tiny(), dtype=torch.float32))
    return (jbert.bert_tiny(), (ids, jnp.ones((1, 8), bool)),
            tbert.bert_tiny(dtype=torch.float32))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fam", ["llama", "gpt2", "bert"])
def test_fsdp_leaf_dims_match_the_reference(fam, n):
    """Each leaf's sharded dimension is the reference's, mapped from
    flax's dimension to the port's (a ``Linear`` weight is the transpose
    of flax's kernel)."""
    from move2kube_tpu.parallel.overlap import _fsdp_leaf_dims as jdims
    from move2kube_tpu_torch.models.convert import flax_layout
    from move2kube_tpu_torch.parallel.overlap import _fsdp_leaf_dims

    fmodel, args, cfg = _tiny(fam)
    params = jax.eval_shape(lambda: fmodel.init(jax.random.PRNGKey(0),
                                                *args))["params"]
    _, _, dims = jdims(params, n, "fsdp")
    paths = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    ref = dict(zip(paths, dims))
    model = meta_model(cfg)
    mine = _fsdp_leaf_dims(model, n)
    layout = flax_layout(model)
    assert sorted(path for path, _, _ in layout.values()) == sorted(ref)
    sharded = 0
    for name, (path, shape, order) in layout.items():
        want = None if ref[path] is None else order[ref[path]]
        assert mine[name] == want, (name, path, mine[name], ref[path])
        sharded += want is not None
    assert sharded


class _OneRank:
    """What ``shard_params`` reads of a ``DeviceMesh``: its extents and
    this rank's coordinates."""

    def __init__(self, extents: dict, coords: dict) -> None:
        self.extents, self.coords = extents, coords

    def size(self, i: int) -> int:
        return self.extents.get(tmesh.MeshConfig.AXES[i], 1)

    def get_local_rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fam", ["llama", "gpt2", "bert"])
def test_shard_bytes_equal_the_memory_plan(fam, n):
    """Every rank of ``{fsdp: n}`` holds exactly the plan's per-device
    ``params`` and, after an AdamW step, ``opt_state``; the shards of the
    ranks together are the whole tree."""
    from move2kube_tpu_torch.models import train as ttrain
    from move2kube_tpu_torch.models.convert import init_family, init_llama
    from move2kube_tpu_torch.models.convert import init_gpt2
    from move2kube_tpu_torch.parallel.sharding import shard_params

    _, _, cfg = _tiny(fam)
    plan = tmem.train_memory_plan(meta_model(cfg), _ext(fsdp=n))
    whole = None
    for r in range(n):
        if fam == "llama":
            model = init_llama(cfg, device="cpu", dtype=torch.float32)
        elif fam == "gpt2":
            model = init_gpt2(cfg, device="cpu", dtype=torch.float32)
        else:
            model = init_family(cfg, device="cpu")
        full = {k: v.clone() for k, v in model.named_parameters()}
        layout = shard_params(model, _OneRank(_ext(fsdp=n), {"fsdp": r}))
        params = list(model.parameters())
        assert sum(p.numel() * p.element_size() for p in params) == \
            plan.params
        for name, p in model.named_parameters():
            assert torch.equal(p.detach(), layout.take(name, full[name]))
        opt = ttrain.adamw(params, 1e-3, 0.1)
        for p in params:
            p.grad = torch.zeros_like(p)
        opt.inner.step()
        moments = sum(v.numel() * v.element_size()
                      for slots in opt.inner.state.values()
                      for k, v in slots.items() if k != "step")
        assert moments == plan.opt_state
        whole = full
    assert sum(t.numel() * t.element_size() for t in whole.values()) > \
        plan.params


@pytest.mark.parametrize("prefetched,accum,dtype", [
    (True, 1, torch.float32), (True, 2, torch.float32),
    (False, 2, torch.float32), (True, 2, torch.bfloat16)])
def test_fsdp_transient_bytes_count_the_schedules_holdings(prefetched, accum,
                                                           dtype):
    """The bytes a rank holds beyond the plan while a step runs, counted
    from the tiny Llama's own tensors at fsdp=2: the gathered sharded
    leaves, the whole tree's compute-dtype copy, and one or two trees of
    the sharded leaves' full gradients (prefetched) or the largest one
    (sequential)."""
    from move2kube_tpu_torch.models.convert import init_llama
    from move2kube_tpu_torch.parallel.overlap import fsdp_transient_bytes
    from move2kube_tpu_torch.parallel.sharding import shard_params

    _, _, cfg = _tiny("llama")
    model = init_llama(cfg, device="cpu", dtype=torch.float32)
    whole = {k: v.numel() * 4 for k, v in model.named_parameters()}
    layout = shard_params(model, _OneRank(_ext(fsdp=2), {"fsdp": 0}))
    sharded = [whole[k] for k in layout.sharded()]
    got = fsdp_transient_bytes(layout, prefetched, accum, dtype)
    assert got["gathered_params_bytes"] == sum(sharded)
    assert got["cast_params_bytes"] == (
        0 if dtype == torch.float32 else sum(whole.values()) // 2)
    assert got["full_grads_bytes"] == (
        sum(sharded) * (2 if accum > 1 else 1) if prefetched
        else max(sharded))
    assert got["schedule"] == ("prefetched" if prefetched else "sequential")


# ------------------------------------------------ two-axis layouts (9c)

def _tiny_specs(fam, extents):
    from move2kube_tpu_torch.parallel.sharding import leaf_cuts, param_specs

    cfg = (tllama.llama_tiny() if fam == "llama" else
           dataclasses.replace(tllama.llama_tiny(), moe_experts=4)
           if fam == "moe" else tgpt2.gpt2_tiny())
    model = meta_model(cfg)
    specs = param_specs(model, extents)
    return cfg, specs, leaf_cuts(specs, extents, cfg)


@pytest.mark.parametrize("fam,leaf,blocks", [
    ("llama", "layers.0.qkv.weight", (128, 64, 64)),
    ("llama", "layers.0.gate_up.weight", (256, 256)),
    ("gpt2", "h.0.c_attn.weight", (64, 64, 64))])
def test_a_tensor_rank_holds_its_heads_of_a_fused_leaf(fam, leaf, blocks):
    """Each tensor rank's rows of a fused projection are its slice of
    each block (its query and KV heads, its gate and up columns), as
    many as the reference's contiguous cut; the parts put back together
    are the leaf."""
    from move2kube_tpu_torch.parallel.sharding import place_cuts, take_cuts

    _, specs, cuts = _tiny_specs(fam, _ext(tensor=2, fsdp=2))
    shape = specs[leaf].shape
    assert [c.axis for c in cuts[leaf]] == ["tensor", "fsdp"]
    assert cuts[leaf][0].blocks == blocks and cuts[leaf][0].dim == 0
    full = torch.arange(float(shape[0] * shape[1])).reshape(shape)
    back = torch.zeros_like(full)
    for t in range(2):
        for f in range(2):
            coords = {"tensor": t, "fsdp": f}
            part = take_cuts(full, cuts[leaf], coords)
            assert part.numel() * 4 == full.numel()
            rows, off = [], 0
            for b in blocks:
                rows += list(range(off + t * b // 2, off + (t + 1) * b // 2))
                off += b
            cols = slice(f * shape[1] // 2, (f + 1) * shape[1] // 2)
            assert torch.equal(part, full[rows][:, cols])
            place_cuts(back, part, cuts[leaf], coords)
    assert torch.equal(back, full)


@pytest.mark.parametrize("fam,extents,cut", [
    ("llama", _ext(tensor=2), {"embed.weight": ["tensor"],
                               "lm_head.weight": ["tensor"],
                               "layers.0.down.weight": [],
                               "layers.0.attn_out.weight": ["tensor"]}),
    ("gpt2", _ext(tensor=2), {"wte.weight": ["tensor"],
                              "wpe.weight": ["tensor"],
                              "h.0.c_attn.bias": [],
                              "h.0.mlp_out.weight": ["tensor"]}),
    ("moe", _ext(tensor=2, expert=2), {
        "layers.0.moe.w_in": ["expert", "tensor"],
        "layers.0.moe.w_out": ["expert", "tensor"],
        "layers.0.moe.router.weight": []})])
def test_the_rules_cut_each_leaf_over_its_axes(fam, extents, cut):
    _, _, cuts = _tiny_specs(fam, extents)
    for leaf, axes in cut.items():
        assert [c.axis for c in cuts[leaf]] == axes, leaf


@pytest.mark.parametrize("extents,match", [
    (_ext(tensor=4), "num_kv_heads=2"), (_ext(tensor=3), "num_heads=4"),
    (_ext(expert=3), "moe_experts=4")])
def test_an_extent_that_does_not_divide_the_model_is_refused(extents,
                                                             match):
    from move2kube_tpu_torch.parallel.sharding import check_model_parallel

    cfg = dataclasses.replace(tllama.llama_tiny(), moe_experts=4)
    with pytest.raises(ValueError, match=match):
        check_model_parallel(cfg, extents)
