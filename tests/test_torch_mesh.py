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
    ((1, 2, 1, 1, 1, 1), ["9b"]), ((2, 1, 2, 1, 1, 1), ["9e"]),
    ((1, 1, 1, 2, 2, 2), ["9c", "9d", "9c"]), ((8, 1, 1, 1, 1, 1), [])])
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
MEM_EXTENTS = {"data8": _ext(data=8), "fsdp2": _ext(fsdp=2),
               "fsdp64": _ext(fsdp=64)}
MEM_PAIRS = ([("llama3-8b", "fsdp64"), ("llama3-8b", "data8")]
             + [(m, e) for m in ("gpt2-small", "bert-base", "resnet50")
                for e in ("data8", "fsdp2")])


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


@pytest.mark.parametrize("dims,pure", [
    ((2, 1, 1, 1, 1, 1), True), ((1, 1, 1, 1, 1, 1), False),
    ((2, 2, 1, 1, 1, 1), False), ((4, 1, 1, 1, 1, 2), False)])
def test_is_pure_data_parallel(dims, pure):
    """The reference's rule (its own test fails on this JAX, ROADMAP.md):
    every device on ``data``, more than one."""
    from types import SimpleNamespace

    from move2kube_tpu_torch.parallel.overlap import is_pure_data_parallel

    mesh = SimpleNamespace(shape=dims, mesh_dim_names=tmesh.MeshConfig.AXES)
    assert is_pure_data_parallel(mesh) is pure
    assert is_pure_data_parallel(object()) is False
