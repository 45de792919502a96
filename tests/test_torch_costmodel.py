"""The port's step cost model against the JAX package's
(``move2kube_tpu/obs/costmodel.py``): the card's spec resolution, the
roofline/MFU arithmetic and the gauges on the same numbers, the FLOP
count of a tiny Llama's forward and train step against an analytic count
of its matmuls and against XLA's ``cost_analysis``, a counted step that
leaves the train state as it was, ``cost_report`` called mid-run, and
the ``<flight>.mem`` sidecar.

Env knobs are set through ``monkeypatch`` only and point under
``tmp_path``; every test builds its own registry, and an exit hook is
captured by a stand-in for ``threading._register_atexit``, never left
installed.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.obs import costmodel as jcost  # noqa: E402
from move2kube_tpu.obs import metrics as jmetrics  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs import costmodel as tcost  # noqa: E402
from move2kube_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from move2kube_tpu_torch.obs import tracing as ttracing  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402

H100 = "nvidia-h100-80gb"
# XLA's cost_analysis also counts elementwise work (norms, rotary
# embedding, softmax, SiLU: one FLOP an element each) beside the
# matmuls FlopCounterMode counts; at llama_tiny's widths (d_model 128,
# 2 x 16 tokens) that adds 1.1 % to the forward on the CPU
XLA_EXTRA_REL = 0.02
CHUNK = 128


@pytest.mark.parametrize("alias,canon", [
    ("nvidia-h100-80gb", H100),
    ("NVIDIA H100 80GB HBM3", H100),
    ("h100", H100),
    ("H100-SXM", H100),
    ("nvidia-h100-80gb-8", H100),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("tpu-v5-lite-podslice", None),
    ("", None),
    ("a100", None),
])
def test_normalize_accelerator(alias, canon):
    assert tcost.normalize_accelerator(alias) == canon


def test_chip_spec_resolution(monkeypatch):
    monkeypatch.delenv(tcost.ACCELERATOR_ENV, raising=False)
    spec, assumed = tcost.chip_spec(H100)
    assert not assumed and spec == tcost.CHIP_SPECS[H100]
    assert (spec.peak_bf16_flops, spec.peak_int8_flops, spec.hbm_bytes,
            spec.hbm_bandwidth) == (989e12, 1979e12, 80e9, 3.35e12)
    assert set(tcost.CHIP_SPECS) == {H100}
    spec, assumed = tcost.chip_spec("tpu-v4-podslice")
    assert assumed and spec is tcost.CHIP_SPECS[tcost.DEFAULT_CHIP]
    monkeypatch.setenv(tcost.ACCELERATOR_ENV, "NVIDIA H100 80GB HBM3")
    assert tcost.chip_spec() == (spec, False)
    monkeypatch.delenv(tcost.ACCELERATOR_ENV)
    # no string: the card's name when there is one, else the assumed row
    assert tcost.chip_spec()[1] is (not torch.cuda.is_available())


def _spec_pair():
    t = tcost.CHIP_SPECS[H100]
    return t, jcost.ChipSpec(t.name, t.peak_bf16_flops, t.peak_int8_flops,
                             t.hbm_bytes, t.hbm_bandwidth)


@pytest.mark.parametrize("flops,nbytes,memory", [
    (1e12, 1e9, {"args": 10, "temps": 5}),
    (2e9, 1e9, {}),
    (None, 1e9, {"args": 3}),
    (1e12, None, {}),
    (0.0, 0.0, {}),
])
def test_cost_report_arithmetic_matches_reference(flops, nbytes, memory):
    tspec, jspec = _spec_pair()
    ours = tcost.CostReport(flops, nbytes, dict(memory))
    theirs = jcost.CostReport(flops, nbytes, dict(memory))
    assert ours.to_dict() == theirs.to_dict()
    assert ours.roofline(tspec) == theirs.roofline(jspec)
    assert ours.mfu_ceiling(tspec) == theirs.mfu_ceiling(jspec)
    for seconds in (None, 0.0, 0.01, 2.5):
        for int8 in (False, True):
            assert ours.mfu(seconds, tspec, int8) == theirs.mfu(
                seconds, jspec, int8)


def test_gauges_render_as_the_reference_renders(monkeypatch):
    """Both sides resolve the same H100 row (added to the reference's
    table for the test) and render the same text."""
    tspec, jspec = _spec_pair()
    monkeypatch.setitem(jcost.CHIP_SPECS, H100, jspec)
    for report_t, report_j in (
            (tcost.CostReport(3e12, 2e10, {"args": 7, "temps": 9}),
             jcost.CostReport(3e12, 2e10, {"args": 7, "temps": 9})),
            (tcost.CostReport(None, None, {}),
             jcost.CostReport(None, None, {}))):
        treg, jreg = tmetrics.Registry(), jmetrics.Registry()
        assert tcost.export_train_gauges(
            report_t, treg, accelerator=H100, step_seconds=0.4) == (
            jcost.export_train_gauges(report_j, jreg, accelerator=H100,
                                      step_seconds=0.4))
        assert treg.render() == jreg.render()
    reports_t = {"prefill_32": tcost.CostReport(5e9, 1e8, {"args": 1}),
                 "decode": tcost.CostReport(1e8, 4e8, {"temps": 2}),
                 "verify": tcost.CostReport(3e8, 4e8, {})}
    reports_j = {k: jcost.CostReport(r.flops, r.bytes_accessed,
                                     dict(r.memory))
                 for k, r in reports_t.items()}
    for quant in ("off", "int8-kv"):
        treg, jreg = tmetrics.Registry(), jmetrics.Registry()
        tcost.export_serving_gauges(reports_t, treg, accelerator=H100,
                                    decode_step_seconds=0.02, quant=quant)
        jcost.export_serving_gauges(reports_j, jreg, accelerator=H100,
                                    decode_step_seconds=0.02, quant=quant)
        assert treg.render() == jreg.render()
    treg, jreg = tmetrics.Registry(), jmetrics.Registry()
    assert tcost.export_drift_gauge(3.0, 2.0, treg) == (
        jcost.export_drift_gauge(3.0, 2.0, jreg))
    assert tcost.export_drift_gauge(None, 2.0, treg) is (
        jcost.export_drift_gauge(None, 2.0, jreg)) is None
    assert treg.render() == jreg.render()


def _matmul_flops(cfg, b, s):
    """(forward FLOPs of one layer's four projections, its attention's
    forward FLOPs) at ``[b, s]`` tokens."""
    t, d, hd = b * s, cfg.d_model, cfg.d_model // cfg.num_heads
    q, kv, m = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.mlp_dim
    proj = {"qkv": 2 * t * d * (q + 2 * kv), "attn_out": 2 * t * q * d,
            "gate_up": 2 * t * d * 2 * m, "down": 2 * t * m * d}
    return proj, 4 * b * cfg.num_heads * s * s * hd


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash")
    fmodel = jllama.Llama(jcfg)
    ids = np.random.default_rng(0).integers(0, 512, (2, 16))
    variables = jax.device_get(fmodel.init(jax.random.PRNGKey(0),
                                           jnp.asarray(ids)))
    return fmodel, variables, ids


def _port_model(variables):
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                              attn_impl="flash")
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables["params"], cfg))
    return model


def test_forward_flops_match_matmuls_and_xla(tiny):
    fmodel, variables, ids = tiny
    model = _port_model(variables)
    cfg, (b, s) = model.cfg, ids.shape
    proj, attn = _matmul_flops(cfg, b, s)
    want = (cfg.num_layers * (sum(proj.values()) + attn)
            + 2 * b * s * cfg.d_model * cfg.vocab_size)
    with torch.no_grad():
        _, report = tcost.count_cost(model, torch.from_numpy(ids))
    assert report.flops == want
    assert report.memory == {} and report.peak_hbm_bytes is None
    assert report.bytes_accessed > 0
    compiled = jax.jit(fmodel.apply).lower(
        variables, jnp.asarray(ids)).compile()
    xla = jcost.analyze_compiled(compiled).flops
    assert 0.0 <= xla / report.flops - 1.0 <= XLA_EXTRA_REL


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_flops_match_matmuls_and_leave_the_state(tiny, remat):
    """A counted step: the four projections forward and twice backward,
    the flash forward (4 units) and its plain backward (10: P recomputed,
    dO.V^T, dq, dk, dv), and the head folded into the chunked CE over the
    ``s - 1`` shifted positions (forward, then the backward's recompute,
    dh and dW). Under ``remat`` each block's forward runs again in the
    backward, up to the last tensor the backward needs (torch's
    checkpoint stops early: the down projection is not recomputed). The
    state comes out as it went in."""
    _, variables, ids = tiny
    model = _port_model(variables)
    cfg, (b, s) = model.cfg, ids.shape
    opt = ttrain.instrument_optimizer(ttrain.adamw(model.parameters(),
                                                   1e-3, 0.1))
    state = ttrain.TrainState(model, opt)
    step = ttrain.make_lm_train_step(remat=remat, chunk=CHUNK)
    batch = {"input_ids": torch.from_numpy(ids)}
    state, _ = step(state, batch)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = [t.clone() for st in opt.inner.state.values()
               for t in st.values()]
    health = [t.clone() for t in opt.health]
    norm = opt.grad_norm.clone()
    report = tcost.analyze_step_fn(step, state, batch)
    proj, attn = _matmul_flops(cfg, b, s)
    lin = sum(proj.values())
    n = b * (s - 1)
    want = (cfg.num_layers * (3 * lin + attn + attn * 10 // 4)
            + 8 * n * cfg.d_model * cfg.vocab_size)
    if remat:
        want += cfg.num_layers * (lin - proj["down"] + attn)
    assert report.flops == want
    assert state.step == 1 and opt.count == 1
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name
    assert all(torch.equal(a, b_) for a, b_ in zip(
        moments, [t for st in opt.inner.state.values()
                  for t in st.values()]))
    assert all(torch.equal(a, b_) for a, b_ in zip(health, opt.health))
    assert torch.equal(norm, opt.grad_norm)


def _engine(model, **kw):
    econf = tengine.EngineConfig(max_batch=2, max_seq=64, block_size=8,
                                 buckets=(16, 32), **kw)
    eng = tengine.ServingEngine(model, econf, device="cpu",
                                tracer=ttracing.SpanRecorder())
    eng.capture_logits = True
    return eng


_COST_FAMILIES = ("m2kt_serve_roofline_bound", "m2kt_serve_step_flops",
                  "m2kt_serve_hbm_peak_bytes", "m2kt_serve_mfu")


def _live(eng):
    """Everything of the engine a cost pass must not touch."""
    cache = {k: ([t.clone() for t in v] if isinstance(v, list)
                 else v.clone()) for k, v in eng._cache.items()}
    alloc = eng._allocator
    text = [line for line in eng.registry.render().splitlines()
            if not any(f in line for f in _COST_FAMILIES)]
    return (cache, list(alloc._free), dict(alloc._refs), eng.stats(),
            text, {r: [x.copy() for x in rows]
                   for r, rows in eng.logit_log.items()})


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("kw", [{}, {"spec_k": 2},
                                {"quant": "int8-kv"}],
                         ids=["plain", "spec", "int8-kv"])
def test_cost_report_mid_run_leaves_the_engine_alone(tiny, kw):
    _, variables, _ = tiny
    model = _port_model(variables).eval()
    rng = np.random.default_rng(4)
    reqs = [tengine.Request(f"r{i}", rng.integers(1, 512, size=n).tolist(),
                            10) for i, n in enumerate((11, 23))]
    base = _engine(model, **kw)
    want = {c.rid: c.tokens for c in base.run(reqs)}
    eng = _engine(model, **kw)
    # the null page is garbage the paged kernels read masked
    for pool in eng._cache["k"]:
        pool[0].fill_(float("nan") if pool.is_floating_point() else 99)
    for r in reqs:
        eng.submit(r)
    done = eng.step() + eng.step()
    # a first stats() read creates the dispatch-gap histogram's series
    # (spec steps observe none), which the registry renders from then on
    eng.stats()
    before = _live(eng)
    report = eng.cost_report(accelerator=H100)
    assert _same(_live(eng), before)
    names = {f"prefill_{b}" for b in eng.buckets} | {"decode"} | (
        {"verify"} if kw.get("spec_k") else set())
    assert "prefill_16" in names
    assert set(report) == names
    for entry in report.values():
        assert entry["flops"] > 0 and entry["roofline"] in (
            "compute", "bandwidth")
    assert report["decode"]["achieved_mfu"] > 0
    text = eng.registry.render()
    assert all(f in text for f in _COST_FAMILIES)
    while eng.has_work():
        done += eng.step()
    assert {c.rid: c.tokens for c in done} == want
    for rid in want:
        assert _same(eng.logit_log[rid], base.logit_log[rid])
    assert eng.stats()["passes"] == base.stats()["passes"]


def test_memory_snapshot_sidecar(tmp_path, monkeypatch):
    monkeypatch.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "f.json"))
    monkeypatch.setattr(tcost, "_latest_memory", {})
    assert tcost.mem_snapshot_path() == jcost.mem_snapshot_path() == str(
        tmp_path / "f.json.mem")
    tcost.note_memory_report(tcost.CostReport(1.0, 1.0, {}))
    assert tcost._latest_memory == {}
    tcost.note_memory_report(tcost.CostReport(
        1.0, 1.0, {"args": 100, "temps": 28}))
    hooks = []
    monkeypatch.setattr(threading, "_register_atexit", hooks.append)
    monkeypatch.setattr(tcost, "_mem_flush_installed", False)
    tcost.install_memory_snapshot()
    tcost.install_memory_snapshot()
    assert len(hooks) == 1
    hooks[0]()
    import json

    doc = json.loads((tmp_path / "f.json.mem").read_text())
    assert {"memory_analysis", "peak_hbm_bytes", "live_buffers",
            "written_unix", "pid"} <= set(doc)
    assert doc["memory_analysis"] == {"args": 100, "temps": 28}
    assert doc["peak_hbm_bytes"] == 128
    # no card here: the allocator has nothing to list
    assert doc["live_buffers"] == (tcost.live_buffer_summary())


@pytest.mark.parametrize("b,s,sk,h,kvh,d", [(2, 5, 5, 4, 2, 8),
                                            (1, 7, 12, 6, 6, 16),
                                            (3, 4, 9, 8, 2, 4)])
def test_kernel_flop_formulas_equal_the_plain_versions_counts(
        b, s, sk, h, kvh, d):
    """What each CUDA wrapper adds to a count is what FlopCounterMode
    counts for its plain version on the same shapes, so the card and the
    CPU report one total for one step."""
    from move2kube_tpu_torch.ops import attention as tatt

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, h, d, generator=gen)
    k, v = (torch.randn(b, sk, kvh, d, generator=gen) for _ in range(2))
    g = torch.randn(b, s, h, d, generator=gen)
    (o, lse), fwd = tcost.count_cost(tatt.reference_attention_lse, q, k, v,
                                     False, 0.5)
    _, bwd = tcost.count_cost(tatt.flash_attention_bwd_reference, q, k, v,
                              o, lse, g, False, 0.5)
    assert fwd.flops == tatt.flash_fwd_flops(b, s, sk, h, d)
    assert bwd.flops == sum(tatt.flash_bwd_flops(b, s, sk, h, d))
    bs, mb = 8, 3
    qd = torch.randn(b, h, d, generator=gen)
    pages = torch.randn(1 + b * mb, bs, kvh, d, generator=gen)
    bt = torch.arange(1, 1 + b * mb, dtype=torch.int32).reshape(b, mb)
    lens = torch.full((b,), 5, dtype=torch.int32)
    _, paged = tcost.count_cost(tatt.paged_decode_reference, qd, pages,
                                pages, bt, lens, 0.5)
    q8, scale = tatt.quantize_kv_rows(pages)
    _, paged8 = tcost.count_cost(tatt.paged_decode_int8_reference, qd, q8,
                                 q8, scale, scale, bt, lens, 0.5)
    want = tatt.paged_decode_flops(b, h, mb, bs, d)
    assert paged.flops == paged8.flops == want
    # on CPU tensors the wrappers take the plain versions: nothing is
    # added to an open count
    with tatt.count_kernel_cost() as sink:
        tatt.paged_decode_attention(qd, pages, pages, bt, lens)
        tatt.flash_attention(q, k, v, causal=True)
    assert sink == {"flops": 0, "bytes": 0}
