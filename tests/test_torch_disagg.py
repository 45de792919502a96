"""The port's disaggregated prefill against the JAX package's: the
``KVHandoff`` wire (byte-compatible both ways; malformations are
``ValueError``), fp32 handoffs across the two frameworks in either
direction, the bf16 ``|V2`` words, and ``install_prefilled`` on the
port's engine (its checks, int8-kv, spec decode's draft prefill and the
trace) against the JAX engine (``async_decode="off"``) and the port's
cold engine."""

import dataclasses
import io
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving.fleet import disagg as jdisagg  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs import tracing as ttracing  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving.fleet import disagg as tdisagg  # noqa: E402

GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32))
# handed-off K/V, port vs flax prefill, fp32 (the bound the port's
# prefill K/V test holds)
KV_ATOL = 1e-4


def _parts(dtype):
    jcfg = dataclasses.replace(jllama.llama_tiny(), attn_impl="dense",
                               dtype=jnp.float32 if dtype == torch.float32
                               else jnp.bfloat16)
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(4),
                            jnp.zeros((1, 8), jnp.int32))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=dtype,
                               attn_impl="dense")
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    return fmodel, variables, model.eval()


@pytest.fixture(scope="module")
def parts():
    return _parts(torch.float32)


def _prompt(seed, n=12):
    return np.random.default_rng(seed).integers(1, 200, size=n).tolist()


def _engine(model, **over):
    return tengine.ServingEngine(model, tengine.EngineConfig(
        **{**GEOMETRY, "async_decode": "off", **over}), device="cpu")


def _jengine(parts, **over):
    fmodel, variables, _ = parts
    return jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **{**GEOMETRY, **over}, async_decode="off"))


REQS = [("a", 41, 12, 6), ("b", 42, 20, 5), ("c", 43, 7, 4)]


def _requests(mod):
    return [mod.Request(rid, _prompt(seed, n), new)
            for rid, seed, n, new in REQS]


def _cold_streams(model, **over):
    return {c.rid: c.tokens
            for c in _engine(model, **over).run(_requests(tengine))}


def _install_all(eng, handoffs):
    """Seat each handoff (stepping while the engine is full) and decode
    every stream to completion."""
    done, inbox = [], list(handoffs)
    while inbox or eng.has_work():
        while inbox:
            h = inbox[0]
            ok, got = eng.install_prefilled(h.request(), h.kv, h.first_token,
                                            h.prompt_len)
            done += got
            if not ok:
                break
            inbox.pop(0)
        done += eng.step()
    return {c.rid: c.tokens for c in done}


# ----------------------------------------------------------------------
# wire
# ----------------------------------------------------------------------

def _members(data):
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_wire_roundtrip_and_bytes_match_jax():
    """A handoff built from the same arrays writes the same npz members
    (meta, prompt, k, v) as the JAX package's, and each side parses the
    other's bytes to the same values."""
    rng = np.random.default_rng(1)
    kv = [(rng.normal(size=(1, 16, 2, 8)).astype(np.float32),
           rng.normal(size=(1, 16, 2, 8)).astype(np.float32))
          for _ in range(3)]
    fields = dict(rid="r1", prompt=list(range(3, 13)), prompt_len=10,
                  bucket=16, first_token=7, max_new_tokens=5, tenant="acme",
                  traceparent="00-" + "1" * 32 + "-" + "2" * 16 + "-01")
    ours = tdisagg.KVHandoff(kv=[(torch.from_numpy(k), torch.from_numpy(v))
                                 for k, v in kv], **fields).to_bytes()
    theirs = jdisagg.KVHandoff(kv=kv, **fields).to_bytes()
    assert _members(ours) == _members(theirs)
    for data in (ours, theirs):
        h = tdisagg.KVHandoff.from_bytes(data)
        j = jdisagg.KVHandoff.from_bytes(data)
        for name, value in fields.items():
            assert getattr(h, name) == getattr(j, name) == value, name
        assert len(h.kv) == 3
        for (tk, tv), (jk, jv), (k, v) in zip(h.kv, j.kv, kv):
            assert tk.dtype == torch.float32
            np.testing.assert_array_equal(tk.numpy(), k)
            np.testing.assert_array_equal(tv.numpy(), jv)
    req = tdisagg.KVHandoff.from_bytes(ours).request()
    assert (req.rid, req.tenant, req.max_new_tokens) == ("r1", "acme", 5)


def test_wire_malformations_are_value_errors():
    kv = [(torch.zeros(1, 16, 2, 8), torch.zeros(1, 16, 2, 8))]
    data = tdisagg.KVHandoff(rid="r", prompt=[1, 2], prompt_len=2, bucket=16,
                             first_token=3, kv=kv).to_bytes()
    buf = io.BytesIO()
    np.savez(buf, meta=np.frombuffer(b'{"v": 99}', np.uint8))
    wrong_version = buf.getvalue()
    buf = io.BytesIO()
    np.savez(buf, meta=np.frombuffer(b'{"v": 1, "rid": "r"}', np.uint8),
             prompt=np.zeros(2, np.int32), k=np.zeros((1, 1, 16, 2, 8),
                                                     np.dtype("V4")))
    odd_words = buf.getvalue()
    for bad in (data[:len(data) // 2], b"", b"junk", wrong_version,
                odd_words):
        with pytest.raises(ValueError):
            tdisagg.KVHandoff.from_bytes(bad)


def test_bf16_words_roundtrip_in_the_port_and_from_jax():
    """bf16 K/V travel as ``|V2`` words: the port's bytes parse back to
    the same bf16 bits, and a JAX bf16 handoff's bytes (which the JAX
    engine itself cannot install) parse in the port to the JAX arrays'
    bits."""
    jparts = _parts(torch.bfloat16)
    fmodel, variables, model = jparts
    req = tengine.Request("bf", _prompt(44), 4)
    h = tdisagg.PrefillReplica(model, tengine.EngineConfig(**GEOMETRY),
                               device="cpu").prefill(req)
    assert h.kv[0][0].dtype == torch.bfloat16
    data = h.to_bytes()
    with np.load(io.BytesIO(data)) as z:
        assert z["k"].dtype == np.dtype("V2")
    back = tdisagg.KVHandoff.from_bytes(data)
    for (k, v), (k2, v2) in zip(h.kv, back.kv):
        assert k2.dtype == torch.bfloat16
        assert torch.equal(k.view(torch.int16), k2.view(torch.int16))
        assert torch.equal(v.view(torch.int16), v2.view(torch.int16))
    jh = jdisagg.PrefillReplica(fmodel, variables, jengine.EngineConfig(
        **GEOMETRY)).prefill(jengine.Request("bf", _prompt(44), 4))
    ours = tdisagg.KVHandoff.from_bytes(jh.to_bytes())
    for (jk, _), (tk, _) in zip(jh.kv, ours.kv):
        np.testing.assert_array_equal(
            tk.view(torch.int16).numpy(), np.asarray(jk).view(np.int16))
    # the port's own bf16 pair decodes the cold bf16 engine's streams
    pair = tdisagg.DisaggPair(
        tdisagg.PrefillReplica(model, tengine.EngineConfig(**GEOMETRY),
                               device="cpu"), _engine(model))
    got = {c.rid: c.tokens for c in pair.run(_requests(tengine))}
    assert got == _cold_streams(model)


# ----------------------------------------------------------------------
# across the frameworks, fp32
# ----------------------------------------------------------------------

def test_jax_prefill_bytes_install_in_the_port(parts):
    """JAX PrefillReplica bytes -> the port's install_prefilled: the
    decoded streams equal the JAX DisaggPair's and the port's cold
    engine's; the port's own prefill K/V agree with the JAX handoff's."""
    fmodel, variables, model = parts
    jpre = jdisagg.PrefillReplica(fmodel, variables,
                                  jengine.EngineConfig(**GEOMETRY))
    jhand = [jpre.prefill(r) for r in _requests(jengine)]
    ours = [tdisagg.KVHandoff.from_bytes(h.to_bytes()) for h in jhand]
    got = _install_all(_engine(model), ours)
    want = {c.rid: c.tokens for c in jdisagg.DisaggPair(
        jpre, _jengine(parts)).run(_requests(jengine))}
    assert got == want == _cold_streams(model)
    tpre = tdisagg.PrefillReplica(model, tengine.EngineConfig(**GEOMETRY),
                                  device="cpu")
    for h, r in zip(ours, _requests(tengine)):
        mine = tpre.prefill(r)
        assert mine.first_token == h.first_token and mine.bucket == h.bucket
        for (tk, tv), (jk, jv) in zip(mine.kv, h.kv):
            np.testing.assert_allclose(tk.numpy(), jk.numpy(), atol=KV_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(tv.numpy(), jv.numpy(), atol=KV_ATOL,
                                       rtol=0)


def test_port_prefill_bytes_install_in_the_jax_engine(parts):
    """The port's PrefillReplica bytes -> the JAX engine's
    install_prefilled: its streams equal the JAX DisaggPair's and the
    port's cold engine's."""
    fmodel, variables, model = parts
    tpre = tdisagg.PrefillReplica(model, tengine.EngineConfig(**GEOMETRY),
                                  device="cpu")
    handoffs = [jdisagg.KVHandoff.from_bytes(tpre.prefill(r).to_bytes())
                for r in _requests(tengine)]
    jeng = _jengine(parts)
    got = _install_all(jeng, handoffs)
    want = {c.rid: c.tokens for c in jdisagg.DisaggPair(
        jdisagg.PrefillReplica(fmodel, variables,
                               jengine.EngineConfig(**GEOMETRY)),
        _jengine(parts)).run(_requests(jengine))}
    assert got == want == _cold_streams(model)
    assert tpre.stats()["passes"]["prefill"] == 3
    assert 'm2kt_disagg_prefills_total 3' in tpre.registry.render()


# ----------------------------------------------------------------------
# install_prefilled on the port's engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("over", [dict(quant="int8-kv"),
                                  dict(spec_k=2, spec_draft_factor=2),
                                  dict(prefix_cache=True)])
def test_disagg_pair_equals_the_cold_engine(parts, over):
    """int8-kv (the scatter quantizes the handed-off K/V), spec decode
    (a local draft prefill) and the prefix cache: the pair's streams
    equal the port's cold engine's and the JAX pair's."""
    fmodel, variables, model = parts
    pair = tdisagg.DisaggPair(
        tdisagg.PrefillReplica(model, tengine.EngineConfig(**GEOMETRY,
                                                           **over),
                               device="cpu"), _engine(model, **over))
    got = {c.rid: c.tokens for c in pair.run(_requests(tengine))}
    assert got == _cold_streams(model, **over)
    jpair = jdisagg.DisaggPair(
        jdisagg.PrefillReplica(fmodel, variables,
                               jengine.EngineConfig(**GEOMETRY, **over)),
        _jengine(parts, **over))
    assert got == {c.rid: c.tokens for c in jpair.run(_requests(jengine))}
    passes = pair.engine.stats()["passes"]
    assert passes["prefill"] == 0
    assert passes["draft_prefill"] == (3 if "spec_k" in over else 0)


def test_install_prefilled_checks_match_jax(parts):
    """Draining, an expired deadline, a stream that cannot fit and a
    bucket over max_seq are refused by both engines alike; a full engine
    answers not-installed and retries after a step."""
    model = parts[2]
    h = tdisagg.PrefillReplica(model, tengine.EngineConfig(**GEOMETRY),
                               device="cpu").prefill(
        tengine.Request("x", _prompt(45), 4))
    kv_np = [(k.numpy(), v.numpy()) for k, v in h.kv]
    big = [(np.zeros((1, 128, 2, 32), np.float32),) * 2] * 2
    for eng, mod in ((_engine(model), tengine), (_jengine(parts), jengine)):
        cases = [(mod.Request("d", h.prompt, 4, deadline_s=0.0), kv_np,
                  mod.DeadlineExceeded),
                 (mod.Request("f", h.prompt, 60), kv_np, ValueError),
                 (mod.Request("b", h.prompt, 4), big, ValueError)]
        for req, kv, exc in cases:
            with pytest.raises(exc):
                eng.install_prefilled(req, kv, h.first_token, h.prompt_len)
        assert 'm2kt_serve_rejected_total 3' in eng.registry.render()
        for i in range(2):
            ok, _ = eng.install_prefilled(mod.Request(f"s{i}", h.prompt, 4),
                                          kv_np, h.first_token, h.prompt_len)
            assert ok
        ok, done = eng.install_prefilled(mod.Request("s2", h.prompt, 4),
                                         kv_np, h.first_token, h.prompt_len)
        assert not ok and not done
        eng.drain()
        with pytest.raises(mod.EngineDraining):
            eng.install_prefilled(mod.Request("late", h.prompt, 4), kv_np,
                                  h.first_token, h.prompt_len)
        assert len(eng.run([])) == 2


def test_install_prefilled_opens_a_disagg_root(parts):
    model = parts[2]
    rec = ttracing.SpanRecorder()
    eng = tengine.ServingEngine(model, tengine.EngineConfig(**GEOMETRY),
                                device="cpu", tracer=rec)
    tp = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"
    h = tdisagg.PrefillReplica(model, tengine.EngineConfig(**GEOMETRY),
                               device="cpu", tracer=rec).prefill(
        tengine.Request("t", _prompt(46), 3, tenant="acme", traceparent=tp))
    h2 = tdisagg.KVHandoff.from_bytes(h.to_bytes())
    assert eng.install_prefilled(h2.request(), h2.kv, h2.first_token,
                                 h2.prompt_len)[0]
    eng.run([])
    spans = rec.snapshot()
    names = {s["name"] for s in spans}
    assert {"prefill.request", "serve.request", "serve.kv_install",
            "serve.decode_step"} <= names
    root = next(s for s in spans if s["name"] == "serve.request")
    assert root["attrs"]["disagg"] == 1 and root["trace_id"] == "a" * 32
    assert root["attrs"]["tenant"] == "acme"
    pre = next(s for s in spans if s["name"] == "prefill.request")
    assert pre["trace_id"] == "a" * 32 and pre["parent_id"] == "b" * 16


def test_bf16_handoff_installs_in_the_port_not_in_the_jax_engine():
    """The reference caveat (ROADMAP.md Queue 3): a bf16 handoff reads
    back as ``|V2`` words, which the JAX engine's ``install_prefilled``
    cannot take; the port reads them as bf16, installs the JAX prefill's
    handoff and decodes the port's own cold bf16 stream."""
    fmodel, variables, model = _parts(torch.bfloat16)
    req = jengine.Request("bf", _prompt(47), 4)
    data = jdisagg.PrefillReplica(fmodel, variables, jengine.EngineConfig(
        **GEOMETRY)).prefill(req).to_bytes()
    jh = jdisagg.KVHandoff.from_bytes(data)
    jeng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **GEOMETRY, async_decode="off"))
    with pytest.raises(TypeError):
        jeng.install_prefilled(jh.request(), jh.kv, jh.first_token,
                               jh.prompt_len)
    th = tdisagg.KVHandoff.from_bytes(data)
    eng = _engine(model)
    assert eng.install_prefilled(th.request(), th.kv, th.first_token,
                                 th.prompt_len)[0]
    got = eng.run([])[0].tokens
    assert len(got) == 4 and got[0] == th.first_token
