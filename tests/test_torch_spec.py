"""The port's speculative decoding against the JAX package's: the draft
config, a draft that shares the target's storage, greedy-exact streams
against plain decode and against the JAX spec engine, and spec beside the
prefix cache and int8-kv."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving import quant as jquant  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import quant as tquant  # noqa: E402

GEOMETRY = dict(max_batch=4, max_seq=64, block_size=8, buckets=(16, 32))


@pytest.fixture(scope="module")
def parts():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash", num_layers=4)
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                               attn_impl="flash", num_layers=4)
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    return fmodel, variables, model.eval()


def _port(model, **over):
    return tengine.ServingEngine(model, tengine.EngineConfig(
        **{**GEOMETRY, **over}), device="cpu")


def _requests(mod, seed, n=4, plen=9, max_new=8):
    rng = np.random.default_rng(seed)
    return [mod.Request(f"r{i}", rng.integers(1, 200, size=plen + i).tolist(),
                        max_new) for i in range(n)]


def _streams(eng, reqs):
    return {c.rid: c.tokens for c in eng.run(reqs)}


@pytest.mark.parametrize("layers,factor", [(32, 2), (4, 2), (4, 1), (3, 2),
                                           (1, 4), (5, 0)])
def test_draft_config_matches_jax(layers, factor):
    ours = tquant.draft_config(dataclasses.replace(
        tllama.llama_tiny(), num_layers=layers), factor)
    theirs = jquant.draft_config(dataclasses.replace(
        jllama.llama_tiny(), num_layers=layers), factor)
    assert ours.num_layers == theirs.num_layers
    assert ours.d_model == theirs.d_model and ours.vocab_size == 512


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_draft_shares_the_targets_storage(parts, quant):
    """The engine's draft holds the target's own tensors (same
    ``data_ptr``) for its embedding, first blocks, final norm and head,
    int8 buffers included, and nothing else: it adds no memory."""
    _, _, model = parts
    eng = _port(model, spec_k=2, spec_draft_factor=2, quant=quant)
    target, draft = eng.model, eng._draft_model
    assert draft.cfg.num_layers == 2 and len(draft.layers) == 2
    ptrs = {t.data_ptr() for t in (*target.parameters(), *target.buffers())}
    dtensors = list(draft.parameters()) + list(draft.buffers())
    assert dtensors and all(t.data_ptr() in ptrs for t in dtensors)
    assert draft.lm_head is target.lm_head
    assert draft.layers[1] is target.layers[1]
    if quant == "int8":
        assert isinstance(draft.layers[0].qkv, tquant.QuantLinear)
        assert draft.layers[0].qkv.q8.dtype == torch.int8
    assert eng._draft_cache["k"][0].shape == eng._cache["k"][0].shape
    assert len(eng._draft_cache["k"]) == 2
    with pytest.raises(ValueError):
        tquant.draft_model_from(target, dataclasses.replace(
            target.cfg, num_layers=9))


def test_draft_forward_is_the_targets_first_blocks(parts):
    """The draft's logits are the target's truncated to its first blocks
    (the JAX package's ``draft_variables_from`` tree on its model)."""
    fmodel, variables, model = parts
    dcfg = tquant.draft_config(model.cfg, 2)
    draft = tquant.draft_model_from(model, dcfg)
    jdcfg = jquant.draft_config(fmodel.cfg, 2)
    jdraft = jllama.Llama(jdcfg)
    jvars = jquant.draft_variables_from(variables, jdcfg)
    ids = np.random.default_rng(3).integers(1, 500, size=(2, 11))
    with torch.inference_mode():
        ours = draft(torch.from_numpy(ids)).numpy()
    theirs = np.asarray(jdraft.apply(jvars, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)


@pytest.mark.parametrize("spec_k", [1, 3])
@pytest.mark.parametrize("factor", [1, 2])
def test_spec_streams_equal_plain_greedy(parts, spec_k, factor):
    """Zero tolerance: the verify step only ever emits the target's own
    argmax, so spec-on streams equal spec-off streams token for token."""
    _, _, model = parts
    plain = _port(model)
    want = _streams(plain, _requests(tengine, 33))
    spec = _port(model, spec_k=spec_k, spec_draft_factor=factor)
    got = _streams(spec, _requests(tengine, 33))
    assert got == want
    stats = spec.stats()
    assert stats["spec_proposed"] > 0
    assert 0.0 <= stats["spec_acceptance_rate"] <= 1.0
    passes = stats["passes"]
    assert passes["decode"] == 0 and passes["prefill"] == 4
    assert passes["verify"] == passes["draft_decode"] == (
        (spec_k + 1) * stats["decode_steps"])
    if factor == 1:
        # a full-depth draft IS the target: every proposal is accepted
        assert stats["spec_acceptance_rate"] == 1.0
        # more tokens a step than plain decode lands
        ps = plain.stats()
        assert (stats["spec_tokens_per_step"]
                > ps["decode_tokens"] / ps["decode_steps"])
    assert spec._allocator.available == spec.cache_cfg.num_pages - 1


@pytest.mark.parametrize("spec_k,factor", [(2, 2), (3, 1)])
def test_spec_streams_and_counters_equal_jax(parts, spec_k, factor):
    """The port's spec engine and the JAX spec engine decode the same
    streams with the same proposal and acceptance counts and the same
    number of spec steps."""
    fmodel, variables, model = parts
    over = dict(spec_k=spec_k, spec_draft_factor=factor)
    ours = _port(model, **over)
    theirs = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **GEOMETRY, **over))
    got = _streams(ours, _requests(tengine, 34))
    want = _streams(theirs, _requests(jengine, 34))
    assert got == want
    ts, js = ours.stats(), theirs.stats()
    for key in ("spec_proposed", "spec_accepted", "spec_acceptance_rate",
                "spec_tokens_per_step", "decode_steps", "decode_tokens"):
        assert ts[key] == js[key], key


def test_spec_with_prefix_cache_and_int8_kv(parts):
    """The full stack at once: int8 weights, int8 KV, the prefix cache
    (the draft's pools mirror every table install and COW copy) and spec
    decoding still emit the engine's own greedy stream, against the same
    quant level with spec off and against the JAX engine so configured."""
    fmodel, variables, model = parts
    rng = np.random.default_rng(35)
    shared = rng.integers(1, 200, size=12).tolist()

    def reqs(mod):
        return [mod.Request("cold", list(shared), 6),
                mod.Request("rerun", list(shared), 6),
                mod.Request("fork", shared[:12] + [7, 9], 6)]

    over = dict(quant="int8-kv", prefix_cache=True)
    want = _streams(_port(model, **over), reqs(tengine))
    spec = _port(model, **over, spec_k=2, spec_draft_factor=1)
    got = _streams(spec, reqs(tengine))
    assert got == want
    jeng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **GEOMETRY, **over, spec_k=2, spec_draft_factor=1))
    assert _streams(jeng, reqs(jengine)) == got
    stats = spec.stats()
    assert stats["prefix_hits"] == 2 and stats["cow_copies"] >= 2
    # hits feed their suffix as forced window tokens: with a full-depth
    # draft every free proposal is still accepted
    assert stats["spec_acceptance_rate"] == 1.0
    assert stats["passes"]["draft_prefill"] == stats["prefix_misses"] == 1
    spec._prefix.clear()
    assert spec._allocator.available == spec.cache_cfg.num_pages - 1


def test_spec_stats_and_overrun_slack(parts):
    """The spec stats keys are present, and submit reserves the verify
    window's overrun: a request that fits max_seq only without the
    ``spec_k`` slack is refused."""
    _, _, model = parts
    eng = _port(model, spec_k=3)
    for key in ("spec_proposed", "spec_accepted", "spec_acceptance_rate",
                "spec_tokens_per_step"):
        assert key in eng.stats()
    assert "m2kt_serve_spec_acceptance_rate" in eng.registry.render()
    with pytest.raises(ValueError, match="overrun slack 3"):
        eng.submit(tengine.Request("x", list(range(1, 31)), 32))
    _port(model).submit(tengine.Request("x", list(range(1, 31)), 32))


@pytest.mark.parametrize("spec_k,factor", [(2, 2), (3, 1), (3, 2)])
def test_spec_prefix_hit_with_suffix_longer_than_window(parts, spec_k,
                                                        factor):
    """A prefix hit whose uncached suffix outruns the verify window is fed
    over several fully forced windows; each must resume at the next owed
    prompt token, so the streams equal the plain (cache-off, spec-off)
    engine's. The JAX package's synchronous spec step re-feeds the last
    forced token here, so this is held against plain greedy, not JAX."""
    _, _, model = parts
    rng = np.random.default_rng(36)
    shared = rng.integers(1, 200, size=16).tolist()
    tail = rng.integers(1, 200, size=10).tolist()

    def reqs():
        return [tengine.Request("cold", list(shared), 6),
                tengine.Request("fork", shared[:8] + tail, 8),
                tengine.Request("fork2", shared + tail[:7], 8)]

    want = _streams(_port(model), reqs())
    spec = _port(model, prefix_cache=True, spec_k=spec_k,
                 spec_draft_factor=factor)
    got = _streams(spec, reqs())
    assert got == want
    stats = spec.stats()
    assert stats["prefix_hits"] == 2
    # suffixes of 10 and 7 tokens: covered 8 and 16, more than k + 1 owed
    assert stats["prefix_hit_tokens"] == 8 + 16
    spec._prefix.clear()
    assert spec._allocator.available == spec.cache_cfg.num_pages - 1
