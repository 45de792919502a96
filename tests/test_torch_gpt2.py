"""The port's GPT-2 against the flax GPT-2, on the same weights: the model's
three modes, its int8 tree, the serving engine's paths against the JAX
engine (``async_decode="off"``), the spec draft and the LM step through
the tied head.

The flax model is initialised from a seed; ``params_from_jax`` carries
its parameters (as numpy) into the torch model. Everything runs on the
CPU in fp32, where the port takes its plain attention paths.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from move2kube_tpu.models import gpt2 as jgpt2  # noqa: E402
from move2kube_tpu.models import train as jtrain  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving import kvcache as jkv  # noqa: E402
from move2kube_tpu.serving import quant as jquant  # noqa: E402
from move2kube_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models.convert import (  # noqa: E402
    init_gpt2,
    params_from_jax,
)
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import kvcache as tkv  # noqa: E402
from move2kube_tpu_torch.serving import quant as tquant  # noqa: E402

# tests/test_torch_llama.py's bounds: full-forward logits, port vs flax,
# fp32 (two frameworks' kernels summed in other orders over 2 layers);
# paged decode against the port's own full forward
LOGITS_ATOL = 1e-4
DECODE_ATOL = 1e-5
# tests/test_torch_serving.py's: engine logits, port vs JAX engine
ENGINE_LOGITS_ATOL = 1e-4
# tests/test_torch_quant.py's: an int8-kv cache holds rows the frameworks
# compute ~1e-7 apart, so now and then a value lands one int8 step apart;
# decode rows read them
INT8_KV_FLIP_ATOL = 5e-3
# tests/test_torch_train.py's: fp32 step losses and grad norm, relative
FP32_REL = 1e-5
GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32))
CHUNK = 128


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jgpt2.gpt2_tiny(), dtype=jnp.float32)
    fmodel = jgpt2.GPT2(jcfg)
    variables = jax.device_get(jax.jit(fmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tcfg = dataclasses.replace(tgpt2.gpt2_tiny(), dtype=torch.float32)
    model = tgpt2.GPT2(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(variables["params"], tcfg))
    return fmodel, variables, model.eval()


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(1, 256, size=shape)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (2, 24)), (1, (1, 64))])
def test_full_forward_matches_flax(pair, seed, shape):
    """Logits and the pre-head hidden states (``return_hidden``), at a
    short batch and at the full ``n_positions``."""
    fmodel, variables, model = pair
    ids = jnp.asarray(_ids(seed, shape), jnp.int32)
    want = np.asarray(jax.jit(fmodel.apply)(variables, ids))
    hidden = np.asarray(jax.jit(lambda v, x: fmodel.apply(
        v, x, return_hidden=True))(variables, ids))
    ids = np.asarray(ids)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids)).numpy()
        got_hidden = model(torch.from_numpy(ids), return_hidden=True)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    assert got_hidden.dtype == torch.float32
    np.testing.assert_allclose(got_hidden.numpy(), hidden, atol=LOGITS_ATOL,
                               rtol=0)


def test_prefill_kv_matches_flax(pair):
    fmodel, variables, model = pair
    ids = _ids(2, (1, 12))
    _, jkvs = fmodel.apply(variables, jnp.asarray(ids, jnp.int32),
                           return_kv=True)
    with torch.inference_mode():
        _, kvs = model(torch.from_numpy(ids), return_kv=True)
    assert len(kvs) == len(jkvs) == 2
    for (k, v), (jk, jv) in zip(kvs, jkvs):
        assert k.shape == jk.shape == (1, 12, 4, 16)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk),
                                   atol=LOGITS_ATOL, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                                   atol=LOGITS_ATOL, rtol=0)


def _decode_run(model_fn, kv_mod, spec, prompt, n_steps, prefill):
    """Prefill ``prompt`` into slot 1 of a paged cache (pages of 8), then
    ``n_steps`` greedy single-token passes with slot 0 idling at the null
    page; returns each pass's slot-1 logits and the tokens."""
    block_size = spec.block_size
    plen = len(prompt)
    pages = kv_mod.PageAllocator(spec.num_pages).alloc(
        kv_mod.pages_for(plen + n_steps, block_size))
    bt_row = np.full((spec.max_pages_per_seq,), kv_mod.NULL_PAGE, np.int32)
    bt_row[:len(pages)] = pages
    logits, cache = prefill(prompt, bt_row)
    toks = list(prompt) + [int(np.argmax(logits))]
    rows = []
    for _ in range(n_steps):
        pos = np.array([0, len(toks) - 1], np.int32)
        tables = np.stack([np.zeros_like(bt_row), bt_row])
        step, cache = model_fn(np.array([0, toks[-1]]), pos, tables, cache)
        rows.append(step[1])
        toks.append(int(np.argmax(step[1])))
    return np.stack(rows), toks


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_paged_decode_matches_flax_and_full_forward(pair, cache_dtype):
    """A prompt of 6 in pages of 8 and 4 decode steps that cross into the
    second page, slot 0 idling: each step's logits equal the JAX model's
    paged step within LOGITS_ATOL (an int8 cache: INT8_KV_FLIP_ATOL), and
    with an fp cache the port's own full forward's row within
    DECODE_ATOL."""
    fmodel, variables, model = pair
    prompt = _ids(3, 6).tolist()
    tspec = tkv.spec_for_model(model.cfg, block_size=8, max_batch=2,
                               max_seq=64, cache_dtype=(
                                   torch.int8 if cache_dtype else None))
    jspec = jkv.spec_for_model(fmodel.cfg, block_size=8, max_batch=2,
                               max_seq=64, cache_dtype=(
                                   jnp.int8 if cache_dtype else None))

    def t_prefill(p, bt_row):
        cache = tkv.init_cache(tspec, "cpu")
        with torch.inference_mode():
            logits, kvs = model(torch.tensor([p]), return_kv=True)
            tkv.scatter_prefill(cache, kvs, 1, torch.from_numpy(bt_row),
                                len(p), 8)
        return logits[0, -1].numpy(), cache

    def t_step(ids, pos, tables, cache):
        mc = {k: cache[k] for k in tkv.PAGE_KEYS if k in cache}
        mc["block_tables"] = torch.from_numpy(tables)
        mc["seq_lens"] = torch.from_numpy(pos + 1)
        with torch.inference_mode():
            logits, _ = model(torch.from_numpy(ids),
                              positions=torch.from_numpy(pos), cache=mc)
        return logits.numpy(), cache

    def j_prefill(p, bt_row):
        logits, kvs = fmodel.apply(variables, jnp.asarray([p], jnp.int32),
                                   return_kv=True)
        cache = jkv.scatter_prefill(jkv.init_cache(jspec), kvs, 1,
                                    jnp.asarray(bt_row), len(p), 8)
        return np.asarray(logits[0, -1]), cache

    j_apply = jax.jit(lambda v, ids, pos, mc: fmodel.apply(
        v, ids, positions=pos, cache=mc))

    def j_step(ids, pos, tables, cache):
        mc = {k: cache[k] for k in ("k", "v", "k_scale", "v_scale")
              if k in cache}
        mc["block_tables"] = jnp.asarray(tables)
        mc["seq_lens"] = jnp.asarray(pos + 1)
        logits, out = j_apply(variables, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(pos), mc)
        return np.asarray(logits), dict(cache, **{
            k: out[k] for k in ("k", "v", "k_scale", "v_scale") if k in out})

    got, toks = _decode_run(t_step, tkv, tspec, prompt, 4, t_prefill)
    want, jtoks = _decode_run(j_step, jkv, jspec, prompt, 4, j_prefill)
    assert toks == jtoks
    atol = INT8_KV_FLIP_ATOL if cache_dtype else LOGITS_ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if cache_dtype is None:
        with torch.inference_mode():
            full = model(torch.tensor([toks])).numpy()[0]
        np.testing.assert_allclose(got, full[len(prompt):len(prompt) + 4],
                                   atol=DECODE_ATOL, rtol=DECODE_ATOL)


def test_params_from_jax_layout_and_int8_tree(pair):
    """Dense kernels [in, out] become Linear weights [out, in] with their
    biases; LayerNorm scale/bias become weight/bias in fp32; embeddings
    take the model's dtype. The JAX int8 tree maps onto the quantized
    model (every projection int8, biases and the tied embedding as they
    were), whose forward equals the JAX model on the dequantized tree."""
    fmodel, variables, model = pair
    p = variables["params"]
    cfg = dataclasses.replace(tgpt2.gpt2_tiny(), dtype=torch.bfloat16)
    sd = params_from_jax(p, cfg)
    k = p["h_0"]["c_attn"]["kernel"]
    assert sd["h.0.c_attn.weight"].shape == (k.shape[1], k.shape[0])
    assert sd["h.0.c_attn.bias"].dtype == torch.bfloat16
    assert sd["h.1.ln_2.weight"].dtype == torch.float32
    assert sd["wte.weight"].dtype == torch.bfloat16
    tgpt2.GPT2(cfg, device="cpu").load_state_dict(sd)  # strict
    q = jax.device_get(jquant.quantize_variables(variables))
    assert set(q["params"]["h_0"]["c_attn"]["kernel"]) == {"q8", "scale"}
    qmodel = tquant.quantize_model(model)
    qmodel.load_state_dict(params_from_jax(q["params"], model.cfg))
    for name in ("c_attn", "attn_out", "c_fc", "mlp_out"):
        assert isinstance(getattr(qmodel.h[1], name), tquant.QuantLinear)
    assert isinstance(qmodel.wte, torch.nn.Embedding)
    ids = _ids(4, (1, 16))
    want = np.asarray(fmodel.apply(jquant.dequantize_variables(q),
                                   jnp.asarray(ids, jnp.int32)))
    with torch.inference_mode():
        got = qmodel(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_quant_linear_bias_and_bias_free_layers():
    """A quantized layer with a bias adds it after the product in the
    compute type; a bias-free layer gives the same bits as before the
    bias existed (the product alone)."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(16, 8)
    x = torch.randn(3, 16)
    q = tquant.QuantLinear.from_linear(lin)
    assert q.bias.data_ptr() == lin.bias.data_ptr()  # shared, not copied
    want = torch.nn.functional.linear(x, q.dequantized()) + lin.bias
    assert torch.equal(q(x), want)
    free = tquant.QuantLinear.from_linear(torch.nn.Linear(16, 8, bias=False))
    assert free.bias is None and "bias" not in free.state_dict()
    assert torch.equal(free(x), torch.nn.functional.linear(
        x, free.dequantized()))


def test_spec_for_model_is_duck_typed():
    """tests/test_serving.py's asserts on gpt2_tiny: an MHA model has no
    num_kv_heads and max_seq defaults to n_positions; the geometry equals
    the JAX function's."""
    spec = tkv.spec_for_model(tgpt2.gpt2_tiny(), block_size=8, max_batch=2)
    assert spec.num_kv_heads == tgpt2.gpt2_tiny().num_heads
    assert spec.max_seq == tgpt2.gpt2_tiny().n_positions
    theirs = jkv.spec_for_model(jgpt2.gpt2_tiny(), block_size=8, max_batch=2)
    for field in ("num_layers", "num_kv_heads", "head_dim", "num_pages",
                  "max_pages_per_seq", "max_seq"):
        assert getattr(spec, field) == getattr(theirs, field), field


def test_draft_model_shares_the_first_blocks(pair):
    _, _, model = pair
    qmodel = tquant.quantize_model(model)
    draft = tquant.draft_model_from(
        qmodel, tquant.draft_config(qmodel.cfg, 2))
    assert isinstance(draft, tgpt2.GPT2) and len(draft.h) == 1
    assert draft.h[0] is qmodel.h[0] and draft.wte is qmodel.wte
    assert draft.wpe is qmodel.wpe and draft.ln_f is qmodel.ln_f
    assert tquant.param_bytes(draft) < tquant.param_bytes(qmodel)


def test_engine_refuses_max_seq_past_n_positions(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="n_positions 64"):
        tengine.ServingEngine(model, tengine.EngineConfig(
            max_batch=2, max_seq=128, block_size=8), device="cpu")


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------


def _requests(mod, seed=7):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 256, size=12).tolist()
    return [mod.Request("a", rng.integers(1, 256, size=5).tolist(), 6),
            mod.Request("b", rng.integers(1, 256, size=20).tolist(), 4),
            mod.Request("c", list(shared), 5),
            mod.Request("d", shared + [7, 9], 5)]


ENGINE_CASES = {
    "plain": {},
    "int8": dict(quant="int8"),
    "int8-kv": dict(quant="int8-kv"),
    "chunked": dict(chunk_prefill=8),
    "prefix": dict(prefix_cache=True),
    "spec": dict(spec_k=3, spec_draft_factor=2),
    "lora": dict(max_loras=1, lora_rank=4),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax_engine(pair, case):
    """Four requests on two slots (one waits; two share a 12-token
    prefix): the same greedy streams as the JAX engine, every captured
    logit row within ENGINE_LOGITS_ATOL (decode rows under int8-kv within
    INT8_KV_FLIP_ATOL), the passes' kinds as configured and the pages all
    back after. ``lora`` registers one adapter on both and sends two of
    the requests through it: its delta on the tied head."""
    fmodel, variables, model = pair
    over = ENGINE_CASES[case]
    teng = tengine.ServingEngine(model, tengine.EngineConfig(
        **GEOMETRY, **over), device="cpu")
    jeng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **GEOMETRY, **over, async_decode="off"))
    treqs, jreqs = _requests(tengine), _requests(jengine)
    if case == "lora":
        rng = np.random.default_rng(5)
        a = (rng.normal(size=(64, 4)) * 0.1).astype(np.float32)
        b = (rng.normal(size=(4, 256)) * 0.1).astype(np.float32)
        assert teng.register_adapter("x", a, b) == jeng.register_adapter(
            "x", a, b)
        for reqs in (treqs, jreqs):
            for r in reqs[::2]:
                r.adapter = "x"
    teng.capture_logits = jeng.capture_logits = True
    want = {c.rid: c for c in jeng.run(jreqs)}
    got = {c.rid: c for c in teng.run(treqs)}
    assert set(got) == set(want) == {"a", "b", "c", "d"}
    for rid, c in got.items():
        assert c.tokens == want[rid].tokens, rid
        rows, jrows = teng.logit_log[rid], jeng.logit_log[rid]
        assert len(rows) == len(jrows)
        for i, (row, jrow) in enumerate(zip(rows, jrows)):
            atol = (INT8_KV_FLIP_ATOL if case == "int8-kv" and i
                    else ENGINE_LOGITS_ATOL)
            np.testing.assert_allclose(row, np.asarray(jrow), atol=atol,
                                       rtol=0, err_msg=f"{rid} token {i}")
    stats = teng.stats()
    if case == "prefix":
        assert stats["prefix_hits"] >= 1
    if case == "spec":
        assert stats["passes"]["verify"] > 0
        assert stats["spec_proposed"] == jeng.stats()["spec_proposed"]
    if case == "chunked":
        assert stats["passes"]["chunk"] > 0
    if teng._prefix is not None:
        teng._prefix.clear()
    assert teng._allocator.available == teng.cache_cfg.num_pages - 1


def test_install_weights_and_prefilled_handoff(pair):
    """``install_weights`` takes GPT-2's fp tree into an int8 engine (the
    biases ride along) and then decodes as an engine built on those
    weights does; ``install_prefilled`` seats a prefill done on the
    model directly and continues it as the cold engine would."""
    _, _, model = pair
    other = init_gpt2(model.cfg, seed=5, device="cpu").eval()
    reqs = [tengine.Request("x", _ids(6, 9).tolist(), 5)]
    eng = tengine.ServingEngine(model, tengine.EngineConfig(
        **GEOMETRY, quant="int8"), device="cpu")
    eng.install_weights(other.state_dict())
    want = tengine.ServingEngine(other, tengine.EngineConfig(
        **GEOMETRY, quant="int8"), device="cpu")
    assert [c.tokens for c in eng.run(reqs)] == [
        c.tokens for c in want.run(reqs)]
    cold = tengine.ServingEngine(model, tengine.EngineConfig(**GEOMETRY),
                                 device="cpu")
    ref = cold.run([tengine.Request("y", _ids(7, 11).tolist(), 6)])[0]
    prompt = _ids(7, 11).tolist()
    ids = torch.zeros(1, 16, dtype=torch.long)
    ids[0, :11] = torch.tensor(prompt)
    with torch.inference_mode():
        logits, kvs = model(ids, return_kv=True)
    first = int(torch.argmax(logits[0, 10]))
    eng2 = tengine.ServingEngine(model, tengine.EngineConfig(**GEOMETRY),
                                 device="cpu")
    ok, _ = eng2.install_prefilled(tengine.Request("y", prompt, 6), kvs,
                                   first, 11)
    assert ok
    done = []
    while eng2.has_work():
        done += eng2.step()
    assert done[0].tokens == ref.tokens


def test_fleet_serves_gpt2(pair):
    """``build_fleet`` puts two GPT-2 replicas behind the router; a stream
    it serves equals a lone engine's."""
    from move2kube_tpu_torch.serving.fleet.router import (
        RouterConfig,
        build_fleet,
    )

    _, _, model = pair
    prompt = _ids(9, 10).tolist()
    want = tengine.ServingEngine(model, tengine.EngineConfig(**GEOMETRY),
                                 device="cpu").run(
        [tengine.Request("x", prompt, 6)])[0].tokens
    router = build_fleet(model, 2, tengine.EngineConfig(**GEOMETRY),
                         RouterConfig(), device="cpu")
    try:
        out = router.generate(prompt, 6)
    finally:
        for rep in router.replicas:
            rep.close()
    assert out["tokens"] == want


# ----------------------------------------------------------------------
# the LM step through the tied head
# ----------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [CHUNK, 512])
def test_lm_step_through_the_tied_head_matches_jax(monkeypatch, pair,
                                                   chunk):
    """Two AdamW steps of GPT-2 in fp32: the vocab (256) spans two chunks
    of 128, so both steps fold the tied head into the chunked loss (the
    JAX side through ``M2KT_CE_CHUNK``); at 512 both take the logits
    path. The losses and grad norms match the JAX step's, and the tied
    embedding's gradient carries both its uses."""
    fmodel, variables, _ = pair
    monkeypatch.setenv("M2KT_CE_CHUNK", str(chunk))
    monkeypatch.setenv("M2KT_FUSED_CE", "auto" if chunk == CHUNK else "off")
    params = variables["params"]
    batches = _ids(8, (2, 2, 32))
    state = jtrain.TrainState.create(
        apply_fn=fmodel.apply, params=jax.tree.map(jnp.asarray, params),
        tx=jtrain.instrument_optimizer(optax.adamw(1e-3, weight_decay=0.1)))
    jstep = jtrain.make_lm_train_step(
        make_mesh(MeshConfig(), devices=jax.devices()[:1]), remat=False)
    want, wnorm = [], []
    for ids in batches:
        state, loss = jstep(state, {"input_ids": jnp.asarray(ids,
                                                             jnp.int32)})
        want.append(float(loss))
        wnorm.append(jtrain.grad_norm_from_state(state))
    cfg = dataclasses.replace(tgpt2.gpt2_tiny(), dtype=torch.float32)
    model = tgpt2.GPT2(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    opt = ttrain.instrument_optimizer(ttrain.adamw(model.parameters(), 1e-3,
                                                   0.1))
    tstate = ttrain.TrainState(model, opt)
    step = ttrain.make_lm_train_step(remat=True, chunk=chunk)
    got, norm = [], []
    for ids in batches:
        tstate, loss = step(tstate, {"input_ids": torch.from_numpy(ids)})
        got.append(float(loss))
        norm.append(ttrain.grad_norm_from_state(tstate))
    for a, b in zip(got + norm, want + wnorm):
        assert abs(a - b) / abs(b) < FP32_REL, (got, want, norm, wnorm)
