"""The port's MoE against the JAX package's: the top-k routing (dispatch,
combine and the GShard aux loss, tokens dropped over capacity among
them), the MoE MLP, an MoE ``llama_tiny`` forward, an engine decoding
with idle rows against the JAX engine (``async_decode="off"``), the LM
step with the aux loss, and the int8 tree (router quantized, experts
fp).

Routing is discrete: ``jax.lax.top_k`` and ``torch.topk`` may order
ties differently, so every test draws its router inputs from a seed and
checks that no row has a tie among its top ``k + 1`` probabilities.
Everything runs on the CPU in fp32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.models import moe as jmoe  # noqa: E402
from move2kube_tpu.models import train as jtrain  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving import quant as jquant  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models import moe as tmoe  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import quant as tquant  # noqa: E402

# routing weights and the aux loss: fp32 softmax and sums, two frameworks
ROUTE_ATOL = 1e-6
# tests/test_torch_llama.py's: logits, port vs flax, fp32 over 2 layers
LOGITS_ATOL = 1e-4
# tests/test_torch_serving.py's: engine logits, port vs JAX engine
ENGINE_LOGITS_ATOL = 1e-4
# tests/test_torch_train.py's: fp32 step losses and grad norm, relative
FP32_REL = 1e-5
# each parameter's update over two AdamW steps, port vs JAX: the norm of
# the difference over the norm of the JAX update
UPDATE_REL = 1e-3
CHUNK = 128
E, K = 4, 2


def _no_ties(logits, k=K):
    p = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)), -1)
    gaps = np.diff(p[:, -(k + 1):], axis=-1)
    assert gaps.min() > 1e-6, "a tie among the top-k: draw another seed"


@pytest.mark.parametrize("tokens,capacity", [(16, 16), (16, 3), (9, 2)])
def test_top_k_routing_matches_jax(tokens, capacity):
    """Dispatch, combine and aux equal the JAX function's; at the small
    capacities tokens drop (fewer dispatched than routed), at a capacity
    of every token none does."""
    logits = np.random.default_rng(tokens + capacity).normal(
        size=(tokens, E)).astype(np.float32)
    _no_ties(logits)
    jd, jc, ja = jmoe.top_k_routing(jnp.asarray(logits), E, K, capacity)
    td, tc, ta = tmoe.top_k_routing(torch.from_numpy(logits), E, K, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ROUTE_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=ROUTE_ATOL)
    dropped = tokens * K - int(td.sum())
    assert (dropped > 0) == (capacity < tokens), dropped


def test_capacity_matches_the_reference_formula():
    for t, f in ((8, 1.25), (1536, 1.25), (3, 1.0), (4096, 2.0)):
        want = max(K, int(np.ceil(t * f * K / E)))
        assert tmoe.capacity_for(t, E, K, f) == want


def _moe_pair(seed=0, d=32, m=48):
    fm = jmoe.MoEMlp(num_experts=E, mlp_dim=m, top_k=K, dtype=jnp.float32)
    x = np.random.default_rng(seed).normal(size=(2, 8, d)).astype(np.float32)
    variables = jax.device_get(fm.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(x)))
    p = variables["params"]
    tm = tmoe.MoEMlp(d, E, m, top_k=K, dtype=torch.float32)
    tm.load_state_dict({
        "router.weight": torch.from_numpy(np.ascontiguousarray(
            p["router"]["kernel"].T)),
        **{name: torch.from_numpy(np.array(p[name]))
           for name in ("w_in", "w_gate", "w_out")}})
    return fm, variables, tm, x


def test_moe_mlp_matches_jax():
    fm, variables, tm, x = _moe_pair()
    _no_ties(x.reshape(-1, x.shape[-1]) @ variables["params"]["router"][
        "kernel"])
    want, jaux = fm.apply(variables, jnp.asarray(x))
    got, aux = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux),
                               atol=ROUTE_ATOL)


# ----------------------------------------------------------------------
# the MoE Llama
# ----------------------------------------------------------------------


def _cfgs(attn_impl="dense"):
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl=attn_impl, moe_experts=E,
                               moe_top_k=K)
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                               attn_impl=attn_impl, moe_experts=E,
                               moe_top_k=K)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs("flash")
    fmodel = jllama.Llama(jcfg)
    variables = jax.device_get(fmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 8), jnp.int32)))
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(variables["params"], tcfg))
    return fmodel, variables, model.eval()


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_moe_llama_forward_matches_flax(attn_impl):
    """A 2-layer MoE llama_tiny: logits and the summed aux loss (flax
    sows it into ``losses``; the port leaves it in ``moe_aux``)."""
    jcfg, tcfg = _cfgs(attn_impl)
    fmodel = jllama.Llama(jcfg)
    # params only: init's own sown losses would be appended to
    variables = {"params": jax.device_get(fmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])}
    model = tllama.Llama(tcfg, device="cpu")
    sd = params_from_jax(variables["params"], tcfg)
    assert "layers.0.moe.router.weight" in sd and "layers.0.down.weight" \
        not in sd
    model.load_state_dict(sd)
    ids = np.random.default_rng(1).integers(1, 500, size=(2, 16))
    want, sown = fmodel.apply(variables, jnp.asarray(ids, jnp.int32),
                              mutable=["losses"])
    jaux = sum(float(np.sum(v)) for v in jax.tree.leaves(sown))
    got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(model.moe_aux), jaux, atol=ROUTE_ATOL)


def test_int8_tree_quantizes_the_router_only(pair):
    """The JAX int8 tree quantizes each ``router`` kernel and leaves the
    expert weights fp (they are not ``kernel`` leaves); the port's
    ``quantize_model`` does the same, the tree loads into it, and its
    forward equals the JAX model's on the dequantized tree."""
    fmodel, variables, model = pair
    q = jax.device_get(jquant.quantize_variables(variables))
    moe = q["params"]["layer_0"]["moe"]
    assert set(moe["router"]["kernel"]) == {"q8", "scale"}
    assert moe["w_in"].dtype == np.float32
    qmodel = tquant.quantize_model(model)
    assert isinstance(qmodel.layers[0].moe.router, tquant.QuantLinear)
    assert qmodel.layers[0].moe.w_in.dtype == torch.float32
    assert qmodel.layers[0].moe.w_in is model.layers[0].moe.w_in
    qmodel.load_state_dict(params_from_jax(q["params"], model.cfg))
    ids = np.random.default_rng(2).integers(1, 500, size=(1, 16))
    want = np.asarray(fmodel.apply(jquant.dequantize_variables(q),
                                   jnp.asarray(ids, jnp.int32)))
    with torch.inference_mode():
        got = qmodel(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def _requests(mod):
    rng = np.random.default_rng(11)
    return [mod.Request("a", rng.integers(1, 500, size=7).tolist(), 6),
            mod.Request("b", rng.integers(1, 500, size=13).tolist(), 5),
            mod.Request("c", rng.integers(1, 500, size=5).tolist(), 4)]


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_engine_with_idle_rows_matches_jax_engine(pair, quant):
    """Three requests on four slots, so every decode pass carries idle
    rows that take part in the routing (its token count and cumulative
    order): the streams equal the JAX engine's, the same pass shapes,
    every logit row within ENGINE_LOGITS_ATOL."""
    fmodel, variables, model = pair
    geometry = dict(max_batch=4, max_seq=64, block_size=8, buckets=(16, 32),
                    quant=quant)
    teng = tengine.ServingEngine(model, tengine.EngineConfig(**geometry),
                                 device="cpu")
    jeng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **geometry, async_decode="off"))
    teng.capture_logits = jeng.capture_logits = True
    want = {c.rid: c for c in jeng.run(_requests(jengine))}
    got = {c.rid: c for c in teng.run(_requests(tengine))}
    assert set(got) == {"a", "b", "c"}
    for rid, c in got.items():
        assert c.tokens == want[rid].tokens, rid
        for i, (row, jrow) in enumerate(zip(teng.logit_log[rid],
                                            jeng.logit_log[rid])):
            np.testing.assert_allclose(row, np.asarray(jrow),
                                       atol=ENGINE_LOGITS_ATOL, rtol=0,
                                       err_msg=f"{rid} token {i}")
    assert teng.stats()["decode_steps"] == jeng.stats()["decode_steps"]


@pytest.mark.parametrize("chunk", [CHUNK, 1024])
def test_lm_step_with_aux_matches_jax(monkeypatch, pair, chunk):
    """Two AdamW steps of the MoE llama_tiny in fp32 with
    ``moe_aux_weight=0.01``, head folded (chunk 128 < vocab 512) or on
    the logits path: the losses include the aux term on both sides and
    match, as do the grad norms, and each parameter's update over the two
    steps: the norm of its difference from the JAX update over the JAX
    update's norm. Adam divides each gradient by its own magnitude, so
    an entry whose gradient is near zero moves by up to the learning
    rate whatever the sign of the two frameworks' rounding noise: entry
    by entry, one in about 1e5 lands 3e-6 to 7e-6 apart, past the
    optimizer tests' OPT_ATOL, so the update is held by its norm."""
    fmodel, variables, _ = pair
    monkeypatch.setenv("M2KT_CE_CHUNK", str(chunk))
    params = variables["params"]
    batches = np.random.default_rng(3).integers(0, 512, (2, 2, 16))
    state = jtrain.TrainState.create(
        apply_fn=fmodel.apply, params=jax.tree.map(jnp.asarray, params),
        tx=jtrain.instrument_optimizer(optax.adamw(1e-3, weight_decay=0.1)))
    jstep = jtrain.make_lm_train_step(
        make_mesh(MeshConfig(), devices=jax.devices()[:1]), remat=False,
        moe_aux_weight=0.01)
    want, wnorm = [], []
    for ids in batches:
        state, loss = jstep(state, {"input_ids": jnp.asarray(ids,
                                                             jnp.int32)})
        want.append(float(loss))
        wnorm.append(jtrain.grad_norm_from_state(state))
    _, tcfg = _cfgs("flash")
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg))
    opt = ttrain.instrument_optimizer(ttrain.adamw(model.parameters(), 1e-3,
                                                   0.1))
    tstate = ttrain.TrainState(model, opt)
    step = ttrain.make_lm_train_step(remat=True, chunk=chunk,
                                     moe_aux_weight=0.01)
    got, norm = [], []
    for ids in batches:
        tstate, loss = step(tstate, {"input_ids": torch.from_numpy(ids)})
        got.append(float(loss))
        norm.append(ttrain.grad_norm_from_state(tstate))
        assert model.moe_aux is None  # read and cleared by the step
    for a, b in zip(got + norm, want + wnorm):
        assert abs(a - b) / abs(b) < FP32_REL, (got, want, norm, wnorm)
    init = params_from_jax(params, tcfg)
    after = params_from_jax(jax.device_get(state.params), tcfg)
    for name, t in model.state_dict().items():
        want = after[name] - init[name]
        err = float(torch.linalg.vector_norm(t - after[name])
                    / torch.linalg.vector_norm(want))
        assert err < UPDATE_REL, (name, err)


def test_aux_weight_enters_the_loss(pair):
    """The step's loss is the LM loss plus 0.01 x the blocks' aux, on the
    same weights: weight 0 against 0.01 differs by exactly that."""
    _, variables, _ = pair
    _, tcfg = _cfgs("flash")
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 16)))
    losses = []
    for w in (0.0, 0.01):
        model = tllama.Llama(tcfg, device="cpu")
        model.load_state_dict(params_from_jax(variables["params"], tcfg))
        opt = ttrain.adam(model.parameters(), 0.0)
        _, loss = ttrain.make_lm_train_step(remat=False, moe_aux_weight=w)(
            ttrain.TrainState(model, opt), {"input_ids": ids})
        losses.append(float(loss))
    with torch.no_grad():
        model(ids)
    np.testing.assert_allclose(losses[1] - losses[0],
                               0.01 * float(model.moe_aux), rtol=1e-4)
