"""The port's LM training step, precision policies and optimizers against
the JAX package's (``move2kube_tpu/models/train.py``, ``precision.py``,
optax).

Both sides start from the flax init carried over with ``params_from_jax``
at fp32 (the master weights) and take the same numpy batches. The vocab
(512) is wider than the chunk (128), so both fold the lm-head into the
chunked loss: the JAX side through ``M2KT_CE_CHUNK=128`` and its ``auto``
ladder, the port through ``chunk=128``. Everything runs on the CPU, where
the port's flash attention takes its plain forward and backward.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.models import precision as jprec  # noqa: E402
from move2kube_tpu.models import train as jtrain  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu.source.validate import DEFAULT_GATES  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models import precision as tprec  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402

# fp32 step: losses and the first grad norm, two frameworks' kernels over
# 2 layers and 3 Adam updates
FP32_REL = 1e-5
# optimizer updates on the same grads: fp32 arithmetic in two orders.
# Relative to the parameter, plus an absolute term for small parameters:
# optax's own fp32 Adam is 2e-7 off a float64 one after 3 updates at lr
# 1e-2 (bias corrections in fp32)
OPT_REL = 1e-6
OPT_ATOL = 1e-6
CHUNK = 128
LR = 1e-3
WD = 0.1


def _gate(name):
    return DEFAULT_GATES[name]


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture(scope="module")
def flax_init():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash")
    ids = np.random.default_rng(0).integers(0, 512, (3, 4, 32))
    params = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                     jnp.asarray(ids[0, :2]))["params"]
    return jax.device_get(params), ids


def _port_state(params, policy_name):
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                              attn_impl="flash")
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    opt = ttrain.instrument_optimizer(tprec.policy(policy_name)
                                      .wrap_optimizer(ttrain.adamw(
                                          model.parameters(), LR, WD)))
    return ttrain.TrainState(model, opt)


def _jax_run(monkeypatch, params, batches, policy_name, grad_accum=1):
    monkeypatch.setenv("M2KT_CE_CHUNK", str(CHUNK))
    pol = jprec.policy(policy_name)
    cfg = pol.apply_to_model_config(dataclasses.replace(
        jllama.llama_tiny(), attn_impl="flash"))
    tx = jtrain.instrument_optimizer(
        pol.wrap_optimizer(optax.adamw(LR, weight_decay=WD)))
    state = jtrain.TrainState.create(
        apply_fn=jllama.Llama(cfg).apply,
        params=jax.tree.map(jnp.asarray, params), tx=tx)
    step = jtrain.make_lm_train_step(
        make_mesh(MeshConfig(), devices=jax.devices()[:1]), remat=False,
        grad_accum=grad_accum, precision=pol)
    losses, norms = [], []
    for ids in batches:
        state, loss = step(state, {"input_ids": jnp.asarray(ids, jnp.int32)})
        losses.append(float(loss))
        norms.append(jtrain.grad_norm_from_state(state))
    return losses, norms


def _port_run(params, batches, policy_name, grad_accum=1, remat=False):
    state = _port_state(params, policy_name)
    step = ttrain.make_lm_train_step(
        remat=remat, grad_accum=grad_accum,
        precision=tprec.policy(policy_name), chunk=CHUNK)
    losses, norms = [], []
    for ids in batches:
        state, loss = step(state, {"input_ids": torch.from_numpy(ids)})
        losses.append(float(loss))
        norms.append(ttrain.grad_norm_from_state(state))
    return losses, norms, state


# ------------------------------------------------------------ policies

def test_precision_policies_match_jax():
    assert tprec.PRECISION_OPTIONS == jprec.PRECISION_OPTIONS
    for name in tprec.PRECISION_OPTIONS:
        ours, theirs = tprec.policy(name), jprec.policy(name)
        assert ours.name == theirs.name
        assert str(ours.compute_dtype) == f"torch.{theirs.compute_dtype}"
        assert str(ours.param_dtype) == f"torch.{theirs.param_dtype}"
        assert ours.loss_scale == theirs.loss_scale
    with pytest.raises(ValueError):
        tprec.policy("fp16")
    for kw in ({}, {"env": {"M2KT_PRECISION": "fp32"}},
               {"default": "fp32", "env": {"M2KT_PRECISION": "banana"}},
               {"env": {"M2KT_PRECISION": "bf16-scaled",
                        "M2KT_LOSS_SCALE": "256"}},
               {"env": {"M2KT_LOSS_SCALE": "oops"}}):
        kw.setdefault("env", {})
        ours, theirs = tprec.from_env(**kw), jprec.from_env(**kw)
        assert (ours.name, ours.loss_scale) == (theirs.name,
                                                theirs.loss_scale), kw


def test_precision_cast_scale_and_model_config():
    bf16 = tprec.policy("bf16")
    params = {"w": torch.ones(2, 2), "n": torch.tensor([3])}
    cast = bf16.cast_params(params)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["n"].dtype == torch.int64  # non-float passes through
    assert tprec.policy("fp32").cast_params(params) is params
    scaled = tprec.policy("bf16-scaled")
    loss = torch.tensor(2.0)
    assert float(scaled.unscale(scaled.scale_loss(loss))) == 2.0
    assert float(bf16.scale_loss(loss)) == 2.0
    grads = [torch.full((2,), 1024.0)]
    assert scaled.unscale(grads)[0].tolist() == [1.0, 1.0]
    cfg = bf16.apply_to_model_config(
        dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32))
    assert cfg.dtype == torch.bfloat16
    assert bf16.apply_to_model_config("x") == "x"
    opt = ttrain.adam([torch.zeros(1, requires_grad=True)], 1e-3)
    assert bf16.wrap_optimizer(opt).guard is None
    assert scaled.wrap_optimizer(opt).guard.max_consecutive_errors == 10


# ---------------------------------------------------------- optimizers

def _param_pair(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def _grad_seq(n, seed=1, poison=()):
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(n):
        g = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
        if i in poison:
            g["a"][1, 2] = poison[i]
        seq.append(g)
    return seq


def _run_both(tx, opt_factory, grads_seq, check=None):
    """Apply the same grads with optax and with a port Optimizer; return
    per-step (optax params, port params) and the two final states."""
    jp = {k: jnp.asarray(v) for k, v in _param_pair().items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in _param_pair().items()}
    opt = opt_factory(list(tp.values()))
    for i, g in enumerate(grads_seq):
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=OPT_REL,
                                       atol=OPT_ATOL,
                                       err_msg=f"step {i} {k}")
        if check is not None:
            check(i, js, opt)
    return js, opt


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adam_and_adamw_match_optax(kind):
    """torch's Adam/AdamW against optax's over 6 updates: eps outside the
    square root, bias correction, and AdamW's decoupled decay on every
    parameter."""
    tx = optax.adamw(1e-2, weight_decay=WD) if kind == "adamw" else (
        optax.adam(1e-2))

    def factory(ps):
        return (ttrain.adamw(ps, 1e-2, WD) if kind == "adamw"
                else ttrain.adam(ps, 1e-2))

    _run_both(tx, factory, _grad_seq(6))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_default_optimizer_matches_optax(weight_decay):
    """Warmup-cosine Adam(W): the schedule's value at every count, and the
    updates over 8 steps that cross the warmup (3) into the cosine."""
    kw = dict(lr=1e-2, weight_decay=weight_decay, warmup_steps=3,
              total_steps=10)
    sched = ttrain.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10)
    jsched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10)
    for count in range(14):
        np.testing.assert_allclose(sched(count), float(jsched(count)),
                                   rtol=OPT_REL, atol=1e-12)
    _run_both(jtrain.default_optimizer(**kw),
              lambda ps: ttrain.default_optimizer(ps, **kw), _grad_seq(8))


def test_finite_guard_matches_optax_apply_if_finite():
    """optax.apply_if_finite(adamw, 10) on finite, NaN and Inf grads, then
    11 NaNs in a row: the rejected updates leave params and the Adam
    count alone, the counters agree, and the 11th non-finite update in a
    row is applied (optax gives up; it does not raise)."""
    poison = {1: np.nan, 2: np.inf, 3: -np.inf}
    poison.update({i: np.nan for i in range(5, 16)})
    grads = _grad_seq(17, poison=poison)
    tx = optax.apply_if_finite(optax.adamw(1e-2, weight_decay=WD), 10)
    pol = dataclasses.replace(tprec.policy("fp32"), loss_scale=2.0)
    applied = []

    def check(i, js, opt):
        adam_state = js.inner_state[0]
        assert opt.guard.notfinite_count == int(js.notfinite_count), i
        assert opt.guard.total_notfinite == int(js.total_notfinite), i
        assert opt.guard.last_finite == bool(js.last_finite), i
        assert opt.count == int(adam_state.count), i
        p0 = opt.params()[0]
        assert int(opt.inner.state[p0]["step"]) == int(adam_state.count)
        applied.append(opt.count)

    _run_both(tx, lambda ps: pol.wrap_optimizer(ttrain.adamw(ps, 1e-2, WD)),
              grads, check)
    # updates applied: 0 (finite), skipped 1-3, 4 (finite), skipped 5-14,
    # 15 (the 11th in a row: given up on), 16
    assert applied == [1, 1, 1, 1, 2] + [2] * 10 + [3, 4]


def test_skipped_updates_and_streak_read_the_guard():
    pol = tprec.policy("bf16-scaled")
    p = torch.zeros(3, requires_grad=True)
    opt = pol.wrap_optimizer(ttrain.instrument_optimizer(ttrain.adamw(
        [p], 1e-2, WD)))
    state = ttrain.TrainState(torch.nn.Linear(1, 1), opt)
    assert tprec.skipped_updates(state) == 0
    p.grad = torch.tensor([1.0, float("nan"), 0.0])
    assert opt.step() is False
    assert torch.equal(p.detach(), torch.zeros(3))
    assert tprec.skipped_updates(state) == 1
    assert tprec.notfinite_streak(opt) == 1
    # the grad norm is recorded even on the skipped update
    assert np.isnan(ttrain.grad_norm_from_state(state))
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    assert opt.step() is True
    assert tprec.notfinite_streak(state) == 0
    assert ttrain.grad_norm_from_state(opt) == 5.0
    plain = ttrain.TrainState(torch.nn.Linear(1, 1),
                              ttrain.adam([p], 1e-3))
    assert tprec.skipped_updates(plain) is None
    assert ttrain.grad_norm_from_state(plain) is None


# ------------------------------------------------------------ the step

def test_lm_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 9, 300)).astype(np.float32)
    ids = rng.integers(0, 300, (2, 9)).astype(np.int32)
    want = float(jtrain.lm_loss(jnp.asarray(logits), jnp.asarray(ids)))
    got = float(ttrain.lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(ids)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    chunked = float(ttrain.lm_loss(torch.from_numpy(logits),
                                   torch.from_numpy(ids), chunk=100))
    np.testing.assert_allclose(chunked, want, atol=1e-6)


def test_step_fp32_matches_jax(monkeypatch, flax_init):
    """3 AdamW steps at fp32: the loss trajectory and the first grad norm
    within 1e-5 relative."""
    params, ids = flax_init
    want, wnorm = _jax_run(monkeypatch, params, ids, "fp32")
    got, norm, _ = _port_run(params, ids, "fp32")
    for a, b in zip(got, want):
        assert _rel(a, b) < FP32_REL, (got, want)
    assert _rel(norm[0], wnorm[0]) < FP32_REL, (norm, wnorm)


@pytest.mark.parametrize("policy_name", ["bf16", "bf16-scaled"])
def test_step_bf16_within_validate_gates(monkeypatch, flax_init,
                                         policy_name):
    """bf16 compute on fp32 masters (every float param cast, norms and
    head included): the port's trajectory against the JAX step's in the
    same policy within the source/validate.py gates; the scaled policy
    gives the bf16 numbers within the same gates, with nothing skipped."""
    params, ids = flax_init
    want, wnorm = _jax_run(monkeypatch, params, ids, policy_name)
    got, norm, state = _port_run(params, ids, policy_name)
    plain, pnorm, _ = _port_run(params, ids, "bf16")
    for a, b, c in zip(got, want, plain):
        assert _rel(a, b) < _gate("loss_max_rel")
        assert _rel(a, c) < _gate("loss_max_rel")
    assert _rel(norm[0], wnorm[0]) < _gate("grad_norm_max_rel")
    assert _rel(norm[0], pnorm[0]) < _gate("grad_norm_max_rel")
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(p.grad.dtype == torch.float32
               for p in state.model.parameters())
    if policy_name == "bf16-scaled":
        assert tprec.skipped_updates(state) == 0


def test_grad_accum_matches_jax_step_accum(monkeypatch, flax_init):
    """grad_accum=2 on [2, 2, 32] microbatches equals the JAX step_accum
    at fp32: grads and losses averaged over the microbatches."""
    params, ids = flax_init
    batches = [b.reshape(2, 2, 32) for b in ids[:2]]
    want, wnorm = _jax_run(monkeypatch, params, batches, "fp32",
                           grad_accum=2)
    got, norm, _ = _port_run(params, batches, "fp32", grad_accum=2)
    for a, b in zip(got, want):
        assert _rel(a, b) < FP32_REL, (got, want)
    assert _rel(norm[0], wnorm[0]) < FP32_REL
    step = ttrain.make_lm_train_step(grad_accum=2, chunk=CHUNK)
    with pytest.raises(ValueError, match="grad_accum"):
        step(_port_state(params, "fp32"), {"input_ids": torch.from_numpy(
            ids[0])})


@pytest.mark.parametrize("policy_name", ["fp32", "bf16"])
def test_remat_recomputes_and_gives_the_same_losses(monkeypatch, flax_init,
                                                    policy_name):
    """Per-block checkpointing recomputes each block's forward (one more
    flash forward per layer per step) on the same cast weights, and the
    losses and grad norms do not move."""
    params, ids = flax_init
    calls = []
    real = tatt.flash_attention_fwd
    monkeypatch.setattr(tatt, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    plain, pnorm, _ = _port_run(params, ids[:2], policy_name, remat=False)
    n_plain, calls[:] = len(calls), []
    remat, rnorm, _ = _port_run(params, ids[:2], policy_name, remat=True)
    layers = tllama.llama_tiny().num_layers
    assert n_plain == 2 * layers and len(calls) == 2 * 2 * layers
    np.testing.assert_allclose(remat, plain, rtol=1e-6)
    np.testing.assert_allclose(rnorm, pnorm, rtol=1e-6)


def test_step_without_head_folding_uses_logits(flax_init):
    """A chunk as wide as the vocab takes the logits path (the JAX
    ladder's auto for a one-chunk vocab): the same loss as folding."""
    params, ids = flax_init
    losses = []
    for chunk in (CHUNK, 512):
        state = _port_state(params, "fp32")
        step = ttrain.make_lm_train_step(remat=False, chunk=chunk)
        losses.append(float(step(state, {"input_ids": torch.from_numpy(
            ids[0])})[1]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
