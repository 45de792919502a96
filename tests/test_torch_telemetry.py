"""The port's ``StepTelemetry`` against the JAX package's
(``move2kube_tpu/models/train.py``): two steps of a tiny Llama on each
side, recorded with the same wall times, render the same families,
labels and help strings, with equal values (up to the two frameworks'
fp32 rounding) except those that depend on the device; a non-finite
step writes the same ``<flight>.numerics`` forensics and edge-triggers
the watchdog once on both sides.

Every test builds its own registries, passes ``tracer=False`` (no
process-wide recorder), and sets the flight path through
``monkeypatch`` under ``tmp_path``.
"""

import dataclasses
import re

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
from move2kube_tpu.obs import metrics as jmetrics  # noqa: E402
from move2kube_tpu.obs import numerics as jnum  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models import precision as tprec  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from move2kube_tpu_torch.obs import numerics as tnum  # noqa: E402

CHUNK = 128
LR = 1e-3
# losses, grad norms and the group summaries of two fp32 steps: the two
# frameworks' kernels in other orders (tests/test_torch_train.py's
# FP32_REL), with an absolute floor for values near zero
VALUE_REL = 1e-5
VALUE_ATOL = 1e-7
# families whose values depend on the device, not on the step
DEVICE_VALUED = ("m2kt_train_device_live_bytes",)
SECONDS = (0.5, 0.25)


class _Watchdog:
    def __init__(self):
        self.nonfinite = 0
        self.steps = []

    def note_nonfinite(self):
        self.nonfinite += 1

    def observe_step(self, seconds):
        self.steps.append(seconds)


@pytest.fixture(scope="module")
def flax_init():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash")
    ids = np.random.default_rng(0).integers(0, 512, (2, 4, 32))
    params = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                     jnp.asarray(ids[0, :2]))["params"]
    return jax.device_get(params), ids


def _jax_run(monkeypatch, params, batches, poison=None):
    monkeypatch.setenv("M2KT_CE_CHUNK", str(CHUNK))
    pol = jprec.policy("fp32")
    cfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                              attn_impl="flash")
    tx = jtrain.instrument_optimizer(pol.wrap_optimizer(optax.adam(LR)))
    if poison is not None:
        params = poison(jax.tree.map(np.array, params))
    state = jtrain.TrainState.create(
        apply_fn=jllama.Llama(cfg).apply,
        params=jax.tree.map(jnp.asarray, params), tx=tx)
    step = jtrain.make_lm_train_step(
        make_mesh(MeshConfig(), devices=jax.devices()[:1]), remat=False,
        precision=pol)
    reg = jmetrics.Registry()
    telem = jtrain.StepTelemetry(registry=reg, items_per_step=128,
                                 tracer=False)
    telem.watchdog = _Watchdog()
    telem.record_precision(pol)
    for i, (ids, seconds) in enumerate(zip(batches, SECONDS), 1):
        state, loss = step(state, {"input_ids": jnp.asarray(ids, jnp.int32)})
        telem.record_step(i, seconds, loss=float(loss), state=state)
    return reg, telem


def _port_run(params, batches, poison=None):
    pol = tprec.policy("fp32")
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                              attn_impl="flash")
    if poison is not None:
        params = poison(jax.tree.map(np.array, params))
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    opt = ttrain.instrument_optimizer(pol.wrap_optimizer(
        ttrain.adam(model.parameters(), LR)))
    state = ttrain.TrainState(model, opt)
    step = ttrain.make_lm_train_step(remat=False, precision=pol, chunk=CHUNK)
    reg = tmetrics.Registry()
    telem = ttrain.StepTelemetry(registry=reg, items_per_step=128,
                                 tracer=False)
    telem.watchdog = _Watchdog()
    telem.record_precision(pol)
    for i, (ids, seconds) in enumerate(zip(batches, SECONDS), 1):
        state, loss = step(state, {"input_ids": torch.from_numpy(ids)})
        telem.record_step(i, seconds, loss=float(loss), state=state)
    return reg, telem


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")


def _parse(text):
    meta, samples = [], {}
    for line in text.splitlines():
        if line.startswith("#"):
            meta.append(line)
            continue
        name, labels, value = _SAMPLE.match(line).groups()
        samples[(name, labels or "")] = float(value)
    return meta, samples


def _assert_same_render(ours, theirs):
    meta, samples = _parse(ours)
    jmeta, jsamples = _parse(theirs)
    assert meta == jmeta
    assert samples.keys() == jsamples.keys()
    for key, value in samples.items():
        if key[0].startswith(DEVICE_VALUED):
            continue
        want = jsamples[key]
        if np.isinf(want) or np.isnan(want):
            assert value == want or (np.isnan(want) and np.isnan(value)), key
        else:
            assert value == pytest.approx(want, rel=VALUE_REL,
                                          abs=VALUE_ATOL), key


def test_two_steps_render_as_the_reference(flax_init, monkeypatch,
                                           tmp_path):
    monkeypatch.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "flight.json"))
    params, ids = flax_init
    jreg, jtelem = _jax_run(monkeypatch, params, ids)
    treg, ttelem = _port_run(params, ids)
    text = treg.render()
    _assert_same_render(text, jreg.render())
    assert 'm2kt_train_tensor_rms{group="layer_1",kind="grad"}' in text
    assert ttelem.watchdog.steps == jtelem.watchdog.steps == list(SECONDS)
    assert ttelem.watchdog.nonfinite == jtelem.watchdog.nonfinite == 0
    assert not (tmp_path / "flight.json.numerics").exists()


def _poison_layer_1(params):
    params["layer_1"]["gate_up"]["kernel"][3, 3] = np.inf
    return params


def test_nonfinite_step_writes_the_same_forensics(flax_init, monkeypatch,
                                                  tmp_path):
    params, ids = flax_init
    monkeypatch.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "jax.json"))
    jreg, jtelem = _jax_run(monkeypatch, params, ids, _poison_layer_1)
    monkeypatch.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "port.json"))
    treg, ttelem = _port_run(params, ids, _poison_layer_1)
    theirs = jnum.read_sidecar(str(tmp_path / "jax.json.numerics"))
    ours = tnum.read_sidecar(str(tmp_path / "port.json.numerics"))
    assert ours["first_bad_group"] == theirs["first_bad_group"]
    assert ours["step"] == theirs["step"] == 2
    assert ours["loss_nonfinite"] == theirs["loss_nonfinite"]
    assert list(ours["groups"]) == list(theirs["groups"])
    for group, fields in ours["groups"].items():
        for field in ("grad_nonfinite", "param_nonfinite"):
            assert fields[field] == theirs["groups"][group][field], (
                group, field)
    # a non-finite step on each of the two steps, one edge each
    assert ttelem.watchdog.nonfinite == jtelem.watchdog.nonfinite == 2
    counter = "m2kt_train_nonfinite_steps_total"
    assert _parse(treg.render())[1][(counter, "")] == (
        _parse(jreg.render())[1][(counter, "")]) == 2.0


def test_skipped_updates_and_loss_scale(flax_init, monkeypatch, tmp_path):
    """Under ``bf16-scaled`` a guard-skipped update counts in
    ``m2kt_train_skipped_steps_total`` and the loss scale is exported, as
    the reference does (the loss scale gauge, then one skip)."""
    monkeypatch.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "flight.json"))
    params, ids = flax_init
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                              attn_impl="flash")
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    pol = tprec.policy("bf16-scaled")
    opt = ttrain.instrument_optimizer(pol.wrap_optimizer(
        ttrain.adam(model.parameters(), LR)))
    state = ttrain.TrainState(model, opt)
    reg = tmetrics.Registry()
    telem = ttrain.StepTelemetry(registry=reg, tracer=False)
    telem.record_precision(pol)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    model.layers[0].down.weight.grad[0, 0] = float("inf")
    assert opt.step() is False
    telem.record_step(1, 0.1, loss=1.0, state=state)
    _, samples = _parse(reg.render())
    assert samples[("m2kt_train_skipped_steps_total", "")] == 1.0
    assert samples[("m2kt_train_loss_scale", "")] == pol.loss_scale
    assert samples[("m2kt_train_tensor_nonfinite",
                    '{group="layer_0",kind="grad"}')] == 1.0


def test_timed_step_and_cost_model_families(flax_init, monkeypatch):
    """``timed_step`` with ``sync`` records the loss and the state;
    ``record_cost_model`` renders the reference's families (their values
    differ: XLA's count against torch's, and no peak bytes on the
    CPU), and the compile families stay at 0 in the port."""
    params, ids = flax_init
    monkeypatch.setenv("M2KT_CE_CHUNK", str(CHUNK))
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                              attn_impl="flash")
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    opt = ttrain.instrument_optimizer(ttrain.adam(model.parameters(), LR))
    state = ttrain.TrainState(model, opt)
    step = ttrain.make_lm_train_step(remat=False, chunk=CHUNK)
    reg = tmetrics.Registry()
    telem = ttrain.StepTelemetry(registry=reg, items_per_step=64,
                                 tracer=False)
    batch = {"input_ids": torch.from_numpy(ids[0])}
    state, loss = telem.timed_step(1, step, state, batch, sync=True)
    telem.record_cost_model(step, state, batch)
    assert state.step == 1
    telem.timed_step(2, step, state, batch, sync=False)
    meta, samples = _parse(reg.render())
    assert samples[("m2kt_train_steps_total", "")] == 2.0
    assert samples[("m2kt_train_loss", "")] == pytest.approx(float(loss))
    # registered, never incremented: no sample yet
    assert "# TYPE m2kt_train_compile_events_total counter" in meta
    assert ("m2kt_train_compile_events_total", "") not in samples
    assert samples[("m2kt_train_step_flops", "")] > 0
    assert samples[("m2kt_train_mfu", "")] > 0
    # no card: the device-memory gauge reads 0 once recorded
    assert ("m2kt_train_device_live_bytes", "") not in samples
    telem.record_device_memory()
    _, samples = _parse(reg.render())
    assert samples[("m2kt_train_device_live_bytes", "")] == 0.0

    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash")
    tx = jtrain.instrument_optimizer(optax.adam(LR))
    jstate = jtrain.TrainState.create(
        apply_fn=jllama.Llama(jcfg).apply,
        params=jax.tree.map(jnp.asarray, params), tx=tx)
    jstep = jtrain.make_lm_train_step(
        make_mesh(MeshConfig(), devices=jax.devices()[:1]), remat=False)
    jbatch = {"input_ids": jnp.asarray(ids[0], jnp.int32)}
    jreg = jmetrics.Registry()
    jtelem = jtrain.StepTelemetry(registry=jreg, items_per_step=64,
                                  tracer=False)
    jstate, _ = jtelem.timed_step(1, jstep, jstate, jbatch, sync=True)
    jtelem.record_cost_model(jstep, jstate, jbatch)
    jtelem.timed_step(2, jstep, jstate, jbatch, sync=False)
    families = {line for line in _parse(reg.render())[0]}
    jfamilies = {line for line in _parse(jreg.render())[0]}
    assert families == jfamilies
