"""The port's checkpoints (``move2kube_tpu_torch/models/checkpoint.py``)
against the JAX package's contracts (``move2kube_tpu/models/
checkpoint.py``): a tiny Llama ``TrainState`` after two AdamW steps saves
and restores with equal bits and continues as the uninterrupted state
does; ``from_env`` gating; the corrupt-latest fallback in each of
``corrupt_latest``'s modes, side by side with the reference's orbax
manager on the same damage; restart from 0 when every step is corrupt;
``restore_variables``' ``ValueError`` naming the damaged step as the
reference's does; ``ported_restore``; a killed save left under its
temporary name is not taken as committed; ``max_to_keep``; the host
snapshot taken before ``maybe_save`` returns; and the exit flush captured
by a stand-in for ``threading._register_atexit``.

Every path lives under ``tmp_path``; env knobs go through ``monkeypatch``;
tracing is off, so no span reaches the process-wide recorder;
the SIGTERM handler, ``os.environ`` and the kernel build directory are
checked unchanged after every test.
"""

import dataclasses
import os
import re
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread
# torch sets TORCHINDUCTOR_CACHE_DIR in os.environ once, when _dynamo first
# loads (an optimizer's first step loads it): load it before any test
# snapshots the environment
import torch._dynamo  # noqa: E402,F401

from move2kube_tpu_torch.models import checkpoint as tckpt  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models.convert import init_llama  # noqa: E402
from move2kube_tpu_torch.ops import _build  # noqa: E402
from move2kube_tpu_torch.resilience import faults  # noqa: E402

LR = 1e-3


def _environ() -> dict:
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    handler = signal.getsignal(signal.SIGTERM)
    env = _environ()
    build = _build.build_dir()
    with pytest.MonkeyPatch.context() as mp:
        # tracing off: the saves' spans would land in the process-wide
        # recorder other tests in this process share
        mp.setenv("M2KT_TRACE", "0")
        yield
    assert signal.getsignal(signal.SIGTERM) == handler
    assert _environ() == env
    assert _build.build_dir() == build


def _state(seed: int = 0):
    cfg = dataclasses.replace(tllama.llama_tiny(), attn_impl="flash")
    model = init_llama(cfg, seed=seed, device="cpu", dtype=torch.float32)
    return ttrain.TrainState(
        model, ttrain.adamw(model.parameters(), LR, weight_decay=0.1))


def _batches(n: int = 3):
    rng = np.random.default_rng(7)
    return [{"input_ids": torch.from_numpy(rng.integers(0, 512, (2, 16)))}
            for _ in range(n)]


@pytest.fixture(scope="module")
def trained():
    """A tiny Llama after two AdamW steps, and the step function."""
    state = _state()
    step = ttrain.make_lm_train_step(remat=False, chunk=128)
    for batch in _batches()[:2]:
        state, _ = step(state, batch)
    return state, step


def _bits(state) -> dict:
    """Every parameter and Adam moment, as raw bytes."""
    out = {f"param/{n}": p.detach().numpy().tobytes()
           for n, p in state.model.named_parameters()}
    inner = state.optimizer.inner
    for i, p in enumerate(state.optimizer.params()):
        for key, val in inner.state[p].items():
            out[f"opt/{i}/{key}"] = val.detach().numpy().tobytes()
    return out


def _save(d, state, steps=(2, 4), every=2, **kw):
    mngr = tckpt.CheckpointManager(str(d), every=every, **kw)
    for s in steps:
        assert mngr.maybe_save(s, state)
    mngr.close()
    return mngr


def test_train_state_roundtrip_bits(tmp_path, trained):
    state, step = trained
    mngr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), every=2)
    assert not mngr.maybe_save(1, state)  # off the cadence
    assert mngr.maybe_save(2, state)
    mngr.close()
    assert mngr.latest_step() == 2
    assert not mngr.maybe_save(2, state, force=True)  # committed already
    fresh = _state(seed=1)
    assert _bits(fresh) != _bits(state)
    restored, start = tckpt.CheckpointManager(
        str(tmp_path / "ckpt")).restore_or_init(fresh)
    assert start == 2 and restored is fresh
    assert restored.step == state.step == 2
    assert restored.optimizer.count == state.optimizer.count == 2
    assert _bits(restored) == _bits(state)
    # the restored state continues as the saved one does, bit for bit
    batch = _batches()[2]
    cont = _state(seed=2)
    tckpt.CheckpointManager(str(tmp_path / "ckpt")).restore_or_init(cont)
    _, loss_a = step(restored, batch)
    _, loss_b = step(cont, batch)
    assert loss_a.numpy().tobytes() == loss_b.numpy().tobytes()
    assert _bits(restored) == _bits(cont)


def test_meta_and_loader_cursor(tmp_path, trained):
    state, _ = trained

    class Cursor:
        def position(self):
            return 6

    mngr = tckpt.CheckpointManager(str(tmp_path), every=3)
    assert mngr.maybe_save(3, state, loader=Cursor())
    mngr.wait()
    meta = tckpt._read_meta(str(tmp_path / "3"))
    assert meta["step"] == 3 and meta["kind"] == "train_state"
    assert meta["loader"] == 6
    assert meta["bytes"] == os.path.getsize(tmp_path / "3" / "state.pt")
    assert meta["arrays"]["model/embed.weight"]["shape"] == [512, 128]
    assert mngr.last_save["step"] == 3 and mngr.last_save["bytes"] > 0
    tckpt.CheckpointManager(str(tmp_path)).restore_or_init(_state(seed=3))
    other = tckpt.CheckpointManager(str(tmp_path))
    other.restore_or_init(_state(seed=3))
    assert other.restored["loader"] == 6


def test_from_env_gating(tmp_path, monkeypatch):
    monkeypatch.delenv("M2KT_CKPT_DIR", raising=False)
    assert tckpt.from_env() is None
    monkeypatch.setenv("M2KT_CKPT_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("M2KT_CKPT_EVERY", "7")
    mngr = tckpt.from_env()
    assert mngr is not None and mngr.every == 7
    assert mngr.directory == str(tmp_path / "c")
    monkeypatch.delenv("M2KT_CKPT_EVERY")
    assert tckpt.from_env(default_every=3).every == 3


def _jax_state():
    import jax
    import jax.numpy as jnp
    import optax
    from flax import linen as nn

    from move2kube_tpu.models import train as jtrain
    from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(4)(nn.relu(nn.Dense(8)(x)))

    mesh = make_mesh(MeshConfig(data=jax.device_count()))
    return jtrain.create_sharded_state(
        jax.random.PRNGKey(0), Tiny(), {"x": jnp.zeros((8, 8))},
        optax.sgd(1e-2), mesh)


@pytest.fixture(scope="module")
def jax_state():
    return _jax_state()


@pytest.mark.parametrize("mode", ["truncate", "scribble", "remove"])
def test_corrupt_latest_falls_back_like_the_reference(tmp_path, trained,
                                                       jax_state, mode):
    from move2kube_tpu.models import checkpoint as jckpt
    from move2kube_tpu.resilience import faults as jfaults

    state, _ = trained
    _save(tmp_path / "port", state)
    jd = tmp_path / "jax"
    jm = jckpt.CheckpointManager(str(jd), every=2)
    for s in (2, 4):
        assert jm.maybe_save(s, jax_state)
    jm.close()
    assert faults.corrupt_latest(str(tmp_path / "port"), mode=mode) == \
        jfaults.corrupt_latest(str(jd), mode=mode) == 4
    jm = jckpt.CheckpointManager(str(jd), every=2)
    _, jstart = jm.restore_or_init(jax_state)
    jm.close()
    fresh = _state(seed=1)
    restored, start = tckpt.CheckpointManager(
        str(tmp_path / "port")).restore_or_init(fresh)
    assert start == jstart == 2  # previous retained step, not 0, no crash
    assert _bits(restored) == _bits(state)


def test_all_corrupt_restarts_from_zero(tmp_path, trained):
    state, _ = trained
    d = tmp_path / "ckpt"
    _save(d, state)
    for _, sdir in faults.step_dirs(str(d)):
        os.remove(os.path.join(sdir, "state.pt"))
    fresh = _state(seed=1)
    before = _bits(fresh)
    restored, start = tckpt.CheckpointManager(str(d)).restore_or_init(fresh)
    assert start == 0 and restored is fresh
    assert _bits(fresh) == before  # a damaged step loads nothing


def test_corrupt_latest_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        faults.corrupt_latest(str(tmp_path))
    (tmp_path / "3").mkdir()
    with pytest.raises(FileNotFoundError, match="empty"):
        faults.corrupt_latest(str(tmp_path))


def test_killed_save_is_not_committed(tmp_path, trained):
    """A save killed mid-write leaves its temporary directory; it is never
    listed, restored, or damaged as the latest step."""
    state, _ = trained
    d = tmp_path / "ckpt"
    _save(d, state, steps=(2,))
    partial = d / ".4.tmp-12345"
    partial.mkdir()
    (partial / "state.pt").write_bytes(b"PK\x03\x04 half a zip")
    assert faults.step_dirs(str(d)) == [(2, str(d / "2"))]
    restored, start = tckpt.CheckpointManager(str(d)).restore_or_init(
        _state(seed=1))
    assert start == 2 and _bits(restored) == _bits(state)
    assert faults.corrupt_latest(str(d), mode="remove") == 2


def test_max_to_keep(tmp_path, trained):
    state, _ = trained
    _save(tmp_path, state, steps=(1, 2, 3, 4, 5), every=1, max_to_keep=2)
    assert [s for s, _ in faults.step_dirs(str(tmp_path))] == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["4", "5"]


def test_snapshot_is_taken_before_maybe_save_returns(tmp_path, trained,
                                                     monkeypatch):
    """The background writer writes the state as it was at the call, even
    when the loop updates the parameters in place right after."""
    state, _ = trained
    monkeypatch.delenv("M2KT_CKPT_SYNC", raising=False)
    real = tckpt.write_step

    def slow_write(*args, **kw):
        time.sleep(0.2)
        return real(*args, **kw)

    monkeypatch.setattr(tckpt, "write_step", slow_write)
    want = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    mngr = tckpt.CheckpointManager(str(tmp_path), every=1)
    assert mngr.maybe_save(1, state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    try:
        mngr.wait()
        payload = tckpt._load_payload(str(tmp_path / "1"))
        for n, t in want.items():
            assert torch.equal(payload["model"][n], t)
    finally:
        with torch.no_grad():
            for p in state.model.parameters():
                p.sub_(1.0)


def test_exit_flush_waits_for_the_save_in_flight(tmp_path, trained,
                                                 monkeypatch):
    state, _ = trained
    monkeypatch.delenv("M2KT_CKPT_SYNC", raising=False)
    hooks = []
    monkeypatch.setattr(threading, "_register_atexit", hooks.append)
    release = threading.Event()
    real = tckpt.write_step

    def held_write(*args, **kw):
        release.wait(timeout=60)
        return real(*args, **kw)

    monkeypatch.setattr(tckpt, "write_step", held_write)
    mngr = tckpt.CheckpointManager(str(tmp_path), every=2)
    mngr.install_exit_flush()
    assert len(hooks) == 1
    assert mngr.maybe_save(2, state)  # async: M2KT_CKPT_SYNC unset
    assert mngr.latest_step() is None
    threading.Timer(0.1, release.set).start()
    hooks[0]()  # what interpreter teardown runs
    assert mngr.latest_step() == 2


def test_sync_knob_blocks_until_committed(tmp_path, trained, monkeypatch):
    state, _ = trained
    monkeypatch.setenv("M2KT_CKPT_SYNC", "1")
    mngr = tckpt.CheckpointManager(str(tmp_path), every=2)
    assert mngr.maybe_save(2, state)
    assert mngr.latest_step() == 2 and mngr._thread is None


def test_failed_background_save_raises_on_wait(tmp_path, trained,
                                                monkeypatch):
    state, _ = trained
    monkeypatch.delenv("M2KT_CKPT_SYNC", raising=False)

    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "write_step", broken)
    mngr = tckpt.CheckpointManager(str(tmp_path), every=1)
    assert mngr.maybe_save(1, state)
    with pytest.raises(RuntimeError, match="disk full"):
        mngr.wait()
    mngr.wait()  # reported once


def test_ported_params_only_checkpoint_grafts_into_fresh_state(tmp_path,
                                                               trained):
    """A params-only tree loads the model and keeps the fresh optimizer,
    from step 0; ``ported_restore`` hands it to the caller's graft."""
    state, _ = trained
    params = {n: p.detach().clone()
              for n, p in state.model.state_dict().items()}
    mngr = tckpt.CheckpointManager(str(tmp_path), every=1)
    assert mngr.maybe_save(0, {"params": params}, force=True)
    mngr.close()
    fresh = _state(seed=1)
    restored, start = tckpt.CheckpointManager(str(tmp_path)) \
        .restore_or_init(fresh)
    assert start == 0 and restored.step == 0
    for n, t in restored.model.state_dict().items():
        assert torch.equal(t, params[n])
    assert not restored.optimizer.inner.state  # fresh Adam moments
    seen = {}

    def graft(st, flat):
        seen.update(flat)
        return st

    other = _state(seed=2)
    got, start = tckpt.CheckpointManager(str(tmp_path)).restore_or_init(
        other, ported_restore=(params, graft))
    assert got is other and start == 0 and set(seen) == set(params)
    bad = dict(params)
    bad["embed.weight"] = torch.zeros(3, 3)
    got, start = tckpt.CheckpointManager(str(tmp_path)).restore_or_init(
        other, ported_restore=(bad, graft))
    assert start == 0  # the shapes disagree: no step restores


def test_train_state_with_another_optimizer_loads_params_only(tmp_path,
                                                              trained):
    state, _ = trained
    _save(tmp_path, state, steps=(2,))
    cfg = dataclasses.replace(tllama.llama_tiny(), attn_impl="flash")
    model = init_llama(cfg, seed=4, device="cpu", dtype=torch.float32)
    sgd = ttrain.TrainState(model, ttrain.Optimizer(
        torch.optim.SGD(list(model.parameters())[:3], lr=0.1)))
    restored, start = tckpt.CheckpointManager(str(tmp_path)) \
        .restore_or_init(sgd)
    assert start == 0
    for n, t in restored.model.state_dict().items():
        assert torch.equal(t, state.model.state_dict()[n])


# -- restore_variables: the serving side --------------------------------------


def test_restore_variables_casts_onto_the_variables(tmp_path, trained):
    state, _ = trained
    _save(tmp_path, state, steps=(2,))
    serve = init_llama(dataclasses.replace(tllama.llama_tiny(),
                                           attn_impl="flash"),
                       seed=5, device="cpu", dtype=torch.bfloat16)
    dtypes = {n: t.dtype for n, t in serve.state_dict().items()}
    assert torch.bfloat16 in dtypes.values()
    out = tckpt.restore_variables(str(tmp_path), serve.state_dict())
    serve.load_state_dict(out)
    for n, t in serve.state_dict().items():
        assert t.dtype == dtypes[n]
        assert torch.equal(t, state.model.state_dict()[n].to(dtypes[n]))


def test_restore_variables_empty_dir_is_first_boot(tmp_path, trained):
    state, _ = trained
    variables = state.model.state_dict()
    assert tckpt.restore_variables(str(tmp_path / "empty"), variables) \
        is variables
    (tmp_path / "exists").mkdir()
    assert tckpt.restore_variables(str(tmp_path / "exists"), variables) \
        is variables


def test_restore_variables_unreadable_dir(tmp_path, trained):
    state, _ = trained
    bogus = tmp_path / "not-a-dir"
    bogus.write_text("i am a file where a directory should be")
    with pytest.raises(ValueError, match="unreadable"):
        tckpt.restore_variables(str(bogus / "ckpt"),
                                state.model.state_dict())


@pytest.mark.parametrize("mode", ["truncate", "remove", "scribble"])
def test_restore_variables_corrupt_store_names_damage_like_the_reference(
        tmp_path, mode):
    """The same damage to a params-only step 0 raises the same clean
    ``ValueError`` on both sides, naming the step."""
    import jax.numpy as jnp

    from move2kube_tpu.models import checkpoint as jckpt
    from move2kube_tpu.resilience import faults as jfaults

    jvars = {"params": {"w": jnp.arange(8.0), "b": jnp.ones((2, 3))}}
    jd = str(tmp_path / "jax")
    jm = jckpt.CheckpointManager(jd, every=1)
    jm.maybe_save(0, {"params": jvars["params"]}, force=True)
    jm.wait()
    jm.close()
    jfaults.corrupt_latest(jd, mode=mode)
    with pytest.raises(ValueError, match="restorable") as jerr:
        jckpt.restore_variables(jd, jvars)

    tvars = {"w": torch.arange(8.0), "b": torch.ones(2, 3)}
    td = str(tmp_path / "port")
    tm = tckpt.CheckpointManager(td, every=1)
    tm.maybe_save(0, {"params": tvars}, force=True)
    tm.close()
    faults.corrupt_latest(td, mode=mode)
    with pytest.raises(ValueError, match="restorable") as terr:
        tckpt.restore_variables(td, tvars)
    head = r"no retained checkpoint under '.*' is restorable; newest step 0: "
    assert re.match(head, str(jerr.value))
    assert re.match(head, str(terr.value))
    assert "step 0" in str(terr.value)


def test_restore_variables_names_the_bad_arrays(tmp_path, trained):
    state, _ = trained
    _save(tmp_path, state, steps=(2,))
    variables = dict(state.model.state_dict())
    variables["extra.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match=r"newest step 2: missing array\(s\) "
                                         r"\['extra.weight'\]"):
        tckpt.restore_variables(str(tmp_path), variables)
    variables = dict(state.model.state_dict())
    variables["embed.weight"] = torch.zeros(3, 128)
    with pytest.raises(ValueError, match=r"shape-mismatched array\(s\) "
                                         r"\['embed.weight'\]"):
        tckpt.restore_variables(str(tmp_path), variables)


def test_restore_variables_falls_back_to_an_older_step(tmp_path, trained):
    state, _ = trained
    _save(tmp_path, state, steps=(2, 4))
    faults.corrupt_latest(str(tmp_path), mode="scribble")
    out = tckpt.restore_variables(str(tmp_path), state.model.state_dict())
    for n, t in state.model.state_dict().items():
        assert torch.equal(out[n], t)
