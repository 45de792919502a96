"""The port's multi-LoRA against the JAX package's: the adapter store's
refcounts, rejections and directory loading on the same operations; the
logit delta in the model's full, prefill and decode modes; and engines
serving a batch that mixes adapters and the base model, stream by stream
against single-adapter runs and the JAX engine (``async_decode="off"``).
Adapters cross as numpy arrays: the same A/B are registered on both
sides, and the stacks hold the same bits."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving import sched as jsched  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import sched as tsched  # noqa: E402

GEOMETRY = dict(max_batch=4, max_seq=64, block_size=8, buckets=(16, 32))
# logits with the LoRA delta, port vs flax, fp32: two frameworks'
# matmuls summed in other orders over 2 layers, plus the delta's two
# products
LORA_ATOL = 1e-4


@pytest.fixture(scope="module")
def parts():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="dense")
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, 8), jnp.int32))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                               attn_impl="dense")
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    return fmodel, variables, model.eval()


def _adapter(seed, rank, cfg, scale=0.1):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(cfg.d_model, rank)) * scale).astype(np.float32)
    b = (rng.normal(size=(rank, cfg.vocab_size)) * scale).astype(np.float32)
    return a, b


ADAPTERS = {"fin": (31, 4), "legal": (32, 2), "med": (33, 8)}


def _prompt(seed, n=10):
    return np.random.default_rng(seed).integers(1, 200, size=n).tolist()


def _pair(parts, adapters=ADAPTERS, **over):
    fmodel, variables, model = parts
    cfg = {**GEOMETRY, "max_loras": 3, "lora_rank": 8, **over}
    teng = tengine.ServingEngine(
        model, tengine.EngineConfig(**cfg, async_decode="off"), device="cpu")
    jeng = jengine.ServingEngine(
        fmodel, variables, jengine.EngineConfig(**cfg, async_decode="off"))
    for name in adapters:
        a, b = _adapter(*ADAPTERS[name], model.cfg)
        assert teng.register_adapter(name, a, b) == jeng.register_adapter(
            name, a, b)
    return teng, jeng


def test_adapter_store_matches_jax(tmp_path):
    """The same registrations, acquires, releases and unregistrations on
    both stores: the same rows, refcounts, names, versions and errors,
    and stacks of the same bits."""
    d, v = 8, 16
    stores = (tsched.AdapterStore(d_model=d, vocab=v, rank=4, max_loras=2),
              jsched.AdapterStore(d_model=d, vocab=v, rank=4, max_loras=2))
    rng = np.random.default_rng(5)
    a = rng.normal(size=(d, 3)).astype(np.float32)
    b = rng.normal(size=(3, v)).astype(np.float32)
    trace = {}
    for store in stores:
        seen = []

        def attempt(fn, *args):
            try:
                seen.append(("ok", fn(*args)))
            except (ValueError, KeyError) as err:
                seen.append((type(err).__name__,))

        attempt(store.register, "fin", a, b)
        attempt(store.register, "fin", a, b)       # duplicate
        attempt(store.register, "", a, b)          # no name
        attempt(store.register, "wide", np.ones((d, 5)), np.ones((5, v)))
        attempt(store.register, "bad", np.ones((d + 1, 2)), np.ones((2, v)))
        attempt(store.register, "law", a[:, :2], b[:2])
        attempt(store.register, "full", a, b)      # store full
        attempt(store.acquire, "fin")
        attempt(store.acquire, "fin")
        attempt(store.acquire, "")
        attempt(store.acquire, "nobody")
        seen.append(("ref", store.refcount(1), store.refcount(2)))
        store.unregister("fin")
        seen.append(("ref", store.refcount(1), store.names, store.version))
        store.release(1)
        store.release(1)
        store.release(0)
        seen.append(("ref", store.refcount(1), store.names, store.version))
        attempt(store.register, "again", a, b)
        trace[store] = seen
    assert trace[stores[0]] == trace[stores[1]]
    assert trace[stores[0]][0] == ("ok", 1)
    np.testing.assert_array_equal(stores[0]._a, stores[1]._a)
    np.testing.assert_array_equal(stores[0]._b, stores[1]._b)
    ta, tb = stores[0].stacks()
    ja, jb = stores[1].stacks()
    assert ta.dtype == torch.float32 and ta.device.type == "cpu"
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert stores[0].stacks()[0] is ta  # cached per registry version


def test_adapter_store_load_dir_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    np.savez(tmp_path / "good.npz", a=rng.normal(size=(8, 2)),
             b=rng.normal(size=(2, 16)))
    np.savez(tmp_path / "wrong.npz", a=np.ones((7, 2)), b=np.ones((2, 16)))
    np.savez(tmp_path / "nob.npz", a=np.ones((8, 2)))
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    (tmp_path / "skip.txt").write_text("ignored")
    out = {}
    for mod in (tsched, jsched):
        store = mod.AdapterStore(d_model=8, vocab=16, rank=4, max_loras=4)
        warned = []
        n = store.load_dir(str(tmp_path), warn=warned.append)
        out[mod] = (n, store.names, [w.split(":")[0] for w in warned],
                    store._a.copy(), store._b.copy())
    t, j = out[tsched], out[jsched]
    assert t[:3] == j[:3] and t[0] == 1 and len(t[2]) == 3
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(t[4], j[4])


@pytest.mark.parametrize("mode", ["full", "prefill"])
def test_delta_logits_match_flax(parts, mode):
    """The model's ``lora=`` operand in full and prefill mode, on a batch
    of three rows (base, and two adapters padded to rank 8), against
    the flax model with the same stacks."""
    fmodel, variables, model = parts
    cfg = model.cfg
    a = np.zeros((3, cfg.d_model, 8), np.float32)
    b = np.zeros((3, 8, cfg.vocab_size), np.float32)
    for row, name in ((1, "fin"), (2, "med")):
        ai, bi = _adapter(*ADAPTERS[name], cfg)
        a[row, :, :ai.shape[1]], b[row, :bi.shape[0]] = ai, bi
    rows = np.array([2, 0, 1], np.int32)
    ids = np.random.default_rng(7).integers(1, 500, size=(3, 16))
    kw = {"return_kv": True} if mode == "prefill" else {}
    want = fmodel.apply(variables, jnp.asarray(ids, jnp.int32),
                        lora=(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(rows)), **kw)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), lora=(
            torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(rows).long()), **kw)
    if mode == "prefill":
        (got, got_kv), (want, want_kv) = got, want
        for (tk, tv), (jk, jv) in zip(got_kv, want_kv):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       atol=LORA_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LORA_ATOL, rtol=0)


def test_prefill_and_decode_rows_match_the_jax_engine(parts):
    """Engine level: each adapter stream's prefill row and every decode
    row (the model's decode mode, the adapter gathered by slot) against
    the JAX engine's, within LORA_ATOL, streams identical."""
    teng, jeng = _pair(parts)
    mods = (tengine, jengine)
    mix = ["fin", "", "med", "legal"]
    out = {}
    for eng, mod in zip((teng, jeng), mods):
        eng.capture_logits = True
        done = eng.run([mod.Request(f"r{i}", _prompt(40 + i), 6, adapter=nm)
                        for i, nm in enumerate(mix)])
        out[mod] = {c.rid: c.tokens for c in done}
    assert out[tengine] == out[jengine]
    for rid in out[tengine]:
        rows_t, rows_j = teng.logit_log[rid], jeng.logit_log[rid]
        assert len(rows_t) == len(rows_j) == 6
        for rt, rj in zip(rows_t, rows_j):
            np.testing.assert_allclose(rt, rj, atol=LORA_ATOL, rtol=0)
    assert teng.stats()["lora_adapters"] == jeng.stats()["lora_adapters"] == 3
    for name in ADAPTERS:
        row = teng.adapters.acquire(name)
        assert teng.adapters.refcount(row) == 2  # registration + this
        teng.adapters.release(row)


def test_mixed_batch_streams_equal_single_adapter_runs(parts):
    """A batch of the base model and three adapters on one prompt: each
    stream equals a dedicated engine serving only its adapter, the base
    row equals an engine without LoRA, and the JAX engine's batch."""
    _, _, model = parts
    prompt = _prompt(22)
    mix = ["", "fin", "legal", "med"]
    teng, jeng = _pair(parts)
    got = {}
    for eng, mod in zip((teng, jeng), (tengine, jengine)):
        done = eng.run([mod.Request(f"r{i}", list(prompt), 6, adapter=nm)
                        for i, nm in enumerate(mix)])
        got[mod] = {c.rid: c.tokens for c in done}
    assert got[tengine] == got[jengine]
    for i, name in enumerate(mix):
        if name:
            ded, _ = _pair(parts, adapters=(name,), max_loras=1)
        else:
            ded = tengine.ServingEngine(
                model, tengine.EngineConfig(**GEOMETRY), device="cpu")
        want = ded.run([tengine.Request("x", list(prompt), 6,
                                        adapter=name)])[0].tokens
        assert got[tengine][f"r{i}"] == want, name
    assert len({tuple(t) for t in got[tengine].values()}) > 1


def test_chunked_prefill_carries_the_adapter(parts):
    """A chunked prompt under an adapter: its chunk passes gather the
    adapter's row, so its stream equals the unchunked one's and the JAX
    engine's chunked run."""
    prompt = _prompt(50, 28)
    got = {}
    for chunk in (0, 8):
        teng, jeng = _pair(parts, chunk_prefill=chunk)
        for eng, mod in zip((teng, jeng), (tengine, jengine)):
            done = eng.run([
                mod.Request("long", list(prompt), 5, adapter="med"),
                mod.Request("short", _prompt(51, 6), 5, adapter="fin")])
            got[(chunk, mod)] = {c.rid: c.tokens for c in done}
        if chunk:
            assert teng.stats()["chunked_prefills"] == 1
    assert got[(8, tengine)] == got[(0, tengine)] == got[(8, jengine)]


def test_refcounts_released_and_unknown_adapters_rejected(parts):
    teng, jeng = _pair(parts, adapters=("fin",))
    for eng, mod in zip((teng, jeng), (tengine, jengine)):
        with pytest.raises(ValueError, match="unknown adapter"):
            eng.submit(mod.Request("r", _prompt(24), 2, adapter="nobody"))
        out = eng.run([mod.Request("r", _prompt(24), 2, adapter="fin")])
        assert len(out[0].tokens) == 2
        assert eng.adapters.refcount(1) == 1  # only the registration's
        eng.adapters.unregister("fin")
        assert eng.adapters.refcount(1) == 0
    plain = tengine.ServingEngine(parts[2], tengine.EngineConfig(**GEOMETRY),
                                  device="cpu")
    with pytest.raises(ValueError, match="serves no adapters"):
        plain.submit(tengine.Request("r", _prompt(24), 2, adapter="fin"))
    with pytest.raises(ValueError, match="serves no adapters"):
        plain.register_adapter("fin", *_adapter(31, 4, parts[2].cfg))
    assert "lora_adapters" not in plain.stats()


def test_shed_request_releases_its_adapter(parts):
    teng, _ = _pair(parts, adapters=("fin",), max_batch=1)
    # queued behind a stream that holds the only slot (no decode history
    # yet, so the deadline is admitted), it expires while it waits
    teng.submit(tengine.Request("busy", _prompt(25), 8))
    teng.submit(tengine.Request("late", _prompt(26), 2, adapter="fin",
                                deadline_s=1e-4))
    assert teng.adapters.refcount(1) == 2
    done = {c.rid: c for c in teng.run([])}
    assert done["late"].finish_reason == "shed"
    assert teng.adapters.refcount(1) == 1


def test_spec_decode_turns_lora_off(parts, capsys):
    """Spec decode and LoRA exclude each other, with the reference's
    warning: the engine keeps spec decode and serves no adapters."""
    fmodel, variables, model = parts
    cfg = dict(GEOMETRY, spec_k=2, max_loras=2)
    teng = tengine.ServingEngine(
        model, tengine.EngineConfig(**cfg, async_decode="off"), device="cpu")
    ours = capsys.readouterr().out
    jeng = jengine.ServingEngine(
        fmodel, variables, jengine.EngineConfig(**cfg, async_decode="off"))
    theirs = capsys.readouterr().out
    assert "disabling multi-LoRA" in ours
    assert ours.splitlines()[0] == theirs.splitlines()[0]
    assert teng.adapters is None and jeng.adapters is None
    assert teng.max_loras == jeng.max_loras == 0 and teng.spec_k == 2


def test_disagg_handoff_with_an_adapter_is_rejected(parts):
    """A handoff carries base-model K/V and a first token argmaxed
    without the delta: both engines refuse it, and count the refusal."""
    teng, jeng = _pair(parts, adapters=("fin",))
    for eng, mod in zip((teng, jeng), (tengine, jengine)):
        kv = [(np.zeros((1, 16, 2, 32), np.float32),) * 2] * 2
        with pytest.raises(ValueError, match="adapter"):
            eng.install_prefilled(
                mod.Request("d", _prompt(27), 4, adapter="fin"), kv, 3, 10)
        assert 'm2kt_serve_rejected_total 1' in eng.registry.render()
        assert not eng.has_work()
