"""The port's chunked prefill against the JAX package's: the final chunk's
logits equal the whole prefill's and the JAX chunked engine's, running
streams are unchanged, short prompts skip chunking, and spec decode turns
chunking off."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402

# logits, port engine vs JAX engine and chunked vs whole prefill, fp32 on
# the CPU: the full-forward bound of tests/test_torch_llama.py (and the
# JAX package's own chunked-vs-whole bound, tests/test_sched.py)
ENGINE_LOGITS_ATOL = 1e-4

GEOMETRY = dict(max_batch=4, max_seq=128, block_size=8, buckets=(16, 64))


@pytest.fixture(scope="module")
def parts():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash")
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                               attn_impl="flash")
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    return fmodel, variables, model.eval()


def _port(model, **over):
    eng = tengine.ServingEngine(model, tengine.EngineConfig(
        **{**GEOMETRY, **over}), device="cpu")
    eng.capture_logits = True
    return eng


def _jax(fmodel, variables, **over):
    eng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **{**GEOMETRY, "async_decode": "off", **over}))
    eng.capture_logits = True
    return eng


def _mix(mod, seed, long_len=40):
    """Three short prompts (never chunked at chunk 16) and one long one,
    admitted together."""
    rng = np.random.default_rng(seed)
    reqs = [mod.Request(f"s{i}", rng.integers(1, 200, size=n).tolist(), 8)
            for i, n in enumerate((5, 16, 11))]
    reqs.append(mod.Request("long", rng.integers(
        1, 200, size=long_len).tolist(), 6))
    return reqs


@pytest.mark.parametrize("chunk,long_len", [(16, 40), (16, 48), (24, 63),
                                            (32, 33)])
def test_final_chunk_logits_equal_whole_prefill_and_jax(parts, chunk,
                                                        long_len):
    """The chunked prompt's logit rows (the final chunk's, then each decode
    step's) are within ENGINE_LOGITS_ATOL of the whole prefill's and of
    the JAX chunked engine's; the running streams and every stream are
    the same on all three, and so are the chunk counters."""
    fmodel, variables, model = parts
    over = dict(admit_burst=0)
    whole = _port(model, **over)
    want = {c.rid: c.tokens for c in whole.run(_mix(tengine, 3, long_len))}
    ours = _port(model, **over, chunk_prefill=chunk)
    got = {c.rid: c.tokens for c in ours.run(_mix(tengine, 3, long_len))}
    jeng = _jax(fmodel, variables, **over, chunk_prefill=chunk)
    jgot = {c.rid: c.tokens for c in jeng.run(_mix(jengine, 3, long_len))}
    assert got == want == jgot
    rows, wrows, jrows = (e.logit_log["long"] for e in (ours, whole, jeng))
    assert len(rows) == len(wrows) == len(jrows) == 6
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row, wrows[i], atol=ENGINE_LOGITS_ATOL,
                                   rtol=0, err_msg=f"row {i} vs whole")
        np.testing.assert_allclose(row, np.asarray(jrows[i]),
                                   atol=ENGINE_LOGITS_ATOL, rtol=0,
                                   err_msg=f"row {i} vs jax")
    for rid in ("s0", "s1", "s2"):
        for a, b in zip(ours.logit_log[rid], whole.logit_log[rid]):
            np.testing.assert_allclose(a, b, atol=ENGINE_LOGITS_ATOL,
                                       rtol=0)
    stats = ours.stats()
    assert stats["chunked_prefills"] == jeng.stats()["chunked_prefills"] == 1
    assert stats["passes"]["chunk"] == long_len
    assert stats["passes"]["prefill"] == 3
    assert stats["prefills"] == 4
    assert ours._allocator.available == ours.cache_cfg.num_pages - 1


def test_chunking_slot_sits_out_decode(parts):
    """While its chunks land, the chunking slot takes no decode row, its
    seq_len tracks the landed prefix, the running slots' seq_lens advance
    by one a step, and one chunk runs a step."""
    _, _, model = parts
    eng = _port(model, admit_burst=0, chunk_prefill=16)
    for r in _mix(tengine, 4, long_len=40):
        eng.submit(r)
    eng.step()  # admits all four, one decode step, the first chunk
    chunk_slot = next(i for i, s in enumerate(eng._slots) if s.chunking)
    lens = eng._cache["seq_lens"].tolist()
    assert lens[chunk_slot] == 16
    running = [i for i in range(4) if i != chunk_slot]
    assert [lens[i] for i in running] == [len(eng._slots[i].req.prompt) + 1
                                          for i in running]
    assert [len(eng._slots[i].tokens) for i in running] == [2, 2, 2]
    eng.step()
    assert eng._cache["seq_lens"][chunk_slot] == 32
    eng.step()  # the final chunk (8 tokens): the first token lands
    slot = eng._slots[chunk_slot]
    assert not slot.chunking and len(slot.tokens) == 1
    assert eng._cache["seq_lens"][chunk_slot] == 40
    assert eng.stats()["passes"]["chunk"] == 40


def test_short_prompts_skip_chunking(parts):
    _, _, model = parts
    eng = _port(model, chunk_prefill=16)
    out = eng.run([tengine.Request("r", list(range(1, 17)), 4)])[0]
    assert len(out.tokens) == 4
    stats = eng.stats()
    assert stats["chunked_prefills"] == 0 and stats["passes"]["chunk"] == 0


def test_one_chunk_job_at_a_time(parts):
    """A second long prompt waits for the chunk job in flight (the
    reference's one-job rule); both complete, the second's stream equal
    to the whole-prefill engine's."""
    _, _, model = parts
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 200, size=n).tolist() for n in (30, 41)]
    eng = _port(model, admit_burst=0, chunk_prefill=16)
    for i, p in enumerate(prompts):
        eng.submit(tengine.Request(f"l{i}", p, 3))
    eng.step()
    assert len(eng._pending) == 1 and eng.stats()["chunked_prefills"] == 1
    got = {c.rid: c.tokens for c in eng.run([])}
    want = {c.rid: c.tokens for c in _port(model).run(
        [tengine.Request(f"l{i}", p, 3) for i, p in enumerate(prompts)])}
    assert got == want and eng.stats()["chunked_prefills"] == 2


def test_spec_turns_chunking_off(parts, capsys):
    _, _, model = parts
    eng = _port(model, chunk_prefill=16, spec_k=2)
    assert eng.chunk_prefill == 0 and "chunked_prefills" not in eng.stats()
    assert "disabling chunked prefill" in capsys.readouterr().out
    out = eng.run([tengine.Request("r", list(range(1, 41)), 3)])[0]
    assert len(out.tokens) == 3 and eng.stats()["passes"]["chunk"] == 0


def test_chunked_admission_counts_as_prefix_miss(parts):
    """With the prefix cache on, a chunked prompt is not donated to the
    cache and counts as a miss, as in the reference."""
    fmodel, variables, model = parts
    over = dict(chunk_prefill=16, prefix_cache=True)
    prompt = list(range(3, 43))
    ours = _port(model, **over)
    ours.run([tengine.Request("a", prompt, 2), tengine.Request("b", prompt,
                                                                2)])
    jeng = _jax(fmodel, variables, **over)
    jeng.run([jengine.Request("a", prompt, 2), jengine.Request("b", prompt,
                                                                2)])
    ts, js = ours.stats(), jeng.stats()
    for key in ("prefix_hits", "prefix_misses", "prefix_cache_pages",
                "chunked_prefills"):
        assert ts[key] == js[key], key
    assert ts["prefix_misses"] == 2 and ts["prefix_cache_pages"] == 0
