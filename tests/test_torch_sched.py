"""The port's scheduler plane against the JAX package's: tenant-spec
parsing, merging and token buckets on the same inputs (malformed ones
included), the admission controller's throttle counts, and priority
preemption driven by hand (``submit``/``step``, no sleeping) on both
engines, with the same victims, completions and tokens."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.obs.metrics import Registry as JRegistry  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving import sched as jsched  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs.metrics import Registry  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import sched as tsched  # noqa: E402

GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32))
SPEC = "gold:prio=high;free:prio=besteffort"
# a resumed stream's logits against the uninterrupted run's, fp32: the
# resume prefills prompt + journal where the uninterrupted run decoded
# those positions one at a time, sums in other orders
RESUME_ATOL = 1e-4

SPECS = [
    "gold:prio=high,rate=50,burst=100;free:prio=besteffort;flat:",
    "ok:prio=high;bad:prio=emperor;worse:rate=minusfive;:prio=high",
    "a:rate=-1;b:burst=2,rate=3;b:prio=standard;c:color=red;;d",
    "",
]
SPLITS = [
    ("gold:besteffort;free:besteffort", "gold:1/1;free:5/10"),
    ("a:high;b:king", "a:3/6;c:fast/loose;:1/1;d:-1/2"),
    ("", ""),
]


def _policies(pols):
    return {n: (p.name, p.priority, p.rate, p.burst, p.priority_class)
            for n, p in pols.items()}


@pytest.mark.parametrize("spec", SPECS)
def test_parse_tenant_spec_matches_jax(spec):
    ours, theirs = [], []
    got = tsched.parse_tenant_spec(spec, warn=ours.append)
    want = jsched.parse_tenant_spec(spec, warn=theirs.append)
    assert _policies(got) == _policies(want)
    assert ours == theirs


@pytest.mark.parametrize("combined", SPECS[:2])
@pytest.mark.parametrize("priorities,quotas", SPLITS)
def test_merge_split_specs_matches_jax(combined, priorities, quotas):
    ours, theirs = [], []
    got = tsched.merge_split_specs(
        tsched.parse_tenant_spec(combined, warn=lambda m: None),
        priorities, quotas, warn=ours.append)
    want = jsched.merge_split_specs(
        jsched.parse_tenant_spec(combined, warn=lambda m: None),
        priorities, quotas, warn=theirs.append)
    assert _policies(got) == _policies(want)
    assert ours == theirs


def test_token_bucket_golden_matches_jax():
    """The same takes at the same injected clock readings give the same
    admits and the same fractional balances."""
    script = ([0.0] * 5 + [1.0] * 3 + [100.0] * 5 + [100.25] * 2
              + [100.9, 101.3, 101.3])
    out = {}
    for mod in (tsched, jsched):
        now = [0.0]
        bucket = mod.TokenBucket(rate=2.0, burst=4.0, clock=lambda: now[0])
        seen = []
        for t in script:
            now[0] = t
            seen.append((bucket.take(), round(bucket.tokens, 12)))
        out[mod] = seen
    assert out[tsched] == out[jsched]
    assert [ok for ok, _ in out[tsched][:5]] == [True] * 4 + [False]


def test_admission_controller_throttle_counts_match_jax():
    lines = {}
    for mod, reg_cls in ((tsched, Registry), (jsched, JRegistry)):
        now = [0.0]
        reg = reg_cls()
        adm = mod.AdmissionController.from_specs(
            tenants="gold:rate=1,burst=2;free:prio=besteffort",
            quotas="free:0.5/1", registry=reg, clock=lambda: now[0])
        results = []
        for t, tenant in ((0.0, "gold"), (0.0, "gold"), (0.0, "gold"),
                          (0.0, "anon"), (0.0, "free"), (0.5, "free"),
                          (1.0, "gold"), (2.5, "free"), (2.5, "free")):
            now[0] = t
            try:
                adm.admit(tenant)
                results.append(True)
            except mod.SchedThrottled:
                results.append(False)
        assert issubclass(mod.SchedThrottled, ValueError)
        prio = [adm.priority(t) for t in ("gold", "free", "", "anon")]
        lines[mod] = (results, prio, adm.distinct_priorities(),
                      [ln for ln in reg.render().splitlines()
                       if ln.startswith("m2kt_sched_throttled_total")])
    assert lines[tsched] == lines[jsched]
    # the combined spec names "free", so its split quota does not apply
    # (the combined spec wins): only gold's third take is throttled
    assert lines[tsched][0] == [True, True, False, True, True, True,
                                True, True, True]
    assert lines[tsched][3] == [
        'm2kt_sched_throttled_total{reason="quota"} 1']
    flat = tsched.AdmissionController.from_specs(tenants="a:rate=5,burst=5")
    assert not flat.distinct_priorities()
    assert not tsched.AdmissionController.from_specs().configured


# ----------------------------------------------------------------------
# preemption, driven by hand on both engines
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def parts():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="dense")
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                               attn_impl="dense")
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    return fmodel, variables, model.eval()


def _pair(parts, **over):
    fmodel, variables, model = parts
    cfg = {**GEOMETRY, **over}
    teng = tengine.ServingEngine(
        model, tengine.EngineConfig(**cfg, async_decode="off"), device="cpu")
    jeng = jengine.ServingEngine(
        fmodel, variables, jengine.EngineConfig(**cfg, async_decode="off"))
    return teng, jeng


def _prompt(seed, n=10):
    return np.random.default_rng(seed).integers(1, 200, size=n).tolist()


def _completions(done):
    return {c.rid: (c.finish_reason, c.tokens) for c in done}


def _preempted_lines(eng):
    return sorted(ln for ln in eng.registry.render().splitlines()
                  if ln.startswith("m2kt_sched_preempted_total"))


def test_preempt_by_hand_matches_jax(parts):
    """Two best-effort streams hold both slots; a gold arrival evicts the
    most recently admitted one. Both engines pick the same victim, emit
    the same "preempted" Completion (partial tokens, a prefix of the
    uninterrupted stream) and the same tokens for every stream."""
    got = {}
    for eng, mod in zip(_pair(parts, sched_tenants=SPEC),
                        (tengine, jengine)):
        eng.submit(mod.Request("be1", _prompt(5), 12, tenant="free"))
        eng.submit(mod.Request("be2", _prompt(5, 9), 12, tenant="free"))
        done = []
        for _ in range(4):
            done += eng.step()
        assert not done
        eng.submit(mod.Request("gold", _prompt(6), 2, tenant="gold"))
        while eng.has_work():
            done += eng.step()
        got[mod] = (_completions(done), eng.stats()["preempted"],
                    _preempted_lines(eng))
    assert got[tengine] == got[jengine]
    comps, preempted, lines = got[tengine]
    assert comps["be2"][0] == "preempted" and 0 < len(comps["be2"][1]) < 12
    assert comps["be1"][0] == "length" and len(comps["gold"][1]) == 2
    assert preempted == 1
    assert lines == ['m2kt_sched_preempted_total{reason="slots"} 1']
    truth = tengine.ServingEngine(
        parts[2], tengine.EngineConfig(**GEOMETRY), device="cpu").run(
            [tengine.Request("t", _prompt(5, 9), 12)])[0].tokens
    assert truth[:len(comps["be2"][1])] == comps["be2"][1]


def test_preempted_completion_carries_weights_version(parts):
    teng, _ = _pair(parts, sched_tenants=SPEC)
    teng.install_weights(parts[2].state_dict(), version=7)
    teng.submit(tengine.Request("be1", _prompt(5), 12, tenant="free"))
    teng.submit(tengine.Request("be2", _prompt(5, 9), 12, tenant="free"))
    teng.step()
    teng.step()
    teng.submit(tengine.Request("gold", _prompt(6), 1, tenant="gold"))
    done = {c.rid: c for c in teng.run([])}
    assert done["be2"].finish_reason == "preempted"
    assert {c.weights_version for c in done.values()} == {7}


def _steal_pages(eng, keep):
    """Take every free page but ``keep`` out of the engine's pool."""
    return eng._allocator.alloc(eng._allocator.available - keep)


def test_alloc_preempting_under_page_pressure_matches_jax(parts):
    """A free slot but too few free pages: the gold admission preempts
    the best-effort stream for its pages (reason "pages"), on both
    engines alike; the free-slot path never preempts."""
    got = {}
    for eng, mod in zip(_pair(parts, max_batch=3, sched_tenants=SPEC),
                        (tengine, jengine)):
        eng.submit(mod.Request("be1", _prompt(7), 20, tenant="free"))
        done = eng.step() + eng.step()
        stolen = _steal_pages(eng, keep=1)
        eng.submit(mod.Request("gold", _prompt(8), 4, tenant="gold"))
        done += eng.step()
        eng._allocator.free(stolen)
        while eng.has_work():
            done += eng.step()
        got[mod] = (_completions(done), _preempted_lines(eng))
    assert got[tengine] == got[jengine]
    assert got[tengine][0]["be1"][0] == "preempted"
    assert got[tengine][1] == [
        'm2kt_sched_preempted_total{reason="pages"} 1']


def test_alloc_preempting_respects_the_reclaimable_gate(parts):
    """A victim none of whose pages would return to the pool (all
    shared) is kept running: the allocation fails, nothing is
    preempted, on both engines."""
    got = {}
    for eng, mod in zip(_pair(parts, max_batch=3, sched_tenants=SPEC),
                        (tengine, jengine)):
        eng.submit(mod.Request("be1", _prompt(7), 20, tenant="free"))
        eng.step()
        stolen = _steal_pages(eng, keep=1)
        eng._allocator.reclaimable = lambda pages: 0
        gold = mod.Request("gold", _prompt(8), 4, tenant="gold")
        eng.submit(gold)
        pages, pre = eng._alloc_preempting(gold, 3)
        got[mod] = (pages, pre, eng.stats()["preempted"])
        eng._allocator.free(stolen)
    assert got[tengine] == got[jengine] == (None, [], 0)


def test_no_preemption_without_distinct_priorities(parts):
    """A flat (or empty) tenant spec never preempts: the gold request
    waits its turn on both engines, with the same streams, and no
    "preempted" key in the stats."""
    got = {}
    for spec in ("", "gold:prio=standard;free:prio=standard,rate=9,burst=9"):
        for eng, mod in zip(_pair(parts, sched_tenants=spec),
                            (tengine, jengine)):
            eng.submit(mod.Request("be1", _prompt(5), 6, tenant="free"))
            eng.submit(mod.Request("be2", _prompt(5, 9), 6, tenant="free"))
            eng.step()
            eng.step()
            eng.submit(mod.Request("late", _prompt(6), 2, tenant="gold"))
            done = _completions(eng.run([]))
            assert {r for r, _ in done.values()} == {"length"}
            assert "preempted" not in eng.stats()
            got[(spec, mod)] = done
        assert got[(spec, tengine)] == got[(spec, jengine)]


def test_resume_of_prompt_plus_journal_is_token_exact(parts):
    """What the router's resume does: a preempted stream's prompt plus
    its journal, submitted again for the remaining tokens, continues the
    uninterrupted stream token for token, its logits within
    RESUME_ATOL."""
    model = parts[2]
    cfg = tengine.EngineConfig(**{**GEOMETRY, "sched_tenants": SPEC})
    prompt, n = _prompt(12), 14
    full = tengine.ServingEngine(model, cfg, device="cpu")
    full.capture_logits = True
    truth = full.run([tengine.Request("t", list(prompt), n)])[0].tokens

    eng = tengine.ServingEngine(model, cfg, device="cpu")
    eng.submit(tengine.Request("first", _prompt(11, 12), n, tenant="free"))
    # admitted second, so the most recent best-effort slot: the victim
    eng.submit(tengine.Request("victim", list(prompt), n, tenant="free"))
    for _ in range(5):
        eng.step()
    eng.submit(tengine.Request("gold", _prompt(13), 3, tenant="gold"))
    done = {c.rid: c for c in eng.run([])}
    assert done["victim"].finish_reason == "preempted"
    journal = done["victim"].tokens
    k = len(journal)
    assert 0 < k < n and truth[:k] == journal
    resumed = tengine.ServingEngine(model, cfg, device="cpu")
    resumed.capture_logits = True
    out = resumed.run([tengine.Request("r", list(prompt) + journal,
                                       n - k)])[0]
    assert journal + out.tokens == truth
    rows = resumed.logit_log["r"]
    assert len(rows) == n - k
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row, full.logit_log["t"][k + i],
                                   atol=RESUME_ATOL, rtol=0)


def test_engine_config_reads_the_sched_knobs(monkeypatch):
    monkeypatch.setenv("M2KT_SCHED_TENANTS", "gold:prio=high")
    monkeypatch.setenv("M2KT_SCHED_PRIORITIES", "free:besteffort")
    monkeypatch.setenv("M2KT_SCHED_QUOTAS", "free:1/2")
    monkeypatch.setenv("M2KT_SCHED_MAX_LORAS", "not-a-number")
    monkeypatch.setenv("M2KT_LORA_RANK", "0")
    monkeypatch.setenv("M2KT_QUANT_AUDIT_RATE", "7")
    ours = tengine.EngineConfig.from_env()
    theirs = jengine.EngineConfig.from_env()
    for field in ("sched_tenants", "sched_priorities", "sched_quotas",
                  "max_loras", "lora_rank", "quant_audit_rate"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert (ours.max_loras, ours.lora_rank, ours.quant_audit_rate) == (
        0, 1, 1.0)
