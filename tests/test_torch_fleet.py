"""The port's fleet router against the JAX package's: placement (the same
prompts land on the same replica names), failover with a probe that
brings the replica back, spill, hedging, all-down, the HTTP front, the
in-process fleet end to end with prefix hits, over-quota throttling, a
chaos kill mid-stream, and a preempted stream resumed token-exactly from
the router's journal. The preemption is driven by hand: the replica's
worker thread is not started, and the test steps the engine itself.

Every join and wait here has a bound."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving.fleet import router as jrouter  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving.fleet import router as trouter  # noqa: E402
from move2kube_tpu_torch.serving.fleet.chaos import (  # noqa: E402
    ChaosConfig,
    ServingChaos,
)
from move2kube_tpu_torch.serving.sched import SchedThrottled  # noqa: E402

GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32))
SPEC = "gold:prio=high;free:prio=besteffort"
WAIT_S = 30.0  # bound on every wait for another thread in this file


class FakeReplica:
    """A replica handle with no engine, for placement drills; fits both
    routers' duck type."""

    def __init__(self, name, depth=0.0):
        self.name = name
        self.depth = depth
        self.calls = 0
        self.fail_next = 0
        self.hold_s = 0.0
        self.up = True

    def generate(self, prompt, max_new_tokens=None, rid=None, tenant="",
                 traceparent="", deadline_s=None, on_token=None):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError(f"{self.name}: injected failure")
        if self.hold_s:
            time.sleep(self.hold_s)
        self.calls += 1
        if on_token is not None:
            for t in (1, 2):
                on_token(t)
        return {"rid": rid or "r", "replica": self.name,
                "prompt_len": len(prompt), "tokens": [1, 2],
                "finish_reason": "length"}

    def queue_depth(self):
        return self.depth

    def healthy(self):
        return self.up


def _fake_router(mod=trouter, n=3, **cfg):
    replicas = [FakeReplica(f"rep-{i}") for i in range(n)]
    return mod.Router(replicas, config=mod.RouterConfig(**cfg)), replicas


def _close(router):
    for r in router.replicas:
        r.close()


def test_placement_matches_the_jax_router():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 32000, size=int(n)).tolist()
               for n in rng.integers(1, 40, size=64)]
    for salt in ("", "tenant-salt"):
        for k in (4, 16):
            for p in prompts:
                assert trouter.prefix_hash(p, salt, k) == (
                    jrouter.prefix_hash(p, salt, k))
    for names in (["replica-0", "replica-1"],
                  ["a", "b", "c", "d", "e"]):
        ours = trouter.Router([FakeReplica(n) for n in names])
        theirs = jrouter.Router([FakeReplica(n) for n in names])
        for p in prompts:
            assert ours.pick(p).name == theirs.pick(p).name
    # rendezvous: removing a replica moves only the keys it owned
    ours = trouter.Router([FakeReplica(n) for n in ("a", "b", "c")])
    fewer = trouter.Router([FakeReplica(n) for n in ("a", "c")])
    for p in prompts:
        if ours.pick(p).name != "b":
            assert fewer.pick(p).name == ours.pick(p).name


def test_failover_marks_down_and_the_probe_brings_it_back():
    router, replicas = _fake_router()
    prompt = list(range(10))
    affine = router.pick(prompt)
    affine.fail_next = 1
    out = router.generate(prompt)
    assert out["replica"] != affine.name
    assert router._retries.value == 1 and router._up[affine.name] is False
    assert ('m2kt_router_marked_down_total{replica="%s",reason='
            '"runtimeerror"} 1' % affine.name) in router.registry.render()
    assert router.probe()[affine.name] is True
    assert router.generate(prompt)["replica"] == affine.name


def test_spill_on_a_deep_queue():
    router, replicas = _fake_router(spill_queue_depth=2.0)
    prompt = list(range(30, 40))
    affine = router.pick(prompt)
    affine.depth = 10.0
    others = [r for r in replicas if r.name != affine.name]
    others[0].depth, others[1].depth = 1.0, 3.0
    assert router.pick(prompt).name == others[0].name
    assert router._spills.value >= 1


def test_hedging_fires_and_the_first_answer_wins():
    router, _ = _fake_router(hedge_after_s=0.05)
    prompt = list(range(5))
    affine = router.pick(prompt)
    affine.hold_s = 0.5
    t0 = time.perf_counter()
    out = router.generate(prompt)
    assert out["replica"] != affine.name and router._hedges.value == 1
    assert time.perf_counter() - t0 < 0.5


def test_all_replicas_down_raises():
    router, replicas = _fake_router(max_retries=1)
    for r in replicas:
        r.fail_next = 5
    with pytest.raises(RuntimeError):
        router.generate([1, 2, 3])
    assert router._requests.labels(outcome="error").value == 1
    empty = trouter.Router([FakeReplica("x")])
    empty._up["x"] = False
    with pytest.raises(RuntimeError, match="no healthy replica"):
        empty.generate([1, 2])


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def test_http_front():
    router, _ = _fake_router(sched_tenants="slow:rate=0.001,burst=1")
    srv = trouter.RouterHTTPServer(router, port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"

        def post(body, tenant=""):
            req = urllib.request.Request(
                f"{base}/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json",
                         trouter.TENANT_HEADER: tenant})
            with urllib.request.urlopen(req, timeout=10) as resp:
                return json.loads(resp.read().decode())

        assert post({"prompt": [1, 2, 3], "max_new_tokens": 2})[
            "tokens"] == [1, 2]
        assert post({"prompt": [4]}, tenant="slow")["tokens"] == [1, 2]
        with pytest.raises(urllib.error.HTTPError) as err:
            post({"prompt": [4]}, tenant="slow")
        assert err.value.code == 429
        assert _get(f"{base}/healthz") == (200, '{"status":"ok"}')
        code, body = _get(f"{base}/readyz")
        assert code == 200 and json.loads(body)["ready"] is True
        code, text = _get(f"{base}/metrics")
        assert "m2kt_router_requests_total" in text
        assert 'm2kt_sched_throttled_total{reason="quota"} 1' in text
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{base}/nowhere")
        assert err.value.code == 404
    finally:
        srv.close()


# ----------------------------------------------------------------------
# fleets of real engines
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


def _prompt(seed, n=12):
    return np.random.default_rng(seed).integers(1, 200, size=n).tolist()


def _golden(model, prompt, n):
    return tengine.ServingEngine(
        model, tengine.EngineConfig(**GEOMETRY), device="cpu").run(
            [tengine.Request("g", list(prompt), n)])[0].tokens


def test_in_process_fleet_end_to_end_with_prefix_hits(parts):
    """Two port replicas behind the router: a tenant's requests stick to
    one replica and hit its prefix cache; every stream equals the JAX
    fleet's for the same prompts, on the same replica names."""
    fmodel, variables, model = parts
    cfg = dict(GEOMETRY, prefix_cache=True)
    # longer than the 16 tokens the affinity hash reads
    tenants = [_prompt(41, 20), _prompt(42, 24)]
    out = {}
    for mod, build in (
            (trouter, lambda: trouter.build_fleet(
                model, 2, tengine.EngineConfig(**cfg), device="cpu")),
            (jrouter, lambda: jrouter.build_fleet(
                fmodel, variables, 2, engine_config=jengine.EngineConfig(
                    **cfg, async_decode="off")))):
        router = build()
        try:
            got = [router.generate(list(p) + [i + 1], 3)
                   for p in tenants for i in range(3)]
            hits = sum(r.engine.stats().get("prefix_hits", 0)
                       for r in router.replicas)
        finally:
            _close(router)
        out[mod] = ([(o["replica"], o["tokens"]) for o in got], hits)
    assert out[trouter] == out[jrouter]
    placed, hits = out[trouter]
    assert len({r for r, _ in placed[:3]}) == 1 and hits >= 4


def test_over_quota_tenants_are_throttled(parts):
    model = parts[2]
    router = trouter.build_fleet(
        model, 1, tengine.EngineConfig(**GEOMETRY),
        trouter.RouterConfig(sched_tenants="free:rate=0.001,burst=2"),
        device="cpu")
    try:
        p = _prompt(12, 6)
        router.generate(list(p), 1, tenant="free")
        router.generate(list(p), 1, tenant="free")
        with pytest.raises(SchedThrottled):
            router.generate(list(p), 1, tenant="free")
        router.generate(list(p), 1, tenant="gold")
        text = router.registry.render()
        assert 'm2kt_sched_throttled_total{reason="quota"} 1' in text
        assert 'm2kt_router_requests_total{outcome="throttled"} 1' in text
    finally:
        _close(router)


def test_chaos_kill_mid_stream_resumes_token_exact(parts, tmp_path):
    model = parts[2]
    prompt = _prompt(7, 10)
    want = _golden(model, prompt, 6)
    router = trouter.build_fleet(model, 2, tengine.EngineConfig(**GEOMETRY),
                                 device="cpu")
    try:
        victim = router.pick(prompt)
        victim.chaos = ServingChaos(ChaosConfig(
            kill_token=3, marker=str(tmp_path / "mid")))
        out = router.generate(list(prompt), 6, rid="mid-1")
        assert out["tokens"] == want and out["resumed"] is True
        assert out["replica"] != victim.name
        assert (tmp_path / "mid").exists()
        assert router._up[victim.name] is False
        assert ('m2kt_router_resumed_total{reason="chaoskill"} 1'
                in router.registry.render())
    finally:
        _close(router)


def _wait(cond, what):
    t_end = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _queued(eng, rid):
    return any(r.rid == rid for r in eng._pending)


def test_preempted_stream_resumed_by_the_router_token_exact(parts):
    """One slot, driven by hand: a best-effort stream emits 5 tokens,
    a gold request preempts it, the router resumes it from its journal
    on the same replica (not marked down), and the resumed output equals
    the uninterrupted stream token for token."""
    model = parts[2]
    p_be, p_gold = _prompt(8), _prompt(9)
    want = _golden(model, p_be, 12)
    eng = tengine.ServingEngine(
        model, tengine.EngineConfig(**{**GEOMETRY, "max_batch": 1,
                                       "sched_tenants": SPEC}),
        device="cpu")
    rep = trouter.InProcessReplica("replica-0", eng)
    rep.start = lambda: rep  # no worker thread: the test steps the engine
    router = trouter.Router([rep], trouter.RouterConfig(
        sched_tenants=SPEC, deadline_s=WAIT_S))
    results, errors = {}, []

    def client(rid, prompt, n, tenant):
        try:
            results[rid] = router.generate(list(prompt), n, rid=rid,
                                           tenant=tenant)
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=client, args=a, daemon=True)
               for a in (("be", p_be, 12, "free"),
                         ("gold", p_gold, 3, "gold"))]
    threads[0].start()
    _wait(lambda: _queued(eng, "be"), "the best-effort submit")
    for _ in range(4):
        rep._step_once()
    assert len(eng._slots[0].tokens) == 5  # the prefill's and 4 steps'
    threads[1].start()
    _wait(lambda: _queued(eng, "gold"), "the gold submit")
    rep._step_once()  # admits gold: the best-effort stream is preempted
    assert eng._slots[0].req.rid == "gold"
    t_end = time.monotonic() + WAIT_S
    while any(t.is_alive() for t in threads):
        assert time.monotonic() < t_end, "streams did not finish"
        if not rep._step_once():
            time.sleep(0.001)
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not errors, errors
    assert results["be"]["tokens"] == want and results["be"]["resumed"]
    assert len(results["gold"]["tokens"]) == 3
    assert eng.stats()["preempted"] == 1
    assert router._sched_resumed.labels(reason="preempted").value == 1
    assert router._up["replica-0"] and rep.healthy()


def test_launch_counts_are_exact_across_step_threads(monkeypatch):
    """Each replica's step thread launches kernels: the counts the card
    checks exactly lose no update when threads interleave (8 threads,
    a switch interval of 1 us)."""
    import sys

    from move2kube_tpu_torch.ops import attention as tatt

    kernel = tatt.PAGED_DECODE
    monkeypatch.setattr(kernel, "_entry", lambda: (lambda *args: 0))
    tatt.reset_launch_counts()
    n_threads, n_calls = 8, 20000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kernel.launch() for _ in range(n_calls)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kernel.launches == n_threads * n_calls
    tatt.reset_launch_counts()
