"""The port's weight plane and live weight swap against the JAX
package's: ``state_dict`` shards (int8 and bf16 leaves included), their
digests and wire bytes, the manifest, every fetch drill, and
``install_weights`` mid-decode on the port's engine against the JAX
engine (``async_decode="off"``) doing the same swap. A swap rebinds the
swapping engine's own modules: an engine built on the same model is not
touched."""

import dataclasses
import io
import re
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving.fleet import weights as jweights  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs.metrics import Registry  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import quant as tquant  # noqa: E402
from move2kube_tpu_torch.serving.fleet import weights as tweights  # noqa: E402
from move2kube_tpu_torch.serving.fleet.chaos import (  # noqa: E402
    ChaosConfig,
    ServingChaos,
)
from move2kube_tpu_torch.serving.fleet.router import (  # noqa: E402
    build_fleet,
)

GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32))
# a swap of the same weights is invisible: the same tensors' values, so
# the same logits (the bound the JAX package's swap test holds)
SAME_SWAP_ATOL = 1e-5
# port vs JAX engine after a swap to other weights, fp32: two frameworks'
# sums in other orders through 2 layers
SWAP_ATOL = 1e-4
# int8 weights re-quantized at the swap against an unswapped int8 run:
# the JAX package's quant gate
QUANT_GATE_REL = 0.05


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
    new_vars = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * 1.25).astype(np.asarray(a).dtype),
        jax.device_get(variables))
    new_sd = params_from_jax(new_vars["params"], tcfg)
    return fmodel, variables, model.eval(), new_vars, new_sd


def _engine(model, **over):
    return tengine.ServingEngine(model, tengine.EngineConfig(
        **{**GEOMETRY, "async_decode": "off", **over}), device="cpu")


def _tiny_sd() -> dict:
    """A small state_dict: fp32, bf16 and a quantized layer's int8
    ``q8`` with its fp32 ``scale``."""
    g = torch.Generator().manual_seed(7)
    return {
        "embed.weight": torch.randn(11, 4, generator=g),
        "layers.0.qkv.weight": torch.randn(4, 4, generator=g).bfloat16(),
        "layers.0.attn_norm.scale": torch.ones(4),
        "lm_head.q8": torch.randint(-127, 128, (11, 4), generator=g,
                                    dtype=torch.int8),
        "lm_head.scale": torch.rand(11, 1, generator=g),
    }


def _assert_sd_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def _fetch_count(reg, reason: str) -> float:
    pat = (r'm2kt_weights_fetch_total\{[^}]*reason="' + reason
           + r'"[^}]*\} ([0-9.e+-]+)')
    return sum(float(m) for m in re.findall(pat, reg.render()))


# ----------------------------------------------------------------------
# wire format
# ----------------------------------------------------------------------

def test_flatten_unflatten_roundtrip_int8_and_bf16(parts):
    sd = _tiny_sd()
    flat = tweights.flatten_variables(sd)
    assert set(flat) == set(sd)
    assert flat["lm_head.q8"].dtype == np.int8
    assert flat["layers.0.qkv.weight"].dtype == np.dtype("V2")
    _assert_sd_equal(tweights.unflatten_variables(flat), sd)
    # a quantized engine's resident weights, int8 leaves and scales
    qmodel = tquant.quantize_model(parts[2])
    resident = qmodel.state_dict()
    back = tweights.unflatten_variables(tweights.flatten_variables(resident))
    _assert_sd_equal(back, {k: v.cpu() for k, v in resident.items()})
    # nested trees flatten as the JAX package's do
    tree = {"params": {"a": np.ones((2,), np.float32), "b": {"c": np.int8(3)}}}
    assert set(tweights.flatten_variables(tree)) == set(
        jweights.flatten_variables(tree)) == {"params/a", "params/b/c"}


@pytest.mark.parametrize("name", ["embed.weight", "lm_head.q8",
                                  "lm_head.scale", "layers.0.qkv.weight"])
def test_shard_digest_and_bytes_match_jax(name):
    """The same array at the same path: the same digest, and wire
    messages whose members (meta and array) hold the same bytes; each
    side decodes the other's."""
    arr = tweights.flatten_variables(_tiny_sd())[name]
    assert tweights.shard_digest(name, arr) == jweights.shard_digest(
        name, arr)
    ours, theirs = tweights.encode_shard(name, arr), jweights.encode_shard(
        name, arr)
    members = []
    for data in (ours, theirs):
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            members.append({n: z.read(n) for n in z.namelist()})
    assert members[0] == members[1]
    for path, got in (jweights.decode_shard(ours),
                      tweights.decode_shard(theirs)):
        assert path == name and got.dtype == arr.dtype
        assert got.tobytes() == arr.tobytes()


def test_shard_and_manifest_malformations_are_value_errors():
    arr = np.arange(6, dtype=np.float32)
    data = tweights.encode_shard("x", arr)
    for bad in (data[:len(data) // 2], b"garbage", b""):
        with pytest.raises(ValueError):
            tweights.decode_shard(bad)
        with pytest.raises(ValueError):
            tweights.WeightManifest.from_bytes(bad)
    with pytest.raises(ValueError, match="unknown weight shard"):
        tweights.WeightPlane(_tiny_sd()).shard_bytes("nope")
    assert tweights.DEADLINE_HEADER == "X-M2KT-Deadline"


def test_manifest_roundtrip_and_jax_compatibility():
    sd = _tiny_sd()
    man = tweights.WeightManifest.of(sd, version=3)
    back = tweights.WeightManifest.from_bytes(man.to_bytes())
    assert back == man
    theirs = jweights.WeightManifest.from_bytes(man.to_bytes())
    assert theirs.version == 3 and theirs.shards == man.shards
    assert man.shards["layers.0.qkv.weight"]["dtype"] == "|V2"
    plane = tweights.WeightPlane(sd, version=3)
    assert plane.manifest() == man


# ----------------------------------------------------------------------
# fetch drills
# ----------------------------------------------------------------------

def _peers(sd, *chaos, version=1):
    plane = tweights.WeightPlane(sd, version=version)
    return [tweights.InProcessWeightPeer(f"p{i}", plane, chaos=c)
            for i, c in enumerate(chaos)]


def test_fetch_clean_roundtrip(tmp_path):
    sd, reg = _tiny_sd(), Registry()
    got = tweights.fetch_from_peers(_peers(sd, None, None, version=4),
                                    registry=reg)
    assert got is not None and got[1] == 4
    _assert_sd_equal(got[0], sd)
    assert _fetch_count(reg, "ok") == 1


@pytest.mark.parametrize("fault,reason", [("corrupt", "digest_mismatch"),
                                          ("truncate", "malformed")])
def test_fetch_damaged_shard_refetched_from_other_peer(tmp_path, fault,
                                                       reason):
    sd, reg = _tiny_sd(), Registry()
    chaos = ServingChaos(ChaosConfig(shard=fault,
                                     marker=str(tmp_path / fault)))
    got = tweights.fetch_from_peers(_peers(sd, chaos, None), registry=reg)
    assert got is not None
    _assert_sd_equal(got[0], sd)
    assert _fetch_count(reg, reason) >= 1 and (tmp_path / fault).exists()


def test_fetch_peer_killed_mid_stream_finishes_on_survivor(tmp_path):
    sd, reg = _tiny_sd(), Registry()
    chaos = ServingChaos(ChaosConfig(shard_kill_n=2,
                                     marker=str(tmp_path / "kill")))
    peers = _peers(sd, chaos, None)
    got = tweights.fetch_from_peers(peers, registry=reg)
    assert got is not None and peers[0]._dead
    _assert_sd_equal(got[0], sd)
    assert _fetch_count(reg, "connection") >= 1
    assert _fetch_count(reg, "ok") == 1


def test_fetch_all_dead_expired_and_no_peer_return_none(tmp_path):
    reg = Registry()
    chaos = ServingChaos(ChaosConfig(shard_kill_n=1,
                                     marker=str(tmp_path / "kill")))
    assert tweights.fetch_from_peers(_peers(_tiny_sd(), chaos),
                                     registry=reg) is None
    assert _fetch_count(reg, "exhausted") == 1
    assert tweights.fetch_from_peers(_peers(_tiny_sd(), None), registry=reg,
                                     deadline_s=0.0) is None
    assert _fetch_count(reg, "deadline") == 1
    assert tweights.fetch_from_peers([], registry=reg) is None
    assert _fetch_count(reg, "no_peer") == 1
    assert _fetch_count(reg, "ok") == 0


def test_fetch_want_version_skips_stale_peers():
    sd, reg = _tiny_sd(), Registry()
    stale = _peers(sd, None, version=1)
    assert tweights.fetch_from_peers(stale, registry=reg,
                                     want_version=2) is None
    assert _fetch_count(reg, "stale") == 1
    fresh = _peers(sd, None, version=2)
    got = tweights.fetch_from_peers(stale + fresh, registry=reg,
                                    want_version=2)
    assert got is not None and got[1] == 2


def test_fetched_weights_install_into_an_engine(parts):
    """Peers serve an int8 engine's resident tree; a joining int8 engine
    installs what it fetched and decodes the same stream."""
    model = parts[2]
    src, dst = _engine(model, quant="int8"), _engine(model, quant="int8")
    plane = tweights.WeightPlane(src.model.state_dict(), version=3)
    got = tweights.fetch_from_peers(
        [tweights.InProcessWeightPeer("src", plane)])
    assert dst.install_weights(got[0], version=got[1]) == 3
    req = [tengine.Request("r", list(range(3, 13)), 4)]
    assert src.run(req)[0].tokens == dst.run(
        [tengine.Request("r", list(range(3, 13)), 4)])[0].tokens


# ----------------------------------------------------------------------
# install_weights
# ----------------------------------------------------------------------

def test_install_weights_rejects_mismatches_before_installing(parts):
    model = parts[2]
    eng = _engine(model, prefix_cache=True)
    sd = dict(model.state_dict())
    victim = sorted(sd)[0]
    resident = eng.model
    cases = [({k: v for k, v in sd.items() if k != victim},
              "parameter tree mismatch"),
             ({**sd, "extra.weight": torch.zeros(2)},
              "parameter tree mismatch"),
             ({**sd, victim: torch.zeros(2, 2)}, victim),
             ({**sd, victim: sd[victim].double()}, victim)]
    for tree, match in cases:
        with pytest.raises(ValueError, match=re.escape(match)):
            eng.install_weights(tree)
        assert eng.weights_version == 1 and eng.model is resident
    q = _engine(model, quant="int8", quant_audit_rate=0.5)
    with pytest.raises(ValueError, match="fp tree"):
        q.install_weights(q.model.state_dict())


def _swap_run(eng, mod, new, swap_after=3, version=9):
    """One greedy stream; ``new`` installed after ``swap_after`` tokens.
    Returns (tokens, logit rows, completion)."""
    eng.capture_logits = True
    prompt = np.random.default_rng(3).integers(1, 200, size=12).tolist()
    eng.submit(mod.Request("swap-req", prompt, 8))
    comps, swapped = [], False
    for _ in range(64):
        comps += eng.step()
        slot = next((s for s in eng._slots if s is not None), None)
        if not swapped and slot is not None and len(
                slot.tokens) >= swap_after:
            assert eng.install_weights(new, version=version) == version
            swapped = True
        if comps:
            break
    assert swapped and len(comps) == 1
    return comps[0].tokens, np.stack(eng.logit_log["swap-req"]), comps[0]


def test_same_weights_swap_mid_decode_is_invisible(parts):
    model = parts[2]
    gold = _engine(model)
    gold.capture_logits = True
    prompt = np.random.default_rng(3).integers(1, 200, size=12).tolist()
    want = gold.run([tengine.Request("swap-req", prompt, 8)])[0].tokens
    tokens, rows, comp = _swap_run(_engine(model), tengine,
                                   model.state_dict())
    assert tokens == want and comp.weights_version == 9
    np.testing.assert_allclose(rows, np.stack(gold.logit_log["swap-req"]),
                               atol=SAME_SWAP_ATOL, rtol=0)


def test_other_weights_swap_mid_decode_matches_jax(parts):
    """A swap to other weights (every tensor x 1.25) mid-decode: the
    port's stream and logits after the swap equal the JAX engine's after
    the same swap, within SWAP_ATOL, and they differ from the unswapped
    run."""
    fmodel, variables, model, new_vars, new_sd = parts
    got = _swap_run(_engine(model), tengine, new_sd)
    want = _swap_run(jengine.ServingEngine(
        fmodel, variables, jengine.EngineConfig(**GEOMETRY,
                                                async_decode="off")),
        jengine, new_vars)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], atol=SWAP_ATOL, rtol=0)
    assert got[2].weights_version == want[2].weights_version == 9
    gold = _engine(model)
    gold.capture_logits = True
    gold.run([tengine.Request("swap-req", np.random.default_rng(3).integers(
        1, 200, size=12).tolist(), 8)])
    assert np.abs(got[1][-1] - gold.logit_log["swap-req"][-1]).max() > 1e-2


def test_int8_swap_of_the_fp_tree_is_logit_gated(parts):
    model = parts[2]
    gold = _engine(model, quant="int8")
    gold.capture_logits = True
    prompt = np.random.default_rng(3).integers(1, 200, size=12).tolist()
    want = gold.run([tengine.Request("swap-req", prompt, 8)])[0].tokens
    tokens, rows, _ = _swap_run(_engine(model, quant="int8"), tengine,
                                model.state_dict())
    assert tokens == want
    gate = tquant.logit_gate(np.stack(gold.logit_log["swap-req"]), rows)
    assert gate["top1_agreement"] == 1.0
    assert gate["max_rel_err"] < QUANT_GATE_REL


def test_swap_accepts_an_already_quantized_tree(parts):
    model = parts[2]
    src, dst = _engine(model, quant="int8-kv"), _engine(model,
                                                        quant="int8-kv")
    resident = {k: v.clone() for k, v in src.model.state_dict().items()}
    assert dst.install_weights(resident, version=5) == 5
    prompt = list(range(5, 15))
    assert src.run([tengine.Request("r", prompt, 4)])[0].tokens == dst.run(
        [tengine.Request("r", list(prompt), 4)])[0].tokens


def test_swap_flushes_the_prefix_cache(parts):
    """K/V cached under the old weights is dropped at the swap: a
    post-swap request on the old prompt decodes as a fresh engine on the
    new weights does, and as the JAX engine after the same swap."""
    fmodel, variables, model, new_vars, new_sd = parts
    prompt = np.random.default_rng(5).integers(1, 200, size=16).tolist()
    eng = _engine(model, prefix_cache=True)
    eng.run([tengine.Request("warm", prompt, 4)])
    assert eng._prefix.total_pages > 0
    eng.install_weights(new_sd, version=2)
    assert eng._prefix.total_pages == 0
    post = eng.run([tengine.Request("post", list(prompt), 4)])[0].tokens
    fresh_model = tllama.Llama(model.cfg, device="cpu")
    fresh_model.load_state_dict(new_sd)
    fresh = _engine(fresh_model.eval(), prefix_cache=True)
    assert post == fresh.run([tengine.Request("post", list(prompt),
                                              4)])[0].tokens
    jeng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **GEOMETRY, prefix_cache=True, async_decode="off"))
    jeng.run([jengine.Request("warm", prompt, 4)])
    jeng.install_weights(new_vars, version=2)
    assert post == jeng.run([jengine.Request("post", list(prompt),
                                             4)])[0].tokens


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_swap_leaves_sibling_engines_and_the_model_alone(parts, quant):
    """Two engines on one model (what build_fleet makes): swapping one
    to other weights mid-decode leaves the other's stream unchanged and
    the caller's model's tensors as they were."""
    model, new_sd = parts[2], parts[4]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want = _engine(model, quant=quant).run(
        [tengine.Request("s", list(range(7, 19)), 8)])[0].tokens
    a, b = _engine(model, quant=quant), _engine(model, quant=quant)
    b.submit(tengine.Request("s", list(range(7, 19)), 8))
    b.step()
    b.step()
    _swap_run(a, tengine, new_sd)
    got = b.run([])[0].tokens
    assert got == want
    _assert_sd_equal(dict(model.state_dict()), before)
    assert a.model is not b.model


def test_router_swap_rolls_the_fleet_under_chaos(parts, tmp_path):
    """The rolling swap: one replica at a time; a replica killed inside
    its swap is marked down, the others converge on the pinned version,
    and the next roll skips the downed one."""
    model = parts[2]
    router = build_fleet(model, 3, tengine.EngineConfig(**GEOMETRY),
                         device="cpu")
    try:
        marker = tmp_path / "swap-kill"
        router.replicas[-1].chaos = ServingChaos(
            ChaosConfig(swap="kill", marker=str(marker)))
        out = router.swap(variables=model.state_dict(), version=5)
        assert out == {"weights_version": 5, "swapped": 2, "failed": 1,
                       "skipped": 0}
        assert marker.exists()
        text = router.registry.render()
        assert 'm2kt_router_swap_total{outcome="ok"} 2' in text
        assert 'm2kt_router_swap_total{outcome="failed"} 1' in text
        assert [r.engine.weights_version for r in router.replicas] == [5, 5,
                                                                       1]
        assert 'm2kt_weights_version 5' in (
            router.replicas[0].engine.registry.render())
        out2 = router.swap(variables=model.state_dict(), version=6)
        assert out2["skipped"] == 1 and out2["failed"] == 0
    finally:
        for r in router.replicas:
            r.close()
