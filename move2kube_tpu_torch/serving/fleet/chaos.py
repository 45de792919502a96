"""Deterministic chaos injectors for the port's serving fleet: its own
copy of ``move2kube_tpu/serving/fleet/chaos.py``.

The recovery path ("a replica that dies mid-stream loses nothing: the
router resumes the stream token-exactly on a survivor") is only real if
a test can kill a replica at an exact token, damage a KV handoff in
flight, or flap a health check, deterministically and without a
cluster. The injectors hang off
:class:`~move2kube_tpu_torch.serving.fleet.router.InProcessReplica` (its
``chaos`` attribute) and are driven by ``M2KT_CHAOS_*`` env vars, all
inert when unset.

Knobs (the JAX package's names):

- ``M2KT_CHAOS_KILL_TOKEN`` — kill the replica when it emits its Nth
  token (1-based) for a matching request; the token is journaled first,
  so the router's resume starts from exactly N tokens. ``0`` kills at
  generate entry (before any token).
- ``M2KT_CHAOS_KILL_RID``   — rid substring the kill applies to
  (empty = any request)
- ``M2KT_CHAOS_HANDOFF``    — ``drop`` (the bytes never arrive) |
  ``truncate`` (half the npz arrives; must be refused, not crash)
- ``M2KT_CHAOS_SLOW_S``     — injected latency at generate entry
- ``M2KT_CHAOS_FLAP_N``     — the replica's first N health probes
  report down, then it recovers
- ``M2KT_CHAOS_SHARD``      — weight-plane shard damage on the serving
  peer: ``corrupt`` (valid wire, tampered payload; the fetcher's digest
  check must catch it) | ``truncate`` (half the npz; a clean ValueError)
- ``M2KT_CHAOS_SHARD_KILL_N`` — the peer dies after serving its Nth
  weight shard
- ``M2KT_CHAOS_SWAP``       — ``kill`` kills the replica inside its
  live weight swap
- ``M2KT_CHAOS_MARKER``     — exactly-once marker file: kill, handoff,
  shard and swap faults fire only while the marker is absent and create
  it first, so the recovered attempt survives. Without a marker they
  fire every time.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

log = logging.getLogger("m2kt.chaos")


def _marker_fired(marker: str) -> bool:
    """True when the exactly-once marker says this fault already fired;
    otherwise claims it (``O_EXCL``, so concurrent processes race
    safely). The JAX package's ``resilience/faults.py`` helper, copied."""
    if not marker:
        return False
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return True
    os.close(fd)
    return False


class ChaosKill(RuntimeError):
    """Injected replica death — the in-process stand-in for a serving
    pod being SIGKILLed mid-decode."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    kill_token: int | None = None  # Nth emitted token; 0 = at entry
    kill_rid: str = ""             # rid substring filter ("" = any)
    handoff: str = ""              # "" | "drop" | "truncate"
    slow_s: float = 0.0            # injected latency per generate
    flap_n: int = 0                # first N probes report down
    shard: str = ""                # "" | "corrupt" | "truncate"
    shard_kill_n: int = 0          # peer dies after Nth shard served
    swap: str = ""                 # "" | "kill" (die mid-weight-swap)
    marker: str = ""               # exactly-once marker path

    @classmethod
    def from_env(cls, **overrides) -> "ChaosConfig":
        def _num(name, default, cast):
            try:
                raw = os.environ.get(name, "")
                return cast(raw) if raw else default
            except ValueError:
                return default

        cfg = dict(
            kill_token=_num("M2KT_CHAOS_KILL_TOKEN", None, int),
            kill_rid=os.environ.get("M2KT_CHAOS_KILL_RID", ""),
            handoff=os.environ.get("M2KT_CHAOS_HANDOFF", ""),
            slow_s=_num("M2KT_CHAOS_SLOW_S", 0.0, float),
            flap_n=_num("M2KT_CHAOS_FLAP_N", 0, int),
            shard=os.environ.get("M2KT_CHAOS_SHARD", ""),
            shard_kill_n=_num("M2KT_CHAOS_SHARD_KILL_N", 0, int),
            swap=os.environ.get("M2KT_CHAOS_SWAP", ""),
            marker=os.environ.get("M2KT_CHAOS_MARKER", ""),
        )
        cfg.update(overrides)
        return cls(**cfg)

    def armed(self) -> bool:
        return (self.kill_token is not None or bool(self.handoff)
                or self.slow_s > 0 or self.flap_n > 0
                or bool(self.shard) or self.shard_kill_n > 0
                or bool(self.swap))


class ServingChaos:
    """One injector instance, shared by every replica it is attached to
    (per-replica state is keyed by replica name). All hooks are cheap
    no-ops for the faults that are not configured."""

    def __init__(self, config: ChaosConfig | None = None):
        self.config = config or ChaosConfig.from_env()
        self._emitted: dict[str, int] = {}   # rid -> tokens seen
        self._probes: dict[str, int] = {}    # replica -> probes seen
        self._shards: dict[str, int] = {}    # peer -> shards served

    def _matches(self, rid: str) -> bool:
        return not self.config.kill_rid or self.config.kill_rid in rid

    def _fire_once(self) -> bool:
        """True when this exactly-once fault should fire now (claims the
        marker). Marker-less configs fire every time."""
        return not _marker_fired(self.config.marker)

    def on_token(self, replica: str, rid: str, tok: int) -> None:
        """Called AFTER the router's journal recorded ``tok`` (see
        ``InProcessReplica._on_token``): a kill at token N leaves
        exactly N tokens journaled."""
        n = self.config.kill_token
        if n is None or n < 1 or not self._matches(rid):
            return
        seen = self._emitted.get(rid, 0) + 1
        self._emitted[rid] = seen
        if seen < n:
            return
        if not self._fire_once():
            return
        log.warning("chaos: killing %s at token %d of %s", replica, seen,
                    rid)
        print(f"[m2kt] CHAOS: killed {replica} at token {seen} of {rid}",
              flush=True)
        raise ChaosKill(f"{replica}: killed at token {seen} of {rid}")

    def on_generate(self, replica: str, rid: str) -> None:
        if self.config.slow_s > 0:
            time.sleep(self.config.slow_s)
        if (self.config.kill_token == 0 and self._matches(rid)
                and self._fire_once()):
            log.warning("chaos: killing %s at generate entry (%s)",
                        replica, rid)
            raise ChaosKill(f"{replica}: killed before token 0 of {rid}")

    def on_handoff(self, replica: str, data: bytes) -> bytes:
        mode = self.config.handoff
        if not mode or not self._fire_once():
            return data
        log.warning("chaos: %s KV handoff into %s (%d bytes)", mode,
                    replica, len(data))
        if mode == "drop":
            raise ChaosKill(f"{replica}: KV handoff dropped in transit")
        if mode == "truncate":
            return data[:max(1, len(data) // 2)]
        return data

    def on_shard(self, peer: str, path: str, data: bytes) -> bytes:
        """Weight-plane faults on the SERVING side of a P2P fetch: kill
        the peer after its Nth shard, or damage one shard in flight.
        ``corrupt`` re-encodes a tampered payload — valid wire bytes
        with the wrong content, the exact failure only the fetcher's
        sha256 check can catch (truncation already dies in decode)."""
        n = self.config.shard_kill_n
        if n > 0:
            served = self._shards.get(peer, 0) + 1
            self._shards[peer] = served
            if served >= n and self._fire_once():
                log.warning("chaos: killing peer %s after shard %d (%s)",
                            peer, served, path)
                print(f"[m2kt] CHAOS: peer {peer} died after "
                      f"{served} shards", flush=True)
                raise ChaosKill(f"{peer}: died serving shard {path}")
        mode = self.config.shard
        if not mode or not self._fire_once():
            return data
        log.warning("chaos: %s weight shard %s from %s (%d bytes)", mode,
                    path, peer, len(data))
        if mode == "truncate":
            return data[:max(1, len(data) // 2)]
        if mode == "corrupt":
            from move2kube_tpu_torch.serving.fleet import weights as weightslib

            spath, arr = weightslib.decode_shard(data)
            flipped = arr.copy()
            flipped.flat[0] = -flipped.flat[0] if flipped.flat[0] else 1
            return weightslib.encode_shard(spath, flipped)
        return data

    def on_swap(self, replica: str) -> None:
        """Called at the top of a replica's live weight swap."""
        if self.config.swap == "kill" and self._fire_once():
            log.warning("chaos: killing %s mid-weight-swap", replica)
            print(f"[m2kt] CHAOS: killed {replica} mid-swap", flush=True)
            raise ChaosKill(f"{replica}: killed mid-weight-swap")

    def on_probe(self, replica: str) -> bool:
        """False while the replica should flap unhealthy."""
        if self.config.flap_n <= 0:
            return True
        seen = self._probes.get(replica, 0) + 1
        self._probes[replica] = seen
        return seen > self.config.flap_n


def maybe_chaos() -> ServingChaos | None:
    """A ServingChaos when any ``M2KT_CHAOS_*`` knob is set, else None:
    a process without the knobs pays nothing."""
    cfg = ChaosConfig.from_env()
    return ServingChaos(cfg) if cfg.armed() else None
