"""Fleet weight plane of the port: streamed peer-to-peer checkpoint
fan-out, the port's own copy of ``move2kube_tpu/serving/fleet/weights.py``
over torch state dicts.

A replica joining a serving fleet can stream its weights from the peers
it is joining instead of reading a checkpoint store: every serving
replica is a shard server and every cold replica a digest-verifying
fetcher.

- :func:`flatten_variables` / :func:`unflatten_variables` — a
  ``state_dict`` (or a nested dict of arrays) to ``{path: ndarray}``
  shards and back. A quantized model's ``q8``/``scale`` buffers are
  shards like any other, so what streams between peers is the int8
  payload and its fp32 scales. numpy has no bfloat16: a bf16 leaf
  travels as its raw 2-byte words (dtype ``|V2``, the bytes ``np.save``
  writes for an ``ml_dtypes.bfloat16`` array) and comes back as bf16;
- :class:`WeightManifest` — the versioned table of contents (per-shard
  sha256 / dtype / shape), npz + json framing like the disagg
  ``KVHandoff``: every bad byte surfaces as ``ValueError``;
- :func:`encode_shard` / :func:`decode_shard` — one leaf per wire
  message;
- :func:`fetch_from_peers` — the joining side: manifest from the first
  healthy peer, then every shard digest-verified on arrival; a corrupted
  or truncated shard is re-fetched from a different peer (bounded
  attempts), a dead peer is dropped for the rest of the fetch, and the
  whole operation is deadline-aware. Returns ``None`` when no peer can
  serve a complete verified set.

Fetch outcomes land in ``m2kt_weights_fetch_total{source,reason}``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import time
import urllib.parse
import urllib.request

import numpy as np

import torch

from move2kube_tpu_torch.serving.fleet.chaos import ChaosKill

_WIRE_VERSION = 1
# numpy has no bfloat16: a bf16 tensor crosses a wire (a weight shard, a
# KV handoff) as its raw 2-byte words, the dtype np.save writes for an
# ml_dtypes.bfloat16 array
BF16_WIRE = np.dtype("V2")

# the router's per-hop remaining-seconds budget header; redeclared here
# (string-equal, asserted by tests) so the weight plane never imports
# the router module
DEADLINE_HEADER = "X-M2KT-Deadline"

FETCH_REASONS = ("ok", "digest_mismatch", "malformed", "connection",
                 "deadline", "no_peer", "stale", "exhausted", "fallback",
                 "error")


def weights_fetch_counter(registry):
    """The shared fetch-outcome counter — one helper so the peer fetcher
    and the store-fallback caller cannot disagree on name or labels."""
    return registry.counter(
        "m2kt_weights_fetch_total",
        "Weight-plane fetch outcomes by source and reason",
        labels=("source", "reason"), max_series=2 * len(FETCH_REASONS))


def to_wire(leaf) -> np.ndarray:
    """A host array of ``leaf``: a tensor's values (bf16 as its ``|V2``
    words), an array as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_WIRE)
        return t.numpy()
    return np.asarray(leaf)


def from_wire(arr: np.ndarray) -> torch.Tensor:
    """The CPU tensor a wire array stands for (``|V2`` words as bf16);
    ``ValueError`` for any other void dtype."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "V":
        if arr.dtype != BF16_WIRE:
            raise ValueError(f"wire array of {arr.dtype}: only 2-byte "
                             "words (bf16) are known")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def flatten_variables(variables) -> dict[str, np.ndarray]:
    """Flatten a ``state_dict`` (or a nested dict of tensors or arrays)
    into ``{path: ndarray}`` shards: a flat dict keeps its names, nested
    levels join with ``"/"`` as in the JAX package. Quantized layers'
    ``q8``/``scale`` buffers are leaves like any other."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, f"{prefix}/{key}" if prefix else str(key))
            return
        flat[prefix] = to_wire(node)

    walk(variables, "")
    return flat


def unflatten_variables(flat: dict[str, np.ndarray]) -> dict:
    """The inverse of :func:`flatten_variables`: a ``state_dict`` of
    CPU tensors (nested where the paths hold ``"/"``)."""
    tree: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = from_wire(arr)
    return tree


def shard_digest(path: str, arr: np.ndarray) -> str:
    """Content digest of one shard: tree path + dtype + shape + raw
    bytes. Computed over the decoded array, not the wire bytes — npz
    compression is not byte-stable across encodes, array content is."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(path.encode())
    h.update(str(arr.dtype).encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def encode_shard(path: str, arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        meta=np.frombuffer(
            json.dumps({"v": _WIRE_VERSION, "path": path}).encode(),
            np.uint8),
        arr=np.ascontiguousarray(np.asarray(arr)))
    return buf.getvalue()


def decode_shard(data: bytes) -> tuple[str, np.ndarray]:
    """Parse one wire shard. Same contract as ``KVHandoff.from_bytes``:
    every malformation — truncated npz, garbage meta, missing arrays —
    is a ``ValueError`` the fetcher turns into a different-peer retry."""
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            meta = json.loads(z["meta"].tobytes().decode())
            if meta.get("v") != _WIRE_VERSION:
                raise ValueError(
                    f"weight shard wire version {meta.get('v')!r}; "
                    f"this replica speaks {_WIRE_VERSION}")
            return str(meta["path"]), np.asarray(z["arr"])
    except ValueError:
        raise
    except Exception as err:  # noqa: BLE001 - BadZipFile, KeyError, ...
        raise ValueError(f"malformed weight shard: "
                         f"{type(err).__name__}: {err}") from err


@dataclasses.dataclass
class WeightManifest:
    """Versioned table of contents for one replica's resident weights:
    ``shards[path] = {"sha256", "dtype", "shape"}``."""

    version: int
    shards: dict[str, dict]

    @classmethod
    def of(cls, variables, version: int) -> "WeightManifest":
        flat = flatten_variables(variables)
        return cls(version=int(version), shards={
            path: {"sha256": shard_digest(path, arr),
                   "dtype": str(arr.dtype),
                   "shape": list(arr.shape)}
            for path, arr in flat.items()})

    def to_bytes(self) -> bytes:
        meta = {"v": _WIRE_VERSION, "version": self.version,
                "shards": self.shards}
        buf = io.BytesIO()
        np.savez_compressed(
            buf, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "WeightManifest":
        try:
            with np.load(io.BytesIO(data), allow_pickle=False) as z:
                meta = json.loads(z["meta"].tobytes().decode())
                if meta.get("v") != _WIRE_VERSION:
                    raise ValueError(
                        f"weight manifest wire version {meta.get('v')!r}; "
                        f"this replica speaks {_WIRE_VERSION}")
                shards = meta["shards"]
                if not isinstance(shards, dict) or not shards:
                    raise ValueError("weight manifest carries no shards")
                return cls(version=int(meta["version"]),
                           shards={str(p): dict(s)
                                   for p, s in shards.items()})
        except ValueError:
            raise
        except Exception as err:  # noqa: BLE001
            raise ValueError(f"malformed weight manifest: "
                             f"{type(err).__name__}: {err}") from err


class WeightPlane:
    """The serving side: owns the (possibly int8-quantized) weights a
    replica would hand a joining peer (a ``state_dict``), plus their
    version and manifest. ``install`` re-snapshots after a live swap so
    peers always stream the bytes the engine is decoding with."""

    def __init__(self, variables, version: int = 1):
        self.install(variables, version)

    def install(self, variables, version: int) -> None:
        self._flat = flatten_variables(variables)
        self.version = int(version)
        self._manifest = WeightManifest(version=self.version, shards={
            path: {"sha256": shard_digest(path, arr),
                   "dtype": str(arr.dtype),
                   "shape": list(arr.shape)}
            for path, arr in self._flat.items()})

    def manifest(self) -> WeightManifest:
        return self._manifest

    def shard_bytes(self, path: str) -> bytes:
        if path not in self._flat:
            raise ValueError(f"unknown weight shard {path!r}")
        return encode_shard(path, self._flat[path])


class InProcessWeightPeer:
    """A peer handle over an in-process :class:`WeightPlane`, the
    fleet-in-one-process shape the tests use. The chaos
    injector rides the shard path exactly where the HTTP wire would
    corrupt: a ``ChaosKill`` from ``on_shard`` marks the peer dead for
    the rest of the fetch (a pod SIGKILLed mid-stream answers nothing,
    not garbage)."""

    def __init__(self, name: str, plane: WeightPlane, chaos=None):
        self.name = name
        self.plane = plane
        self.chaos = chaos
        self._dead = False

    def _check(self) -> None:
        if self._dead:
            raise ConnectionError(f"{self.name}: peer is dead")

    def manifest_bytes(self, deadline_s=None) -> bytes:
        self._check()
        return self.plane.manifest().to_bytes()

    def shard(self, path: str, deadline_s=None) -> bytes:
        self._check()
        data = self.plane.shard_bytes(path)
        if self.chaos is not None:
            try:
                data = self.chaos.on_shard(self.name, path, data)
            except ChaosKill:
                self._dead = True
                raise ConnectionError(
                    f"{self.name}: peer died mid-stream") from None
        return data


class HttpWeightPeer:
    """A peer handle over a replica's weights listener
    (``GET /weights/manifest`` and ``GET /weights/<quoted-path>`` on
    ``M2KT_WEIGHTS_PORT``). The remaining deadline budget rides the
    same ``X-M2KT-Deadline`` header as every other fleet hop and also
    caps the socket timeout."""

    def __init__(self, name: str, base_url: str, timeout_s: float = 10.0):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _get(self, tail: str, deadline_s=None) -> bytes:
        req = urllib.request.Request(self.base_url + tail)
        timeout = self.timeout_s
        if deadline_s is not None:
            req.add_header(DEADLINE_HEADER, f"{deadline_s:.3f}")
            timeout = max(0.001, min(timeout, deadline_s))
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()

    def manifest_bytes(self, deadline_s=None) -> bytes:
        return self._get("/weights/manifest", deadline_s)

    def shard(self, path: str, deadline_s=None) -> bytes:
        return self._get("/weights/" + urllib.parse.quote(path, safe=""),
                         deadline_s)


def peers_from_env(spec: str | None = None) -> list[HttpWeightPeer]:
    """``M2KT_WEIGHTS_PEERS`` — comma list of ``host:port`` weights
    listeners (the decode role's headless Service DNS fans one name out
    to every pod IP at resolve time; unresolvable names still become
    peers and fail as ``connection`` at fetch time)."""
    import os
    import socket

    raw = spec if spec is not None else os.environ.get(
        "M2KT_WEIGHTS_PEERS", "")
    peers: list[HttpWeightPeer] = []
    for entry in [e.strip() for e in raw.split(",") if e.strip()]:
        host, _, port = entry.rpartition(":")
        try:
            infos = socket.getaddrinfo(host, int(port),
                                       type=socket.SOCK_STREAM)
        except (OSError, ValueError):
            infos = []
        addrs = sorted({i[4][0] for i in infos})
        if not addrs:
            peers.append(HttpWeightPeer(entry, f"http://{entry}"))
        for addr in addrs:
            peers.append(
                HttpWeightPeer(f"{addr}:{port}", f"http://{addr}:{port}"))
    return peers


def fetch_from_peers(peers, registry=None, deadline_s=None,
                     max_attempts_per_shard: int | None = None,
                     want_version: int | None = None):
    """Stream a complete verified weight set from serving peers.

    Returns ``(state_dict, version)`` or ``None`` when no healthy peer
    set could produce every shard digest-verified inside the deadline;
    the caller then falls back to its checkpoint store. Every attempt
    outcome is counted under ``source="peer"``; a shard that fails
    verification is retried from a *different* peer (the attempt index
    rotates the peer list) up to ``max_attempts_per_shard`` times
    (default ``len(peers) + 1``).

    ``want_version`` pins the fetch to one weight generation — the
    rolling-swap case: the first pod of a swap finds no peer at the new
    version (every peer is ``stale``) and falls back to the store; every
    later pod streams the new generation P2P from the already-swapped
    ones."""
    counter = weights_fetch_counter(registry) if registry is not None \
        else None

    def count(reason: str) -> None:
        if counter is not None:
            counter.labels(source="peer", reason=reason).inc()

    live = [p for p in peers]
    if not live:
        count("no_peer")
        return None
    t_end = None if deadline_s is None else time.monotonic() + deadline_s

    def remaining():
        return None if t_end is None else t_end - time.monotonic()

    manifest = None
    for peer in list(live):
        rem = remaining()
        if rem is not None and rem <= 0:
            count("deadline")
            return None
        try:
            got = WeightManifest.from_bytes(
                peer.manifest_bytes(deadline_s=rem))
        except ValueError:
            count("malformed")
            continue
        except (OSError, ConnectionError):
            count("connection")
            live.remove(peer)
            continue
        if want_version is not None and got.version != want_version:
            # a peer still on the old generation: streaming its resident
            # tree would re-install the weights the swap is replacing
            count("stale")
            continue
        manifest = got
        break
    if manifest is None:
        count("no_peer")
        return None

    budget = (max_attempts_per_shard if max_attempts_per_shard is not None
              else len(peers) + 1)
    flat: dict[str, np.ndarray] = {}
    for i, path in enumerate(sorted(manifest.shards)):
        want = manifest.shards[path]
        arr = None
        attempts = 0
        while arr is None and attempts < budget and live:
            rem = remaining()
            if rem is not None and rem <= 0:
                count("deadline")
                return None
            # rotate: a failed attempt moves to a DIFFERENT peer; the
            # i-offset spreads the initial load across the fleet
            peer = live[(i + attempts) % len(live)]
            attempts += 1
            try:
                got_path, got = decode_shard(
                    peer.shard(path, deadline_s=rem))
                if (got_path != path
                        or shard_digest(path, got) != want["sha256"]):
                    count("digest_mismatch")
                    continue
                arr = got
            except ValueError:
                count("malformed")
            except (OSError, ConnectionError):
                count("connection")
                if peer in live:
                    live.remove(peer)
        if arr is None:
            count("exhausted")
            return None
        flat[path] = arr
    count("ok")
    return unflatten_variables(flat), manifest.version
