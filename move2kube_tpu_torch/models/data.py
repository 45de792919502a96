"""Host-sharded input pipeline for training: the port's counterpart of
``move2kube_tpu/models/data.py``.

Every host loads only the examples of its own contiguous shard and
cycles through it with an epoch-seeded shuffle,
``np.random.default_rng(seed + epoch)`` over ``[start, stop)``, the
reference's permutation; each of the host's ranks then takes its
contiguous rows of the host's batch, in data-axis order, as the
reference's ``make_array_from_process_local_data`` splits a host's local
batch over its devices. The host index and count are the launcher's
(:func:`~move2kube_tpu_torch.parallel.mesh.current_layout`: hosts =
``M2KT_NUM_HOSTS`` x ``M2KT_NUM_SLICES``, the ranks of a host
consecutive), not ``torch.distributed``'s rank and world, since a host
with k cards runs k ranks. The same file and seed give the same global
batches as the JAX loader, whatever the number of ranks a host.

Sources, selected by path (the emitted trainers read ``M2KT_DATA``):

- ``*.npy`` one array (``input``), memory-mapped
- ``*.npz`` named arrays (``input``/``label`` or ``input_ids``),
  memory-mapped so a process touches only its rows
- ``*.jsonl`` one JSON object per line with token/feature lists
- a directory: every ``*.npy``/``*.npz``/``*.jsonl`` inside, concatenated
- anything else / empty: synthetic batches from the caller's function

The row gather is ``np.ascontiguousarray(src[idx])`` (the reference's
``gather_rows`` contract), written straight into pinned host memory when
the batches go to the card. :class:`PrefetchLoader` overlaps the gather
and the host-to-device copy with the running step: a pump thread fills a
ring of pinned buffers and copies each batch on a side CUDA stream; the
consumer's stream waits on the copy's event, and every device batch
handed out is ``record_stream``'ed on the consumer's stream, so its memory
is not reused while the step still reads it. A pinned buffer is written
again only after the event of its previous copy has completed.

The batch's device is the caller's: a rank's own card. A synthetic
source's function makes the global batch and each rank keeps its rows.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import struct
import threading
import zipfile

import numpy as np
import torch

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.parallel.mesh import ProcessLayout, current_layout

log = logging.getLogger("m2kt.data")


def _process_slice(n: int, layout: ProcessLayout) -> tuple[int, int]:
    """[start, stop) of this host's contiguous shard of n examples."""
    pi, pc = layout.host, layout.hosts
    per = n // pc
    return pi * per, (pi + 1) * per if pi < pc - 1 else n


def _rank_rows(batch: dict, layout: ProcessLayout) -> dict:
    """This rank's rows of a global batch (each value's leading axis)."""
    if layout.world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // layout.world
        out[k] = v[layout.rank * per:(layout.rank + 1) * per]
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: np.ndarray | None = None) -> np.ndarray:
    """``np.ascontiguousarray(src[idx])``; with ``out`` (C-contiguous, of
    the result's shape and dtype) the rows are written there instead."""
    if out is None:
        return np.ascontiguousarray(src[idx])
    np.take(src, idx, axis=0, out=out)
    return out


def _load_npz(path: str) -> dict[str, np.ndarray]:
    """An npz's arrays: each stored (uncompressed) member memory-mapped in
    place, each compressed or object member read whole."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename.removesuffix(".npy")
            if info.compress_type == zipfile.ZIP_STORED:
                # the member's data follows its local header (30 bytes,
                # then the name and the extra field)
                f.seek(info.header_offset + 26)
                n_name, n_extra = struct.unpack("<HH", f.read(4))
                f.seek(info.header_offset + 30 + n_name + n_extra)
                version = np.lib.format.read_magic(f)
                read_header = (np.lib.format.read_array_header_1_0
                               if version == (1, 0)
                               else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read_header(f)
                if not dtype.hasobject:
                    out[name] = np.memmap(
                        path, dtype=dtype, mode="r", offset=f.tell(),
                        shape=shape, order="F" if fortran else "C")
                    continue
            with zf.open(info) as member:
                out[name] = np.lib.format.read_array(member,
                                                     allow_pickle=False)
    return out


def load_arrays(path: str) -> dict[str, np.ndarray]:
    """Load feature arrays from npy/npz/jsonl file or a directory of them."""
    if os.path.isdir(path):
        parts = [load_arrays(os.path.join(path, f))
                 for f in sorted(os.listdir(path))
                 if f.endswith((".npy", ".npz", ".jsonl"))]
        if not parts:
            return {}
        keys = parts[0].keys()
        return {k: np.concatenate([p[k] for p in parts if k in p]) for k in keys}
    if path.endswith(".npz"):
        return _load_npz(path)
    if path.endswith(".npy"):
        return {"input": np.load(path, mmap_mode="r")}
    if path.endswith(".jsonl"):
        rows: dict[str, list] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                for k, v in obj.items():
                    rows.setdefault(k, []).append(v)
        return {k: np.asarray(v) for k, v in rows.items()}
    raise ValueError(f"unsupported data path: {path}")


def _pinned_like(arr_shape, dtype: np.dtype) -> torch.Tensor:
    return torch.empty(arr_shape, dtype=torch.from_numpy(
        np.empty(0, dtype)).dtype, pin_memory=True)


class HostShardedLoader:
    """Iterate this rank's rows of global batches assembled from per-host
    shards.

    Each host cycles through its own contiguous slice with an
    epoch-seeded shuffle (same seed everywhere, disjoint index ranges, so
    the global epoch is a true permutation); ``local_batch`` is the
    host's share of the global batch and ``rank_batch`` this rank's
    contiguous part of it. ``device=None`` yields host (numpy) batches
    and leaves the transfer to a downstream :class:`PrefetchLoader`; a
    device yields torch tensors there (on the card, gathered into pinned
    memory and copied). ``layout`` defaults to the running process
    group's (:func:`~move2kube_tpu_torch.parallel.mesh.current_layout`)."""

    def __init__(self, arrays: dict[str, np.ndarray], global_batch: int,
                 seed: int = 0, device=None,
                 layout: ProcessLayout | None = None):
        if not arrays:
            raise ValueError("no arrays to load")
        self.device = torch.device(device) if device is not None else None
        n = min(len(v) for v in arrays.values())
        self.arrays = {k: v[:n] for k, v in arrays.items()}
        self.global_batch = global_batch
        self.seed = seed
        self.layout = layout = layout or current_layout()
        if global_batch % layout.world:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{layout.world} processes")
        self.local_batch = global_batch // layout.hosts
        self.rank_batch = global_batch // layout.world
        self.start, self.stop = _process_slice(n, layout)
        if self.stop - self.start < self.local_batch:
            raise ValueError(
                f"process shard has {self.stop - self.start} examples, "
                f"needs >= {self.local_batch}")
        self._epoch = 0
        self._order = self._reshuffle()
        self._cursor = 0
        self._batches = 0

    def _reshuffle(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self._epoch)
        idx = np.arange(self.start, self.stop)
        rng.shuffle(idx)
        return idx

    def __iter__(self):
        return self

    def _advance(self) -> np.ndarray:
        if self._cursor + self.local_batch > len(self._order):
            self._epoch += 1
            self._order = self._reshuffle()
            self._cursor = 0
        take = self._order[self._cursor:self._cursor + self.local_batch]
        self._cursor += self.local_batch
        self._batches += 1
        lo = self.layout.local_rank * self.rank_batch
        return take[lo:lo + self.rank_batch]

    def __next__(self) -> dict:
        take = self._advance()
        out = {}
        for k, v in self.arrays.items():
            if self.device is None:
                out[k] = gather_rows(v, take)
            elif self.device.type == "cuda":
                pinned = _pinned_like((len(take),) + v.shape[1:], v.dtype)
                gather_rows(v, take, out=pinned.numpy())
                out[k] = pinned.to(self.device)
            else:
                out[k] = torch.from_numpy(gather_rows(v, take))
        return out

    def skip(self, n: int) -> None:
        """Advance the stream n batches WITHOUT materializing them: resume
        fast-forward is cursor arithmetic, not n gathers."""
        for _ in range(n):
            self._advance()

    def position(self) -> int:
        """Batches this stream has handed out or skipped (the cursor a
        checkpoint records)."""
        return self._batches

    # uniform loader protocol: every make_loader() product is a context
    # manager, so retry loops can hold ANY loader in a `with` without
    # caring which variant owns a pump thread
    def close(self) -> None:
        """Nothing to release (no thread, no buffered device batches)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _PinnedSlot:
    """One pinned host buffer per array key, and the event of the last
    copy out of it."""

    def __init__(self) -> None:
        self.buffers: dict[str, torch.Tensor] = {}
        self.event = None

    def fill(self, key: str, host: np.ndarray) -> torch.Tensor:
        buf = self.buffers.get(key)
        if (buf is None or tuple(buf.shape) != host.shape
                or buf.numpy().dtype != host.dtype):
            buf = self.buffers[key] = _pinned_like(host.shape, host.dtype)
        np.copyto(buf.numpy(), host)
        return buf


class PrefetchLoader:
    """Double-buffered *device* prefetch: a background thread assembles
    the next batch (shuffle gather) and starts its host-to-device copy
    while the card runs the current step, so the steady-state step time is
    ~max(host, compute) instead of their sum.

    ``device``: None passes the inner loader's items through; ``cpu``
    turns host arrays into tensors; a card copies them through a ring of
    ``depth + 2`` pinned buffers on a side stream (see the module's
    docstring for what keeps each buffer alive).

    ``skip`` must be called before iteration starts (resume fast-forward
    happens before the training loop): once the thread is running the
    already-buffered batches would be from the pre-skip stream."""

    def __init__(self, inner, depth: int = 2, device=None):
        self._inner = inner
        self._device = torch.device(device) if device is not None else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread: threading.Thread | None = None
        self._dead: BaseException | None = None
        self._terminated = False  # the one None sentinel was consumed
        self._closed = False
        self._handed = 0
        self._skipped = 0
        self._cuda = self._device is not None and self._device.type == "cuda"
        self._slots = [_PinnedSlot() for _ in range(depth + 2)] \
            if self._cuda else []
        self._next_slot = 0
        self._stream = None

    def _transfer(self, item):
        """Start the host-to-device copy of every host array (tensors pass
        through untouched); returns ``(item, event)``."""
        if self._device is None or not isinstance(item, dict):
            return item, None
        if not self._cuda:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    if isinstance(v, np.ndarray) else v
                    for k, v in item.items()}, None
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot.event is not None:
            # the buffer's previous copy must have left it before the
            # gather overwrites it
            slot.event.synchronize()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self._device)
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in item.items():
                if isinstance(v, np.ndarray):
                    src = slot.fill(k, v)
                    out[k] = src.to(self._device, non_blocking=True)
                else:
                    out[k] = v
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return out, slot.event

    def _pump(self):
        try:
            while not self._closed:
                item = self._transfer(next(self._inner))
                # bounded put so an abandoned loader (consumer broke out
                # mid-epoch) unblocks and exits once close() is called
                while not self._closed:
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 - re-raised in __next__
            self._dead = e
            while not self._closed:
                try:
                    self._q.put(None, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def close(self) -> None:
        """Stop the pump thread and drop buffered batches."""
        self._closed = True
        if self._thread is not None:
            while True:  # drain so a put-blocked pump can observe _closed
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                log.warning(
                    "PrefetchLoader pump thread still alive 5s after "
                    "close(); leaking a daemon thread (inner loader "
                    "blocked in next()?)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def skip(self, n: int) -> None:
        if self._thread is not None:
            raise RuntimeError("skip() after iteration started")
        self._inner.skip(n)
        self._skipped += n

    def position(self) -> int:
        """Batches handed to the consumer or skipped (the pump's read-ahead
        is not counted)."""
        return self._skipped + self._handed

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._terminated:
            raise self._dead if self._dead is not None else StopIteration
        if self._thread is None:
            self._thread = threading.Thread(target=self._pump, daemon=True)
            self._thread.start()
        got = self._q.get()
        if got is None:
            self._terminated = True
            raise self._dead if self._dead is not None else StopIteration
        item, event = got
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for v in item.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(consumer)
        self._handed += 1
        return item


def _stack(micro: list):
    if isinstance(micro[0], dict):
        return {k: _stack([m[k] for m in micro]) for k in micro[0]}
    if isinstance(micro[0], torch.Tensor):
        return torch.stack(micro)
    return np.stack(micro)


class AccumLoader:
    """Group ``k`` consecutive microbatches from an inner loader into one
    stacked batch with a leading ``[k, ...]`` axis: the shape the
    ``grad_accum=k`` train steps consume (one optimizer update per
    ``next()``). ``skip`` counts in optimizer steps, so a resumed run
    fast-forwards ``n * k`` microbatches."""

    def __init__(self, inner, k: int):
        if k < 1:
            raise ValueError(f"accumulation factor must be >= 1, got {k}")
        self._inner = inner
        self._k = k

    def __iter__(self):
        return self

    def __next__(self):
        return _stack([next(self._inner) for _ in range(self._k)])

    def skip(self, n: int) -> None:
        self._inner.skip(n * self._k)

    def position(self) -> int:
        return self._inner.position() // self._k

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _Synthetic:
    def __init__(self, fn, layout: ProcessLayout):
        self._fn = fn
        self._layout = layout
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        batch = _rank_rows(self._fn(self._i), self._layout)
        self._i += 1
        return batch

    def skip(self, n: int) -> None:
        self._i += n

    def position(self) -> int:
        return self._i

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def make_loader(path: str, global_batch: int, device=None,
                synthetic_fn=None, seed: int = 0, prefetch: bool = True,
                mesh=None):
    """Return an iterator of this rank's rows of each global batch, dicts
    of tensors on ``device`` (the rank's card unless the caller asks for
    the CPU): real data when ``path`` exists, else the synthetic
    generator ``synthetic_fn(i)`` of global batches (the emitted
    programs' out-of-the-box mode). Real-data loaders are wrapped in a
    :class:`PrefetchLoader` unless ``prefetch=False`` (or
    ``M2KT_PREFETCH=0``): the inner loader stays on the host and the pump
    thread owns the copy, overlapping it with the running step. A
    ``mesh`` with a pipe axis above 1 raises (ROADMAP Queue 1 item 9e);
    on a data x fsdp mesh each rank takes its rows, rank r of the world
    (fsdp inner) the r-th block, as the reference shards the batch over
    ``("data", "fsdp")``, and the tensor, seq and expert ranks of one
    batch coordinate take the same rows
    (:func:`~move2kube_tpu_torch.parallel.mesh.batch_layout`; the LM step
    cuts a seq rank's tokens from them)."""
    dev = resolve_device(device)
    layout = current_layout()
    if mesh is not None:
        from move2kube_tpu_torch.parallel.mesh import (
            batch_layout,
            check_ported_mesh,
            mesh_config_of,
        )

        cfg = mesh_config_of(mesh)
        check_ported_mesh(cfg)
        layout = batch_layout(layout, cfg)
    if path and os.path.exists(path):
        use_prefetch = (prefetch
                        and os.environ.get("M2KT_PREFETCH", "1") != "0")
        loader = HostShardedLoader(load_arrays(path), global_batch, seed,
                                   device=None if use_prefetch else dev,
                                   layout=layout)
        if use_prefetch:
            return PrefetchLoader(loader, device=dev)
        return loader
    if synthetic_fn is None:
        raise ValueError(f"data path {path!r} not found and no synthetic fn")
    return _Synthetic(synthetic_fn, layout)
