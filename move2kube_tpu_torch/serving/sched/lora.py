"""Scheduler plane, multi-LoRA side: paged adapter weights, the port's
own copy of ``move2kube_tpu/serving/sched/lora.py``.

Many fine-tunes share one base model when the adapter weights are paged
like KV and the A/B products are gathered per slot inside each pass.
The adapter store reuses the serving page machinery directly: rows in
two stacked host arrays (``a [rows, d_model, rank]``, ``b [rows, rank,
vocab]``) are handed out by the same refcounted
:class:`~move2kube_tpu_torch.serving.kvcache.PageAllocator` that backs
the KV pool. Row 0 is the reserved NULL row and holds zeros, so the base
model is "adapter 0" and a batch mixing adapted and plain requests needs
no masking, just the gather.

The stacks reach every pass as tensors on the engine's device
(:meth:`AdapterStore.stacks`, cached per registry version), so
registering an adapter only makes a new pair of tensors. Adapters of a
rank below the configured maximum are zero-padded on the rank axis,
which is exact.

On-disk registry format (``M2KT_LORA_DIR``): a directory of
``<name>.npz`` files, each with arrays ``a [d_model, r]`` and
``b [r, vocab]``, ``r <= lora_rank``.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from move2kube_tpu_torch.serving.kvcache import PageAllocator

NULL_ADAPTER = 0  # row 0: all-zeros delta == base model


class AdapterStore:
    """Up to ``max_loras`` resident adapters as stacked A/B rows.

    ``register`` pins a row (refcount 1, the registration's);
    ``acquire``/``release`` bracket a request's use of it so
    ``unregister`` cannot pull weights out from under an in-flight
    batch (the row only returns to the pool at refcount zero, the
    KV-page lifecycle). ``device`` is where :meth:`stacks` puts the
    tensors the passes read."""

    def __init__(self, d_model: int, vocab: int, rank: int,
                 max_loras: int, device=None) -> None:
        if max_loras < 1:
            raise ValueError(f"max_loras must be >= 1, got {max_loras}")
        if rank < 1:
            raise ValueError(f"lora rank must be >= 1, got {rank}")
        self.d_model = int(d_model)
        self.vocab = int(vocab)
        self.rank = int(rank)
        self.max_loras = int(max_loras)
        self.device = torch.device("cpu" if device is None else device)
        self._a = np.zeros((max_loras + 1, d_model, rank), np.float32)
        self._b = np.zeros((max_loras + 1, rank, vocab), np.float32)
        self._rows = PageAllocator(max_loras + 1)
        self._row_by_name: dict[str, int] = {}
        self._unregistered: set[int] = set()
        self._lock = threading.Lock()
        self._version = 0        # bumped per register/unregister
        self._device = None      # (version, a, b) on the device

    # ------------------------------------------------------------------
    # registry
    # ------------------------------------------------------------------

    @property
    def names(self) -> list:
        with self._lock:
            return sorted(self._row_by_name)

    @property
    def version(self) -> int:
        return self._version

    def register(self, name: str, a, b) -> int:
        """Install adapter ``name``; returns its row id."""
        if not name:
            raise ValueError("adapter name must be non-empty")
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(
                f"adapter {name!r}: want a [d,r] / b [r,v], got "
                f"{a.shape} / {b.shape}")
        r = a.shape[1]
        if a.shape[0] != self.d_model or b.shape[1] != self.vocab:
            raise ValueError(
                f"adapter {name!r}: shape {a.shape}/{b.shape} does not "
                f"match model d={self.d_model} vocab={self.vocab}")
        if r > self.rank:
            raise ValueError(
                f"adapter {name!r}: rank {r} exceeds configured "
                f"lora_rank {self.rank}")
        with self._lock:
            if name in self._row_by_name:
                raise ValueError(f"adapter {name!r} already registered")
            got = self._rows.alloc(1)
            if got is None:
                raise ValueError(
                    f"adapter store full ({self.max_loras} rows); "
                    "unregister one first")
            row = got[0]
            self._a[row] = 0.0
            self._b[row] = 0.0
            self._a[row, :, :r] = a
            self._b[row, :r, :] = b
            self._row_by_name[name] = row
            self._unregistered.discard(row)
            self._version += 1
            return row

    def unregister(self, name: str) -> None:
        """Drop the registration ref; the row frees once in-flight
        requests release it."""
        with self._lock:
            row = self._row_by_name.pop(name)
            self._unregistered.add(row)
            self._rows.free([row])
            self._version += 1

    def load_dir(self, path: str, *, warn=None) -> int:
        """Load every ``<name>.npz`` under ``path``; returns the count.
        Malformed files warn and are skipped."""
        if warn is None:
            def warn(msg):
                print(f"[m2kt] WARNING: {msg}", flush=True)
        n = 0
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".npz"):
                continue
            name = fname[:-4]
            try:
                with np.load(os.path.join(path, fname)) as z:
                    self.register(name, z["a"], z["b"])
                n += 1
            except Exception as e:  # noqa: BLE001 - tolerant: skip the file
                warn(f"adapter file {fname!r} skipped: {e}")
        return n

    # ------------------------------------------------------------------
    # per-request row lifecycle
    # ------------------------------------------------------------------

    def acquire(self, name: str) -> int:
        """Take a ref on ``name``'s row for one request; '' is the base
        model (row 0, no ref needed). Unknown names raise ValueError:
        submit-time rejection, as for an over-long prompt."""
        if not name:
            return NULL_ADAPTER
        with self._lock:
            row = self._row_by_name.get(name)
            if row is None:
                raise ValueError(f"unknown adapter {name!r} "
                                 f"(registered: {sorted(self._row_by_name)})")
            self._rows.incref([row])
            return row

    def release(self, row: int) -> None:
        if row == NULL_ADAPTER:
            return
        with self._lock:
            self._rows.free([row])

    def refcount(self, row: int) -> int:
        return self._rows.refcount(row)

    # ------------------------------------------------------------------
    # what the passes see
    # ------------------------------------------------------------------

    def stacks(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The (a, b) stacks as fp32 tensors on the store's device,
        cached per registry version: a registry change is a new pair of
        tensors, copied once."""
        with self._lock:
            cached = self._device
            if cached is not None and cached[0] == self._version:
                return cached[1], cached[2]
            a_dev = torch.from_numpy(self._a.copy()).to(self.device)
            b_dev = torch.from_numpy(self._b.copy()).to(self.device)
            self._device = (self._version, a_dev, b_dev)
            return a_dev, b_dev
