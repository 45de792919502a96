"""Paged KV cache: fixed-size pages + per-sequence block tables (the port
of ``move2kube_tpu/serving/kvcache.py``).

The cache is a pool of ``[block_size]``-token pages per layer; a sequence
owns whichever pages the host-side :class:`PageAllocator` hands it, and an
int32 block table maps its logical positions onto them. Finishing a
sequence returns its pages to the free list; nothing moves.

Page 0 is **reserved** (the "null page"): unused block-table entries and
padded prompt positions all point at it, so the index math needs no
bounds branches: garbage lands in, and masked reads come from, a page no
live sequence owns.

Pages are stored in the model's compute type, or as int8 rows with one
fp32 scale per written (token, kv-head) row (``KVCacheConfig.dtype =
torch.int8``): the cache then carries ``k_scale``/``v_scale`` pools
``[num_pages, block_size, kv_heads]`` beside ``k``/``v``, and every page
operation moves them together.

Where the JAX package donates the cache pytree to each jitted step and
gets updated buffers back, the port updates the page pools, block tables
and sequence lengths **in place** (``index_put_`` and slice assignment):
the functions below mutate ``cache`` and return it for symmetry with
their JAX counterparts.
"""

from __future__ import annotations

import dataclasses

import torch

from move2kube_tpu_torch.ops.attention import quantize_kv_rows

NULL_PAGE = 0

# every per-page pool a cache may carry; copy_page and the engine's
# model-cache assembly iterate this, so the int8 scale pools ride every
# page operation the K/V pools do
PAGE_KEYS = ("k", "v", "k_scale", "v_scale")


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    block_size: int = 16        # tokens per page
    num_pages: int = 65         # pool size, INCLUDING the reserved page 0
    max_batch: int = 8          # concurrent decode slots
    max_pages_per_seq: int = 16  # block-table row length
    # dtype the K/V pages are stored in: the compute type, or int8 with
    # per-row scales in ``scale_dtype``
    dtype: torch.dtype = torch.float32
    scale_dtype: torch.dtype = torch.float32

    @property
    def max_seq(self) -> int:
        return self.max_pages_per_seq * self.block_size

    @property
    def quantized(self) -> bool:
        """True when pages store int8 rows and the cache carries the
        ``k_scale``/``v_scale`` row-scale pools."""
        return self.dtype == torch.int8


def spec_for_model(model_cfg, *, block_size: int = 16, max_batch: int = 8,
                   max_seq: int | None = None,
                   cache_dtype: torch.dtype | None = None) -> KVCacheConfig:
    """Cache geometry for a model config (``LlamaConfig`` or
    ``GPT2Config``, duck-typed: MHA models have no ``num_kv_heads``, and
    ``max_seq`` defaults to ``max_len`` or else ``n_positions``): one
    full-length context per slot plus the null page, stored in
    ``cache_dtype`` (``torch.int8`` for the quantized layout), by default
    the model's compute dtype."""
    if max_seq is None:
        max_seq = getattr(model_cfg, "max_len", None) or (
            model_cfg.n_positions)
    max_pages = -(-max_seq // block_size)
    return KVCacheConfig(
        num_layers=model_cfg.num_layers,
        num_kv_heads=getattr(model_cfg, "num_kv_heads", model_cfg.num_heads),
        head_dim=model_cfg.d_model // model_cfg.num_heads,
        block_size=block_size, num_pages=1 + max_batch * max_pages,
        max_batch=max_batch, max_pages_per_seq=max_pages,
        dtype=model_cfg.dtype if cache_dtype is None else cache_dtype)


def pages_for(n_tokens: int, block_size: int) -> int:
    return -(-int(n_tokens) // int(block_size))


def sanitized_views(cache: dict, active: torch.Tensor):
    """Decode-time ``(block_tables, positions)`` with every inactive row
    redirected at the null page / position 0.

    The decode step runs the *full* ``max_batch`` whatever the number of
    live slots, and empty rows still index the page pool. This makes them
    harmless: their writes land in the reserved page 0 and their position
    math stays in range (a step that skipped it would write a garbage row
    into a *live* sequence's page)."""
    bt = torch.where(active[:, None], cache["block_tables"],
                     torch.full_like(cache["block_tables"], NULL_PAGE))
    pos = torch.where(active, cache["seq_lens"],
                      torch.zeros_like(cache["seq_lens"]))
    return bt, pos


def init_cache(cfg: KVCacheConfig, device) -> dict:
    """Zeroed cache on ``device``: ``k``/``v`` are per-layer *lists* of
    page pools ``[num_pages, block_size, kv_heads, head_dim]``, plus the
    int32 ``block_tables [max_batch, max_pages_per_seq]`` and ``seq_lens
    [max_batch]``; an int8 cache adds per-layer ``k_scale``/``v_scale``
    pools ``[num_pages, block_size, kv_heads]`` in ``scale_dtype``."""
    shape = (cfg.num_pages, cfg.block_size, cfg.num_kv_heads, cfg.head_dim)
    cache = {
        "k": [torch.zeros(shape, dtype=cfg.dtype, device=device)
              for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=cfg.dtype, device=device)
              for _ in range(cfg.num_layers)],
        "block_tables": torch.zeros((cfg.max_batch, cfg.max_pages_per_seq),
                                    dtype=torch.int32, device=device),
        "seq_lens": torch.zeros((cfg.max_batch,), dtype=torch.int32,
                                device=device),
    }
    if cfg.quantized:
        sshape = shape[:3]
        for key in ("k_scale", "v_scale"):
            cache[key] = [torch.zeros(sshape, dtype=cfg.scale_dtype,
                                      device=device)
                          for _ in range(cfg.num_layers)]
    _check_page_schema(cache, "init_cache")
    return cache


def _check_page_schema(cache: dict, where: str) -> None:
    """Fail loudly when the cache's page pools and ``PAGE_KEYS`` drift: a
    pool that the page operations do not know would be silently skipped
    by them (a COW copy that dropped the scales would dequantize the
    copied rows with zeros). An fp cache carries ``k``/``v``, an int8
    cache all of ``PAGE_KEYS``."""
    pools = tuple(k for k in cache if isinstance(cache[k], list))
    unknown = [k for k in pools if k not in PAGE_KEYS]
    expected = PAGE_KEYS if "k_scale" in cache else PAGE_KEYS[:2]
    if unknown or tuple(k for k in PAGE_KEYS if k in cache) != expected:
        raise ValueError(
            f"{where}: page-pool schema mismatch: cache carries pools "
            f"{pools}, PAGE_KEYS declares {PAGE_KEYS} (expected "
            f"{expected}). Teach init_cache, scatter_prefill and copy_page "
            "about the new pool before serving with it.")


def scatter_prefill(cache: dict, kvs, slot: int, bt_row: torch.Tensor,
                    prompt_len: int, block_size: int) -> dict:
    """Write a prefilled prompt's per-layer K/V into the paged cache, in
    place.

    ``kvs``: the ``return_kv=True`` output of the model's full forward,
    one ``(k, v)`` pair per layer shaped ``[1, bucket, kv_heads, hd]``.
    ``bt_row``: this sequence's page table ``[max_pages_per_seq]`` (int32,
    padded with the null page). Positions at or past ``prompt_len``
    (bucket padding) are redirected to the null page. An int8 cache
    stores the rows quantized by :func:`quantize_kv_rows` and their
    scales. Also installs the row and the sequence length into the
    cache's table."""
    _check_page_schema(cache, "scatter_prefill")
    bucket = kvs[0][0].shape[1]
    device = cache["block_tables"].device
    bt_row = bt_row.to(device)
    pos = torch.arange(bucket, device=device)
    blk = torch.where(pos < prompt_len, bt_row[pos // block_size].long(),
                      torch.full_like(pos, NULL_PAGE))
    off = pos % block_size
    quantized = "k_scale" in cache
    for layer, (k, v) in enumerate(kvs):
        kp, vp = cache["k"][layer], cache["v"][layer]
        if quantized:
            kp[blk, off], cache["k_scale"][layer][blk, off] = (
                quantize_kv_rows(k[0]))
            vp[blk, off], cache["v_scale"][layer][blk, off] = (
                quantize_kv_rows(v[0]))
        else:
            kp[blk, off] = k[0].to(kp.dtype)
            vp[blk, off] = v[0].to(vp.dtype)
    return install_block_table(cache, slot, bt_row, prompt_len)


def copy_page(cache: dict, src: int, dst: int) -> dict:
    """Copy one page across every layer, in place: the device half of
    copy-on-write (a slot about to write into a page it shares first
    duplicates it into a private page and points its table entry at the
    copy). Dtype-generic over every pool the cache carries
    (``PAGE_KEYS``), so an int8 page and its row scales stay together."""
    _check_page_schema(cache, "copy_page")
    for key in PAGE_KEYS:
        for pool in cache.get(key, ()):
            pool[dst] = pool[src]
    return cache


def install_block_table(cache: dict, slot: int, bt_row: torch.Tensor,
                        seq_len: int) -> dict:
    """Point decode slot ``slot`` at the page run ``bt_row`` holding
    ``seq_len`` tokens, in place."""
    cache["block_tables"][slot] = bt_row.to(cache["block_tables"].device)
    cache["seq_lens"][slot] = seq_len
    return cache


class PageAllocator:
    """Host-side refcounted free list over the page pool (the JAX
    package's allocator, copied). Page 0 never leaves the reserve.
    Allocation is all-or-nothing: a request that cannot get every page it
    needs gets none (the engine keeps it queued instead of deadlocking
    half-admitted). ``alloc`` hands out pages at refcount 1, ``incref``
    adds holders, and ``free`` is a decref that returns a page to the
    free list only when its last holder drops it. The free order is LIFO
    (freshly released pages are the warmest), with a shadow set making
    release O(1) per page."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._free = list(range(num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs: dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        pages = []
        for _ in range(n):
            p = self._free.pop()
            self._free_set.remove(p)
            self._refs[p] = 1
            pages.append(p)
        return pages

    def incref(self, pages) -> None:
        """Add a holder to already-allocated pages."""
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("page 0 is reserved and never allocated")
            if p not in self._refs:
                raise ValueError(f"incref of unallocated page {p}")
            self._refs[p] += 1

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def is_shared(self, page: int) -> bool:
        """More than one holder: writes must copy-on-write first."""
        return self._refs.get(int(page), 0) > 1

    def reclaimable(self, pages) -> int:
        """How many of ``pages`` would return to the free list if their
        holder freed them now; shared pages (prefix cache, copy-on-write
        siblings) stay resident under their other holders."""
        return sum(1 for p in pages if self._refs.get(int(p), 0) == 1)

    def free(self, pages) -> None:
        """Drop one reference per page; a page returns to the free list
        only when its last holder releases it."""
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("page 0 is reserved and never allocated")
            if p in self._free_set:
                raise ValueError(f"double free of page {p}")
            n = self._refs.get(p, 0)
            if n <= 0:
                raise ValueError(f"double free of page {p}")
            if n == 1:
                del self._refs[p]
                self._free.append(p)
                self._free_set.add(p)
            else:
                self._refs[p] = n - 1
