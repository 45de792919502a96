"""Persistent kernel build cache: the port's counterpart of
``move2kube_tpu/models/compile_cache.py``, under the same knobs.

The port compiles nothing but its ``nvcc`` kernels
(:mod:`move2kube_tpu_torch.ops._build`), so the counterpart of JAX's
executable cache is the kernel build directory. Pointing it at a durable
directory means a restarted trainer or a re-spawned server loads
yesterday's libraries instead of running ``nvcc`` again. Each library's
name carries a digest of its sources and flags, so a stale library never
loads: an edited kernel gets a new name and is built.

Knobs:

- ``M2KT_COMPILE_CACHE=0``   disable entirely (the package's own build
  directory stays in use)
- ``M2KT_COMPILE_CACHE_DIR`` cache directory (wins over the caller's
  default, so operators can redirect to a mounted volume)
- ``M2KT_PREWARM_DIR``       read-only prewarm artifact: libraries baked
  into the image (or an init-container volume) under the same
  fingerprint layout; a cold replica's empty cache is seeded from it
  before anything is built, so scale-up skips the compile step

Libraries built for another card or CUDA version are not
interchangeable: :func:`setup_compilation_cache` partitions the
directory by a :func:`topology_fingerprint` (the card's name, its compute
capability and the CUDA version). The cache holds kernel builds, which do
not depend on the mesh, so nothing of the reference's mesh and slice tag
carries over.
"""

from __future__ import annotations

import os
import re
import shutil

from move2kube_tpu_torch.ops import _build

_DEFAULT_DIR = os.path.join("~", ".cache", "m2kt-torch-cache")
# what a build leaves per kernel: the library and its compiler log
ENTRY_SUFFIXES = (".so", ".log")


def topology_fingerprint() -> str:
    """Filesystem-safe cache-key component for this process's card:
    ``<device name>-sm<major><minor>-cuda<version>``, for example
    ``NVIDIA_H100_80GB_HBM3-sm90-cuda12.8``. Empty string without a card:
    those callers get the unpartitioned directory."""
    import torch

    if not torch.cuda.is_available():
        return ""
    name = re.sub(r"[^A-Za-z0-9_.-]+", "_", torch.cuda.get_device_name(0))
    major, minor = torch.cuda.get_device_capability(0)
    return f"{name}-sm{major}{minor}-cuda{torch.version.cuda}"


def setup_compilation_cache(default_dir: str | None = None) -> str | None:
    """Point the kernel build directory at the persistent cache; returns
    the directory in use, or None when disabled or unwritable.

    ``default_dir`` is the *caller's* default; the operator env var
    ``M2KT_COMPILE_CACHE_DIR`` takes precedence, and the user cache dir is
    the last resort. Libraries land in a per-card subdirectory (see
    :func:`topology_fingerprint`), seeded from ``M2KT_PREWARM_DIR`` when
    one is set. Safe to call more than once: each call re-points the
    directory; kernels already loaded stay loaded."""
    if os.environ.get("M2KT_COMPILE_CACHE", "1") == "0":
        return None
    path = (os.environ.get("M2KT_COMPILE_CACHE_DIR") or default_dir
            or _DEFAULT_DIR)
    path = os.path.abspath(os.path.expanduser(path))
    fp = topology_fingerprint()
    if fp:
        path = os.path.join(path, fp)
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None  # read-only filesystem etc: build in the package
    seed_from_prewarm(path, fp)
    _build.set_build_dir(path)
    return path


def _entries(directory: str) -> list[str]:
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    return [n for n in names if n.endswith(ENTRY_SUFFIXES)
            and os.path.isfile(os.path.join(directory, n))]


def seed_from_prewarm(cache_dir: str, fingerprint: str = "",
                      prewarm_dir: str | None = None) -> int:
    """Copy baked libraries and their logs into a (possibly empty) live
    cache directory.

    The prewarm artifact (``M2KT_PREWARM_DIR``) mirrors the cache layout:
    entries for a fingerprinted card live under
    ``<prewarm>/<fingerprint>``, unfingerprinted ones at the top level.
    Only missing ``.so`` and ``.log`` files are copied (the live cache is
    never overwritten), and any filesystem trouble degrades to an ordinary
    cold build. Returns the number of files seeded."""
    src = (prewarm_dir if prewarm_dir is not None
           else os.environ.get("M2KT_PREWARM_DIR", ""))
    if not src:
        return 0
    src = os.path.abspath(os.path.expanduser(src))
    if fingerprint:
        src = os.path.join(src, fingerprint)
    if not os.path.isdir(src) or os.path.realpath(src) == \
            os.path.realpath(cache_dir):
        return 0
    seeded = 0
    try:
        for fname in _entries(src):
            d = os.path.join(cache_dir, fname)
            if os.path.exists(d):
                continue
            # copy under a temporary name: a library is never seen half
            # written by a process loading it
            tmp = f"{d}.{os.getpid()}.seed"
            shutil.copyfile(os.path.join(src, fname), tmp)
            os.replace(tmp, d)
            seeded += 1
    except OSError:
        return seeded  # partial seed is still a head start
    return seeded


def bake_prewarm(prewarm_dir: str) -> int:
    """The build-time half of the prewarm story: run
    :func:`~move2kube_tpu_torch.ops._build.build_all` on every kernel of
    the port into ``<prewarm_dir>/<fingerprint>``, the
    layout :func:`seed_from_prewarm` reads, so the artifact only ever
    thaws on a matching card. The process's build directory is restored
    afterwards. Returns the number of files baked (built now, not found
    there already)."""
    from move2kube_tpu_torch.ops.attention import KERNELS

    dst = os.path.abspath(os.path.expanduser(prewarm_dir))
    fp = topology_fingerprint()
    if fp:
        dst = os.path.join(dst, fp)
    os.makedirs(dst, exist_ok=True)
    before = set(_entries(dst))
    prev = _build.set_build_dir(dst)
    try:
        _build.build_all(KERNELS)
    finally:
        _build.set_build_dir(prev)
    return len(set(_entries(dst)) - before)
