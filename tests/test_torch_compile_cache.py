"""The port's kernel build cache (``move2kube_tpu_torch/models/
compile_cache.py``) against the JAX package's compile-cache contracts
(``move2kube_tpu/models/compile_cache.py``): the directory's precedence
(env, then the caller's default, then the user cache), the disable knob,
an unwritable directory degrading to no cache, the fingerprint's form,
``seed_from_prewarm`` copying only missing libraries and logs (as the
reference's copies only missing entries, side by side on the same
artifact), and ``bake_prewarm`` with ``_build.build_all`` stood in for
(there is no ``nvcc`` here).

The build directory is restored after every test, and checked; so are
the SIGTERM handler and ``os.environ``.
"""

import os
import re
import signal

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.models import compile_cache as jcc  # noqa: E402
from move2kube_tpu_torch.models import compile_cache as tcc  # noqa: E402
from move2kube_tpu_torch.ops import _build  # noqa: E402
from move2kube_tpu_torch.ops.attention import KERNELS  # noqa: E402


def _environ() -> dict:
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


@pytest.fixture(autouse=True)
def _build_dir_restored(monkeypatch):
    """Each test may re-point the build directory; it is put back after,
    and the env knobs start unset."""
    handler = signal.getsignal(signal.SIGTERM)
    env = _environ()
    before = _build.build_dir()
    prev = _build.set_build_dir(before)
    for knob in ("M2KT_COMPILE_CACHE", "M2KT_COMPILE_CACHE_DIR",
                 "M2KT_PREWARM_DIR"):
        monkeypatch.delenv(knob, raising=False)
    yield
    monkeypatch.undo()
    _build.set_build_dir(prev)
    assert _build.build_dir() == before
    assert signal.getsignal(signal.SIGTERM) == handler
    assert _environ() == env


def _fake_card(monkeypatch, name="NVIDIA H100 80GB HBM3", cc=(9, 0),
               cuda="12.8"):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: cc)
    monkeypatch.setattr(torch.version, "cuda", cuda)


def test_fingerprint_form(monkeypatch):
    if not torch.cuda.is_available():
        assert tcc.topology_fingerprint() == ""
    _fake_card(monkeypatch)
    fp = tcc.topology_fingerprint()
    assert fp == "NVIDIA_H100_80GB_HBM3-sm90-cuda12.8"
    assert re.fullmatch(r"[A-Za-z0-9_.-]+", fp)
    _fake_card(monkeypatch, name="Some/GPU (x)", cc=(8, 6), cuda="12.4")
    assert tcc.topology_fingerprint() == "Some_GPU_x_-sm86-cuda12.4"


def test_setup_points_the_build_dir(tmp_path, monkeypatch):
    _fake_card(monkeypatch)
    got = tcc.setup_compilation_cache(str(tmp_path / "default"))
    want = tmp_path / "default" / "NVIDIA_H100_80GB_HBM3-sm90-cuda12.8"
    assert got == str(want) and want.is_dir()
    assert _build.build_dir() == want
    lib = KERNELS[0].library_path()
    assert lib.parent == want and lib.name.startswith(KERNELS[0].name + "-")


def test_env_dir_beats_caller_default(tmp_path, monkeypatch):
    monkeypatch.setenv("M2KT_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    ours = tcc.setup_compilation_cache(str(tmp_path / "default"))
    assert ours.startswith(str(tmp_path / "env"))
    assert not (tmp_path / "default").exists()


def test_user_cache_is_the_last_resort(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    got = tcc.setup_compilation_cache()
    assert got.startswith(str(tmp_path / "home" / ".cache"))
    assert os.path.isdir(got)


def test_disable_knob_wins_over_everything(tmp_path, monkeypatch):
    monkeypatch.setenv("M2KT_COMPILE_CACHE", "0")
    monkeypatch.setenv("M2KT_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    before = _build.build_dir()
    assert tcc.setup_compilation_cache(str(tmp_path / "d")) is None
    assert jcc.setup_compilation_cache(str(tmp_path / "d")) is None
    assert _build.build_dir() == before
    assert not (tmp_path / "env").exists()


def test_unwritable_dir_degrades_to_no_cache(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    before = _build.build_dir()
    assert tcc.setup_compilation_cache(str(blocker / "cache")) is None
    assert _build.build_dir() == before


def _artifact(root, names):
    root.mkdir(parents=True, exist_ok=True)
    for n in names:
        (root / n).write_bytes(n.encode())


def test_seed_copies_only_missing_libraries(tmp_path, monkeypatch):
    """Side by side with the reference on the same artifact: both copy the
    missing files and never overwrite the live cache; the port copies only
    libraries and their logs."""
    fp = "card-sm90-cuda12.8"
    pre = tmp_path / "prewarm"
    _artifact(pre / fp, ["flash_fwd-aaaa.so", "flash_fwd-aaaa.log",
                         "paged_decode-bbbb.so", "paged_decode-bbbb.log"])
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for live in (ours, theirs):
        live.mkdir()
        (live / "paged_decode-bbbb.so").write_bytes(b"live")
    n = tcc.seed_from_prewarm(str(ours), fp, prewarm_dir=str(pre))
    m = jcc.seed_from_prewarm(str(theirs), fp, prewarm_dir=str(pre))
    assert n == m == 3
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    assert (ours / "paged_decode-bbbb.so").read_bytes() == b"live"
    assert (ours / "flash_fwd-aaaa.so").read_bytes() == b"flash_fwd-aaaa.so"
    (pre / fp / "notes.txt").write_text("not a build product")
    (ours / "flash_fwd-aaaa.so").unlink()
    assert tcc.seed_from_prewarm(str(ours), fp, prewarm_dir=str(pre)) == 1
    assert "notes.txt" not in os.listdir(ours)
    # no artifact, no knob, or the cache itself: nothing to seed
    assert tcc.seed_from_prewarm(str(ours), "other", str(pre)) == 0
    assert tcc.seed_from_prewarm(str(ours), fp) == 0
    assert tcc.seed_from_prewarm(str(pre / fp), fp, str(pre)) == 0
    monkeypatch.setenv("M2KT_PREWARM_DIR", str(pre))
    (ours / "paged_decode-bbbb.log").unlink()
    assert tcc.seed_from_prewarm(str(ours), fp) == 1


def test_setup_seeds_from_the_prewarm_knob(tmp_path, monkeypatch):
    _fake_card(monkeypatch)
    fp = tcc.topology_fingerprint()
    lib = KERNELS[1].library_path().name
    _artifact(tmp_path / "pre" / fp, [lib, lib[:-3] + ".log"])
    monkeypatch.setenv("M2KT_PREWARM_DIR", str(tmp_path / "pre"))
    got = tcc.setup_compilation_cache(str(tmp_path / "cache"))
    assert sorted(os.listdir(got)) == sorted([lib, lib[:-3] + ".log"])
    assert KERNELS[1].library_path() == tmp_path / "cache" / fp / lib


def test_bake_prewarm_builds_into_the_fingerprint_dir(tmp_path, monkeypatch):
    """``bake_prewarm`` runs ``build_all`` with the build directory on the
    artifact, then puts the directory back; a second bake adds nothing."""
    _fake_card(monkeypatch)
    seen = []

    def fake_build_all(kernels):
        seen.append((list(kernels), _build.build_dir()))
        for k in kernels:
            lib = k.library_path()
            lib.write_bytes(b"\x7fELF")
            lib.with_suffix(".log").write_text("ptxas info")
        return {}

    monkeypatch.setattr(_build, "build_all", fake_build_all)
    before = _build.build_dir()
    assert tcc.bake_prewarm(str(tmp_path / "pre")) == 2 * len(KERNELS)
    dst = tmp_path / "pre" / tcc.topology_fingerprint()
    assert seen == [(list(KERNELS), dst)]
    assert _build.build_dir() == before
    assert tcc.bake_prewarm(str(tmp_path / "pre")) == 0
    # the baked artifact seeds an empty cache with every kernel
    cache = tmp_path / "cache"
    monkeypatch.setenv("M2KT_PREWARM_DIR", str(tmp_path / "pre"))
    got = tcc.setup_compilation_cache(str(cache))
    assert all(k.library_path().is_file() for k in KERNELS)
    assert got == str(cache / tcc.topology_fingerprint())

    def failing(kernels):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "build_all", failing)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tcc.bake_prewarm(str(tmp_path / "pre2"))
    assert _build.build_dir() == cache / tcc.topology_fingerprint()


def test_seeded_library_loads_without_nvcc(tmp_path, monkeypatch):
    """A library found in the build directory is not compiled again:
    ``_start_build`` starts no process and ``nvcc_runs`` stays put."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    _build.set_build_dir(tmp_path)
    kern = _build.CudaKernel(KERNELS[0].name, KERNELS[0].symbol, [])
    runs = _build.nvcc_runs
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kern._start_build()  # nothing there: it would build
    kern.library_path().write_bytes(b"")
    kern.library_path().with_suffix(".log").write_text("log")
    assert kern._start_build() is None
    assert kern._finish_build(None) == "log"
    assert _build.nvcc_runs == runs


def test_set_build_dir_returns_the_override():
    base = _build.build_dir()
    prev = _build.set_build_dir("/x/y")
    try:
        assert str(_build.build_dir()) == "/x/y"
        assert _build.set_build_dir(None) == _build.Path("/x/y")
        assert _build.build_dir() == _build.BUILD_DIR
    finally:
        _build.set_build_dir(prev)
    assert _build.build_dir() == base
