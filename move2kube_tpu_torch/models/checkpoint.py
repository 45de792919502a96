"""Training checkpoint/resume: the port's counterpart of
``move2kube_tpu/models/checkpoint.py``, with ``torch.save`` in place of
orbax and the same three calls for the training loop
(``restore_or_init``, ``maybe_save``, ``close``), the same corrupt-latest
fallback and the same ``restore_variables`` error contract.

Layout: one directory per committed save, ``<dir>/<step>/``, holding

- ``state.pt``: ``torch.save`` of the payload. For a :class:`TrainState`
  that is ``{"model": state dict, "optimizer": {"inner": the torch
  optimizer's state dict, "count": updates applied, "guard": the finite
  guard's counters or None}, "step": steps taken, "loader": batches the
  data stream handed out}``; a plain dict (a params-only tree,
  ``{"params": state dict}``) is saved as it is;
- ``meta.json``: the step, the payload's kind, its bytes, the loader
  cursor and every array's name, shape and dtype (read without touching
  the payload, to name the arrays a damaged step lacks).

``state.pt`` is written without the zip members' CRC-32: ``torch.load``
does not check it, so a flipped byte in an array loads as it is (with
the CRC or without); damage that ``torch.load`` cannot parse (a
truncated or overwritten archive, a missing file) is what the fallback
sees.

A save is written under a temporary name (``.<step>.tmp-<pid>``) and
renamed into place, so a save killed mid-write never looks committed
(:func:`~move2kube_tpu_torch.resilience.faults.step_dirs` lists only
all-digit names). Nothing is fsync'ed: a committed step survives the
process's death, not the host's. ``maybe_save`` snapshots the state to
host memory before it returns (the training loop updates the state in
place) and writes the file on a background thread unless
``M2KT_CKPT_SYNC=1``. The snapshot of a state on the card goes into
pinned host buffers that the manager keeps and reuses from save to save
(one host copy of the state). :meth:`CheckpointManager.wait` and
:meth:`CheckpointManager.install_exit_flush` make sure an interpreter
teardown never loses the newest save. ``max_to_keep`` committed steps are
kept. Restores load onto the devices of the state (or variables) they are
given.

In a ``torch.distributed`` world of n, rank 0 writes and every rank
restores (the directory is the pod's or a shared volume): under data
parallelism every tensor is replicated, so one copy is the whole state,
and a checkpoint restores into a world of any size. The other ranks meet
rank 0 at a barrier in :meth:`CheckpointManager.wait` (before each save,
after a synchronous one and in ``close``), always on the main thread: the
writer thread makes no collective call, and the exit flush
(:meth:`CheckpointManager.flush`) none either, since a dying rank's peers
may be gone. The sharded save of sharded parameters comes with FSDP
(ROADMAP Queue 1 item 9b).

The emitted trainer calls ``restore_or_init`` at startup and
``maybe_save`` every ``M2KT_CKPT_EVERY`` steps, pointed at
``M2KT_CKPT_DIR`` (:func:`from_env`).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import threading
import time

import torch

from move2kube_tpu_torch.resilience.faults import (
    META_FILE,
    PAYLOAD_FILE,
    step_dirs,
)

log = logging.getLogger("m2kt.checkpoint")


def _maybe_span(name: str, attrs: dict | None = None):
    """Span into the runtime trace ring when tracing is on; a no-op
    context otherwise. The save and wait phases are what the crash flight
    recorder needs to show whether a death raced a checkpoint commit."""
    from move2kube_tpu_torch.obs import tracing

    if tracing.enabled():
        return tracing.get().span(name, attrs)
    return contextlib.nullcontext()


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _host_copy(obj, pinned: dict, path: str = ""):
    """A copy of ``obj`` whose tensors are detached CPU tensors of their
    own, so the training loop may update the state while the copy is
    written: a CUDA tensor is copied (asynchronously; the caller
    synchronizes) into the pinned host buffer ``pinned`` keeps for its
    path, allocated at the first save and reused by later ones; a CPU
    tensor is cloned."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if not t.is_cuda:
            return t.clone()
        buf = pinned.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = pinned[path] = torch.empty(t.shape, dtype=t.dtype,
                                             pin_memory=True)
        return buf.copy_(t, non_blocking=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v, pinned, f"{path}/{k}")
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, pinned, f"{path}/{i}")
                         for i, v in enumerate(obj))
    return obj


def _flatten_paths(tree, prefix: str = "") -> dict:
    """``{"model/layers.0.attn.wq.weight": leaf}`` for a nested dict:
    the path naming the bad-array diagnostics below use."""
    out = {}
    if isinstance(tree, dict):
        for key, child in tree.items():
            out.update(_flatten_paths(
                child, f"{prefix}/{key}" if prefix else str(key)))
    else:
        out[prefix] = tree
    return out


def _array_index(tree: dict) -> dict:
    return {path: {"shape": list(t.shape), "dtype": str(t.dtype)}
            for path, t in _flatten_paths(tree).items()
            if isinstance(t, torch.Tensor)}


def _diff_arrays(want: dict, have: dict) -> str:
    """Name what ``have`` (path -> shape) lacks of ``want`` (path ->
    shape): missing arrays first, then mismatched shapes; empty string
    when they agree."""
    missing = sorted(set(want) - set(have))
    if missing:
        return (f"missing array(s) {missing[:3]}"
                + (f" (+{len(missing) - 3} more)" if len(missing) > 3
                   else ""))
    mismatched = sorted(p for p in want
                        if tuple(have[p]) != tuple(want[p]))
    if mismatched:
        return (f"shape-mismatched array(s) {mismatched[:3]}"
                + (f" (+{len(mismatched) - 3} more)"
                   if len(mismatched) > 3 else ""))
    return ""


def _shapes(tree: dict) -> dict:
    return {k: tuple(v.shape) for k, v in tree.items()}


def _check_tree(loaded: dict, want: dict) -> None:
    """Raise ValueError naming the arrays ``loaded`` lacks or holds in
    another shape than ``want`` (both name -> tensor)."""
    detail = _diff_arrays(_shapes(want), _shapes(loaded))
    if detail:
        raise ValueError(detail)


def _read_meta(step_dir: str) -> dict:
    with open(os.path.join(step_dir, META_FILE), encoding="utf-8") as f:
        return json.load(f)


def _load_payload(step_dir: str) -> dict:
    # memory-mapped: a reader that wants only the model's arrays (the
    # server) never reads the optimizer's
    payload = torch.load(os.path.join(step_dir, PAYLOAD_FILE),
                         map_location="cpu", weights_only=True, mmap=True)
    if not isinstance(payload, dict):
        raise ValueError(f"{step_dir}: payload is {type(payload).__name__},"
                         " not a dict")
    return payload


def _model_tree(payload: dict) -> dict:
    """The model's arrays in a payload: a train state's ``model``, else a
    params-only tree's ``params``."""
    tree = payload.get("model", payload.get("params"))
    if not isinstance(tree, dict):
        raise ValueError("the payload holds neither a train state nor "
                         "params")
    return tree


def _name_bad_arrays(step_dir: str, want: dict) -> str:
    """Best-effort: which array(s) made this step unrestorable? The step's
    ``meta.json`` (cheap: no array reads) is diffed against the tree the
    caller wants: a partial write is missing arrays, a foreign checkpoint
    mismatches shapes. Empty string when the metadata itself is
    unreadable or agrees; the caller then reports the raw error."""
    try:
        index = _read_meta(step_dir)["arrays"]
        have = {}
        for path, spec in index.items():
            top, _, name = path.partition("/")
            if top in ("model", "params"):
                have[name] = tuple(spec["shape"])
    except Exception:  # noqa: BLE001 - metadata as damaged as the data
        return ""
    return _diff_arrays(_shapes(want), have)


def write_step(ckpt_dir: str, step: int, payload: dict) -> dict:
    """Commit ``payload`` (a dict of host tensors and plain values) as
    ``<ckpt_dir>/<step>/``: written under a temporary name, then renamed.
    Returns the committed save's ``{"step", "seconds", "bytes"}``."""
    t0 = time.perf_counter()
    final = os.path.join(ckpt_dir, str(step))
    tmp = os.path.join(ckpt_dir, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    path = os.path.join(tmp, PAYLOAD_FILE)
    # torch.load never checks the archive's CRC-32, so none is computed:
    # it cost more than half of a save's write and caught nothing
    from torch.utils.serialization import config as serialization

    with serialization.patch({"save.compute_crc32": False}):
        torch.save(payload, path)
    nbytes = os.path.getsize(path)
    doc = {"step": step, "format": 1, "bytes": nbytes,
           "kind": "train_state" if "model" in payload else "tree",
           "loader": payload.get("loader"),
           "arrays": _array_index(payload)}
    with open(os.path.join(tmp, META_FILE), "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, final)
    return {"step": step, "seconds": time.perf_counter() - t0,
            "bytes": nbytes}


def _train_state_payload(state, loader) -> dict:
    opt = state.optimizer
    guard = getattr(opt, "guard", None)
    position = getattr(loader, "position", None)
    return {
        "model": state.model.state_dict(),
        "optimizer": {
            "inner": opt.inner.state_dict(),
            "count": opt.count,
            "guard": dict(vars(guard)) if guard is not None else None,
        },
        "step": state.step,
        "loader": position() if position is not None else None,
    }


class CheckpointManager:
    """One checkpoint directory: ``restore_or_init``, ``maybe_save``,
    ``wait``, ``close``.

    ``last_save`` is the newest committed save's ``{"step", "seconds",
    "bytes", "snapshot_seconds"}`` (``seconds`` the file write,
    ``snapshot_seconds`` the copy to host memory); ``restored`` is the
    ``meta.json`` of the step ``restore_or_init`` took (None until then),
    whose ``loader`` is the data stream's cursor at that save."""

    def __init__(self, ckpt_dir: str, every: int = 100, max_to_keep: int = 3):
        self.directory = os.path.abspath(ckpt_dir)
        self.every = max(1, every)
        self.max_to_keep = max(1, max_to_keep)
        self.last_save: dict | None = None
        self.restored: dict | None = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # pinned host buffers of the last snapshot, by path: reused by the
        # next save once the write of this one has finished
        self._pinned: dict[str, torch.Tensor] = {}
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return [s for s, _ in step_dirs(self.directory)]

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore ------------------------------------------------------------

    def restore_or_init(self, state, ported_restore=None):
        """Return (state, start_step): the newest *readable* checkpoint
        loaded into ``state`` (in place, onto its devices), or ``state``
        untouched at step 0.

        Two checkpoint shapes are accepted: a full TrainState (periodic
        saves from the training loop), and a params-only tree
        (``{"params": state dict}``, weights converted elsewhere), which
        is loaded into the model while the fresh optimizer state is kept,
        from step 0. A TrainState checkpoint whose optimizer state does
        not fit ``state``'s optimizer is taken the same way.

        Corrupt-latest fallback: a preempted or failed host can leave the
        newest step truncated or partially written. An unreadable step
        falls back to the previous retained step; when *no* retained step
        restores, training restarts from step 0 with a loud error:
        forward progress with bounded loss beats a crashloop. Every step
        is read and checked whole before anything is loaded, so a
        damaged step leaves ``state`` as it was.

        ``ported_restore``: optional ``(params, graft_fn)`` for states
        whose parameter layout differs from the flat one (the pipeline
        trainers of Queue 1 item 9): a params-only tree is checked against
        ``params`` (name -> tensor) and ``graft_fn(state, params)``
        returns the state that holds it."""
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return state, 0
        for i, step in enumerate(steps):
            try:
                return self._restore_at(step, state, ported_restore)
            except Exception as e:  # noqa: BLE001 - torch.load raises many types
                log.warning(
                    "checkpoint step %d unreadable (%s: %s); %s", step,
                    type(e).__name__, e,
                    "falling back to previous retained step"
                    if i + 1 < len(steps) else "no retained steps left")
        log.error(
            "no retained checkpoint under %r is restorable; starting from "
            "step 0 (corrupt artifacts left in place for inspection)",
            self.directory)
        return state, 0

    def _restore_at(self, step: int, state, ported_restore=None):
        """Load one step into ``state``, negotiating the checkpoint shape
        (full TrainState, then the ported layout, then params only).
        Raises, with ``state`` untouched, when the step is unreadable."""
        sdir = os.path.join(self.directory, str(step))
        meta = _read_meta(sdir)
        payload = _load_payload(sdir)
        model = state.model
        if "model" in payload:
            _check_tree(payload["model"], model.state_dict())
            opt = state.optimizer
            saved = payload["optimizer"]
            try:
                opt.inner.load_state_dict(saved["inner"])
            except (ValueError, KeyError, TypeError) as e:
                log.warning("checkpoint step %d: optimizer state does not "
                            "fit (%s); loading its parameters only", step, e)
                model.load_state_dict(payload["model"])
                self.restored = meta
                return state, 0
            model.load_state_dict(payload["model"])
            opt.count = int(saved["count"])
            if saved.get("guard") is not None and opt.guard is not None:
                vars(opt.guard).update(saved["guard"])
            state.step = int(payload["step"])
            self.restored = meta
            log.info("resumed from checkpoint step %d", step)
            return state, step
        params = payload.get("params")
        if not isinstance(params, dict):
            raise ValueError(f"step {step} holds neither a train state nor "
                             "params")
        if ported_restore is not None:
            want, graft_fn = ported_restore
            _check_tree(params, want)
            self.restored = meta
            log.info("grafted ported weights from checkpoint step %d", step)
            return graft_fn(state, params), 0
        _check_tree(params, model.state_dict())
        model.load_state_dict(params)
        self.restored = meta
        log.info("loaded ported weights from checkpoint step %d", step)
        return state, 0

    # -- save ---------------------------------------------------------------

    def maybe_save(self, step: int, state, force: bool = False,
                   loader=None) -> bool:
        """Save when ``step`` hits the cadence (or ``force``); returns
        whether a save was started. ``state`` is a ``TrainState`` or a
        plain dict of tensors; ``loader`` (anything with ``position()``)
        records the data stream's cursor. A step already committed is not
        saved again.

        The state is copied to host memory before this returns; the file
        is written on a background thread, one save at a time.
        ``M2KT_CKPT_SYNC=1`` blocks until the save commits: every step the
        goodput ledger reports as saved is then durable (fault drills);
        the default can lose the save in flight to an abrupt death,
        falling back one cadence."""
        if not force and step % self.every:
            return False
        self.wait()
        if step in self.all_steps():
            return False
        if _rank() == 0:
            self._submit(step, state, loader)
        if os.environ.get("M2KT_CKPT_SYNC", "0") == "1":
            with _maybe_span("ckpt.save_sync", {"step": step}):
                self.wait()
        return True

    def _submit(self, step: int, state, loader) -> None:
        """Snapshot ``state`` to host memory and start the writer."""
        with _maybe_span("ckpt.save_submit", {"step": step}):
            t0 = time.perf_counter()
            payload = (dict(state) if isinstance(state, dict)
                       else _train_state_payload(state, loader))
            payload = _host_copy(payload, self._pinned)
            if self._pinned:
                torch.cuda.synchronize()
            snapshot_s = time.perf_counter() - t0
            self._thread = threading.Thread(
                target=self._write, args=(step, payload, snapshot_s),
                name=f"m2kt-ckpt-{step}", daemon=True)
            self._thread.start()

    def _write(self, step: int, payload: dict, snapshot_s: float) -> None:
        try:
            done = write_step(self.directory, step, payload)
            done["snapshot_seconds"] = snapshot_s
            self.last_save = done
            self._prune()
            log.info("checkpoint step %d committed: %d bytes in %.3f s",
                     step, done["bytes"], done["seconds"])
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _prune(self) -> None:
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def flush(self) -> None:
        """Block until this process's save in flight commits; raise if it
        failed. No collective call."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"checkpoint save failed: {err}") from err

    def wait(self) -> None:
        """Block until the save in flight commits, then (in a world above
        one) until every rank is here; raise if it failed. The
        last-chance preemption path and the fault tests need the step
        durably on disk before the process may die. Main thread only."""
        with _maybe_span("ckpt.wait"):
            self.flush()
            _barrier()

    def install_exit_flush(self) -> None:
        """Make every interpreter exit path that runs teardown (``sys.exit``
        from an injected fault or a slice-loss death, exit code 83) wait
        for the save in flight, which the daemon writer thread would
        otherwise lose. Best-effort by design: the process is dying, so a
        failed flush must not mask the original exit code. (SIGKILL skips
        teardown; that loss is priced into the goodput ledger's ``lost``.)

        Registered through ``threading._register_atexit``, whose hooks run
        before the interpreter joins its threads, with ``atexit`` as the
        fallback where it is missing."""

        def _flush() -> None:
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - dying process, best effort
                pass

        register = getattr(threading, "_register_atexit", None)
        if register is None:
            import atexit

            atexit.register(_flush)
        else:
            register(_flush)

    def close(self) -> None:
        """Block until the save in flight lands."""
        self.wait()


def restore_variables(ckpt_dir: str, variables: dict) -> dict:
    """Restore model weights for serving: ``variables`` is the model's
    state dict (name -> tensor; the serving entrypoint has no TrainState),
    and the result holds the checkpoint's arrays under the same names, each
    cast to its variable's dtype and device (fp32 masters into a bf16
    model on the card), ready for ``model.load_state_dict``.

    Accepts the same checkpoint shapes the trainer writes: a full
    TrainState (its model) or a params-only tree. Same corrupt-latest
    fallback as ``restore_or_init``. An *empty* or absent checkpoint
    directory returns ``variables`` unchanged (first boot); but a
    directory that HAS retained steps none of which restore is a corrupted
    store, and serving randomly initialized weights behind a healthy
    /readyz would be silent garbage: that case raises a clean
    ``ValueError`` naming the newest damaged step and its bad arrays."""
    try:
        os.listdir(ckpt_dir)
    except FileNotFoundError:
        return variables  # first boot
    except OSError as err:
        raise ValueError(
            f"checkpoint dir {ckpt_dir!r} is unreadable: "
            f"{type(err).__name__}: {err}") from err
    steps = sorted((s for s, _ in step_dirs(ckpt_dir)), reverse=True)
    failures: list[tuple[int, str]] = []
    for step in steps:
        sdir = os.path.join(ckpt_dir, str(step))
        try:
            tree = _model_tree(_load_payload(sdir))
            _check_tree(tree, variables)
        except Exception as e:  # noqa: BLE001 - torch.load raises many types
            detail = (_name_bad_arrays(sdir, variables)
                      or f"{type(e).__name__}: {e}")
            failures.append((step, detail))
            log.warning("checkpoint step %d unreadable (%s)", step, detail)
            continue
        log.info("serving weights restored from checkpoint step %d", step)
        return {k: tree[k].to(device=v.device, dtype=v.dtype)
                for k, v in variables.items()}
    if steps:
        step, detail = failures[0]
        raise ValueError(
            f"no retained checkpoint under {ckpt_dir!r} is restorable; "
            f"newest step {step}: {detail}")
    return variables


def from_env(default_every: int = 100) -> CheckpointManager | None:
    """Build a manager from the env the apiresources inject
    (M2KT_CKPT_DIR / M2KT_CKPT_EVERY); None when checkpointing is off."""
    ckpt_dir = os.environ.get("M2KT_CKPT_DIR", "")
    if not ckpt_dir:
        return None
    every = int(os.environ.get("M2KT_CKPT_EVERY", str(default_every)))
    return CheckpointManager(ckpt_dir, every=every)
