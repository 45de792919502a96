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

In a ``torch.distributed`` world of n every rank restores (the directory
is the pod's or a shared volume). Under data parallelism every tensor is
replicated, so rank 0 writes one copy, the whole state. A model of fsdp
shards (:func:`~move2kube_tpu_torch.parallel.sharding.layout_of`) is
saved sharded: the first data and seq rank of each coordinate on the
other axes (fsdp, tensor, expert; file r the r-th coordinate, row-major;
the ranks of a seq group hold copies) writes
``shard-<r>.pt``, its parts of the parameters and of the optimizer's
moments, and rank 0 writes ``state.pt`` with the whole leaves, the
buffers and the rest of the optimizer's state; ``meta.json`` lists the
axes of the files and each leaf's global shape and its cut on each axis,
in global order (a fused projection's cut as its blocks). Every rank
writes into one temporary directory, each shard under a name of its own
that is renamed to ``shard-<r>.pt`` once it is whole, and rank 0's writer
thread commits the step by rename once its own files are written and
every shard is there: the step commits as soon as the last part lands,
with no collective call, so the exit flush commits it as it does a whole
save, and a rank that dies mid-save leaves no step that looks committed.
A restore reads each leaf
at its global shape (the saved shards put together) and keeps the slice
the new world's layout gives this rank, so a checkpoint restores into a
world of any size and between data and fsdp meshes; a step missing a
shard, or with one unreadable, is a damaged step.

The ranks meet at barriers in :meth:`CheckpointManager.wait` (before
each save, after a synchronous one and in ``close``), always on the main
thread: the writer thread makes no collective call, and the exit flush
(:meth:`CheckpointManager.flush`) none either, since a dying rank's peers
may be gone. Rank 0's writer waits for the other ranks' shards at most
the process group's timeout (``M2KT_DIST_TIMEOUT_S``); a shard that does
not come by then fails the save, which leaves no committed step. Whether a step is committed already is read by every rank
between two barriers, so all ranks take the same branch of
:meth:`~CheckpointManager.maybe_save` and meet at the same barriers.

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

from move2kube_tpu_torch.parallel.sharding import Cut, place_cuts
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


def _world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _shard_file(r: int) -> str:
    return f"shard-{r}.pt"


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


def _check_tree(loaded: dict, want) -> None:
    """Raise ValueError naming the arrays ``loaded`` lacks or holds in
    another shape than ``want`` (name -> tensor, or name -> shape)."""
    want = {k: tuple(v.shape) if torch.is_tensor(v) else tuple(v)
            for k, v in want.items()}
    detail = _diff_arrays(want, _shapes(loaded))
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


class _SavedStep:
    """A committed step's arrays at their global shapes: ``model`` (name
    -> tensor; a params-only tree's ``params``), and ``slots(name)``, a
    parameter's optimizer state; each sharded leaf put together from the
    saved shards along its sharded dimension. Every file the step needs is
    read here: a missing or unreadable shard raises."""

    def __init__(self, step_dir: str) -> None:
        self.meta = _read_meta(step_dir)
        self.payload = _load_payload(step_dir)
        self.model = _model_tree(self.payload)
        self._opt: dict = {}
        sharded = self.meta.get("sharded")
        if sharded is None:
            return
        parts = []
        for r in range(int(sharded["extent"])):
            part = torch.load(os.path.join(step_dir, _shard_file(r)),
                              map_location="cpu", weights_only=True,
                              mmap=True)
            if not isinstance(part, dict) or "model" not in part:
                raise ValueError(f"{step_dir}: shard {r} holds no model")
            parts.append(part)
        self.model = dict(self.model)
        # each file's coordinates on the axes of distinct parts (a step
        # written before tensor and expert cuts: fsdp alone)
        axes = sharded.get("axes") or [["fsdp", len(parts)]]
        coords = []
        for index in range(len(parts)):
            c = {}
            for axis, extent in reversed(axes):
                c[axis] = index % extent
                index //= extent
            coords.append(c)
        for name, info in sharded["leaves"].items():
            cuts = (tuple(Cut.from_json(c) for c in info["cuts"])
                    if "cuts" in info else
                    () if info["dim"] is None else
                    (Cut("fsdp", info["dim"], info["extent"],
                         (info["shape"][info["dim"]],)),))
            if not cuts:
                continue
            # one copy of each part: the files whose coordinate is 0 on
            # every axis the leaf is not cut over
            cut_axes = {c.axis for c in cuts}
            mine = [(parts[i], c) for i, c in enumerate(coords)
                    if all(v == 0 for a, v in c.items()
                           if a not in cut_axes)]
            self.model[name] = _assemble(
                info["shape"], cuts, [(p["model"][name], c) for p, c in mine])
            self._opt[name] = {
                slot: _assemble(info["shape"], cuts,
                                [(p["optimizer"][name][slot], c)
                                 for p, c in mine])
                for slot in mine[0][0]["optimizer"].get(name, {})}

    def inner_state(self, names: list, take) -> dict:
        """The torch optimizer's state dict for a model whose parameters
        are ``names`` (the optimizer's order), each parameter-shaped slot
        cut by ``take(name, tensor)``. A step saved without names numbers
        its parameters as ``names`` does."""
        inner = self.payload["optimizer"]["inner"]
        saved = self.payload.get("names") or names
        index = {n: i for i, n in enumerate(names)}
        state = {}
        for i, slots in inner["state"].items():
            name = saved[int(i)]
            slots = dict(slots, **self._opt.get(name, {}))
            shape = tuple(self.model[name].shape)
            state[index[name]] = {
                k: take(name, v) if torch.is_tensor(v) and v.ndim
                and tuple(v.shape) == shape else v
                for k, v in slots.items()}
        return {"state": state, "param_groups": inner["param_groups"]}


def _assemble(shape, cuts, parts):
    """A leaf of global ``shape`` from its ``(part, coordinates)``
    pairs."""
    full = torch.empty(tuple(shape), dtype=parts[0][0].dtype)
    for part, coords in parts:
        place_cuts(full, part, cuts, coords)
    return full


def _global_shapes(model) -> dict:
    """Name -> the global shape of each entry of ``model``'s state dict
    (a sharded parameter's whole shape)."""
    from move2kube_tpu_torch.parallel.sharding import layout_of

    layout = layout_of(model)
    shapes = _shapes(model.state_dict())
    if layout is not None:
        for name in layout.sharded():
            shapes[name] = tuple(layout.specs[name].shape)
    return shapes


def _taker(model):
    """``take(name, global tensor) -> this rank's part``: the layout's
    slice for a sharded model, the tensor itself otherwise."""
    from move2kube_tpu_torch.parallel.sharding import layout_of

    layout = layout_of(model)
    if layout is None:
        return lambda name, t: t
    return lambda name, t: layout.take(name, t)


def _model_tree(payload: dict) -> dict:
    """The model's arrays in a payload: a train state's ``model``, else a
    params-only tree's ``params``."""
    tree = payload.get("model", payload.get("params"))
    if not isinstance(tree, dict):
        raise ValueError("the payload holds neither a train state nor "
                         "params")
    return tree


def _name_bad_arrays(step_dir: str, want) -> str:
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
    want = {k: tuple(v.shape) if torch.is_tensor(v) else tuple(v)
            for k, v in want.items()}
    return _diff_arrays(want, have)


def _save(obj, path: str) -> int:
    # torch.load never checks the archive's CRC-32, so none is computed:
    # it cost more than half of a save's write and caught nothing
    from torch.utils.serialization import config as serialization

    with serialization.patch({"save.compute_crc32": False}):
        torch.save(obj, path)
    return os.path.getsize(path)


def _write_meta(tmp: str, doc: dict) -> None:
    with open(os.path.join(tmp, META_FILE), "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def write_step(ckpt_dir: str, step: int, payload: dict) -> dict:
    """Commit ``payload`` (a dict of host tensors and plain values) as
    ``<ckpt_dir>/<step>/``: written under a temporary name, then renamed.
    Returns the committed save's ``{"step", "seconds", "bytes"}``."""
    t0 = time.perf_counter()
    final = os.path.join(ckpt_dir, str(step))
    tmp = os.path.join(ckpt_dir, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    nbytes = _save(payload, os.path.join(tmp, PAYLOAD_FILE))
    _write_meta(tmp, {"step": step, "format": 1, "bytes": nbytes,
                      "kind": "train_state" if "model" in payload
                      else "tree",
                      "loader": payload.get("loader"),
                      "arrays": _array_index(payload)})
    os.replace(tmp, final)
    return {"step": step, "seconds": time.perf_counter() - t0,
            "bytes": nbytes}


def _sharded_tmp(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f".{step}.tmp-sharded")


def write_sharded_part(ckpt_dir: str, step: int, part: dict,
                       timeout: float = 600.0) -> dict:
    """This rank's part of a sharded save, into the step's temporary
    directory: ``part["shard"]`` as ``shard-<r>.pt`` (written under
    another name, then renamed, so a shard that is there is whole) when
    this rank writes its fsdp coordinate's shards. On rank 0
    ``part["state"]`` as ``state.pt`` and ``part["meta"]`` as
    ``meta.json``; then it waits until every one of the ``extent`` shards
    is there, at most ``timeout`` seconds, and commits the step by
    rename."""
    t0 = time.perf_counter()
    if part.get("shard") is None and part.get("state") is None:
        # a copy of parts other ranks write (data or seq coordinate above
        # 0): it must not touch the step's directory, which rank 0 may be
        # renaming into place at this moment
        return {"step": step, "seconds": 0.0, "bytes": 0}
    tmp = _sharded_tmp(ckpt_dir, step)
    os.makedirs(tmp, exist_ok=True)
    nbytes = 0
    if part.get("shard") is not None:
        path = os.path.join(tmp, _shard_file(part["shard_rank"]))
        nbytes += _save(part["shard"], path + ".part")
        os.replace(path + ".part", path)
    if part.get("state") is not None:
        nbytes += _save(part["state"], os.path.join(tmp, PAYLOAD_FILE))
        _write_meta(tmp, dict(part["meta"], step=step))
        extent = int(part["meta"]["sharded"]["extent"])
        shards = [os.path.join(tmp, _shard_file(r)) for r in range(extent)]
        deadline = time.monotonic() + timeout
        while not all(os.path.exists(f) for f in shards):
            if time.monotonic() > deadline:
                raise TimeoutError(f"step {step}: a shard did not come in "
                                   f"{timeout:.0f} s; not committed")
            time.sleep(0.01)
        os.replace(tmp, os.path.join(ckpt_dir, str(step)))
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


def _param_names(state) -> list:
    """The model's parameter names in the optimizer's order (its state
    dict numbers the parameters in that order)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params()]


def _sharded_part(state, loader, layout) -> dict:
    """This rank's part of a sharded save of ``state`` (module
    docstring): the shards of the parameters and of the optimizer's
    moments where this rank writes its coordinate's, and on rank 0 the
    rest and the metadata."""
    full = _train_state_payload(state, loader)
    names = _param_names(state)
    sharded = set(layout.sharded())
    inner = full["optimizer"]["inner"]
    shard_model = {n: t for n, t in full["model"].items() if n in sharded}
    shard_opt, rest_opt = {}, {}
    for i, slots in inner["state"].items():
        name = names[i]
        if name not in sharded:
            rest_opt[i] = slots
            continue
        shape = shard_model[name].shape
        shard_opt[name] = {k: v for k, v in slots.items()
                           if torch.is_tensor(v) and v.shape == shape}
        rest_opt[i] = {k: v for k, v in slots.items()
                       if k not in shard_opt[name]}
    part = {"shard": None, "state": None,
            "shard_rank": layout.part_index()}
    if layout.first_copy:
        part["shard"] = {"model": shard_model, "optimizer": shard_opt}
    if _rank() == 0:
        state_pt = dict(full, model={n: t for n, t in full["model"].items()
                                     if n not in sharded})
        state_pt["optimizer"] = dict(full["optimizer"], inner={
            "state": rest_opt, "param_groups": inner["param_groups"]})
        state_pt["names"] = names
        leaves = layout.describe()
        arrays = {}
        for n, t in full["model"].items():
            shape = leaves[n]["shape"] if n in leaves else list(t.shape)
            arrays[f"model/{n}"] = {"shape": shape, "dtype": str(t.dtype)}
        part["state"] = state_pt
        axes = layout.part_axes()
        extent = 1
        for _, e in axes:
            extent *= e
        sharded = {"extent": extent, "leaves": leaves}
        if [a for a, _ in axes] != ["fsdp"]:
            # the files' axes, when they are not fsdp's alone
            sharded["axes"] = [list(a) for a in axes]
        part["meta"] = {"format": 2, "kind": "train_state",
                        "loader": full["loader"], "arrays": arrays,
                        "sharded": sharded}
    return part


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
        (full TrainState, then the ported layout, then params only), each
        leaf cut to the model's own layout (a sharded model takes its
        slices). Raises, with ``state`` untouched, when the step is
        unreadable."""
        sdir = os.path.join(self.directory, str(step))
        saved = _SavedStep(sdir)
        meta, payload = saved.meta, saved.payload
        model = state.model
        take = _taker(model)
        want = _global_shapes(model)

        def load_model(tree) -> None:
            model.load_state_dict({n: take(n, tree[n]) for n in want})

        if "model" in payload:
            _check_tree(saved.model, want)
            opt = state.optimizer
            saved_opt = payload["optimizer"]
            try:
                inner = saved.inner_state(_param_names(state), take)
                opt.inner.load_state_dict(inner)
            except (ValueError, KeyError, TypeError, IndexError) as e:
                log.warning("checkpoint step %d: optimizer state does not "
                            "fit (%s); loading its parameters only", step, e)
                load_model(saved.model)
                self.restored = meta
                return state, 0
            load_model(saved.model)
            opt.count = int(saved_opt["count"])
            if saved_opt.get("guard") is not None and opt.guard is not None:
                vars(opt.guard).update(saved_opt["guard"])
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
        _check_tree(params, want)
        load_model(params)
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
        falling back one cadence. A sharded save commits when its last
        part lands (:func:`write_sharded_part`)."""
        if not force and step % self.every:
            return False
        self.wait()
        # every rank reads the directory between two barriers: nothing is
        # written meanwhile, so all take the same branch below
        committed = step in self.all_steps()
        sharded = self._layout(state)
        if sharded is not None and not committed and _rank() == 0:
            shutil.rmtree(_sharded_tmp(self.directory, step),
                          ignore_errors=True)
        _barrier()
        if committed:
            return False
        if sharded is not None:
            self._submit_sharded(step, state, loader, sharded)
        elif _rank() == 0:
            self._submit(step, state, loader)
        if os.environ.get("M2KT_CKPT_SYNC", "0") == "1":
            with _maybe_span("ckpt.save_sync", {"step": step}):
                self.wait()
        return True

    @staticmethod
    def _layout(state):
        """The fsdp layout of a sharded train state in a world above one,
        else None (saved whole by rank 0)."""
        from move2kube_tpu_torch.parallel.sharding import layout_of

        model = getattr(state, "model", None)
        if model is None or _world() == 1:
            return None
        return layout_of(model)

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

    def _submit_sharded(self, step: int, state, loader, layout) -> None:
        """Snapshot this rank's part of a sharded save and start its
        writer (rank 0's commits the step)."""
        with _maybe_span("ckpt.save_submit", {"step": step}):
            t0 = time.perf_counter()
            part = _host_copy(_sharded_part(state, loader, layout),
                              self._pinned)
            if self._pinned:
                torch.cuda.synchronize()
            snapshot_s = time.perf_counter() - t0
            self._thread = threading.Thread(
                target=self._write_part, args=(step, part, snapshot_s),
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

    def _write_part(self, step: int, part: dict, snapshot_s: float) -> None:
        try:
            from move2kube_tpu_torch.parallel.mesh import timeout_seconds

            done = write_sharded_part(self.directory, step, part,
                                      timeout_seconds())
            done["snapshot_seconds"] = snapshot_s
            self.last_save = done
            if part.get("state") is not None:
                self._prune()
                log.info("checkpoint step %d committed (sharded): %d bytes "
                         "in %.3f s", step, done["bytes"], done["seconds"])
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _prune(self) -> None:
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def flush(self) -> None:
        """Block until this process's save in flight is written (a whole
        save committed; of a sharded one this rank's part, and on rank 0
        the step committed once every shard has landed); raise if it
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
        one) until every rank is here, so every rank sees it committed;
        raise if it failed. The last-chance preemption path and the fault
        tests need the step durably on disk before the process may die.
        Main thread only."""
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


def restore_variables(ckpt_dir: str, variables: dict, layout=None) -> dict:
    """Restore model weights for serving: ``variables`` is the model's
    state dict (name -> tensor; the serving entrypoint has no TrainState),
    and the result holds the checkpoint's arrays under the same names, each
    cast to its variable's dtype and device (fp32 masters into a bf16
    model on the card), ready for ``model.load_state_dict``. A sharded
    checkpoint is read whole. With ``layout`` (a :class:`~move2kube_tpu_torch.
    parallel.sharding.ShardLayout`), ``variables`` holds this rank's shards
    and each sharded leaf is read into its slice.

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
    want = _shapes(variables)
    take = lambda name, t: t  # noqa: E731
    if layout is not None:
        want.update({n: tuple(layout.specs[n].shape)
                     for n in layout.sharded()})
        take = layout.take
    for step in steps:
        sdir = os.path.join(ckpt_dir, str(step))
        try:
            tree = _SavedStep(sdir).model
            _check_tree(tree, want)
        except Exception as e:  # noqa: BLE001 - torch.load raises many types
            detail = (_name_bad_arrays(sdir, want)
                      or f"{type(e).__name__}: {e}")
            failures.append((step, detail))
            log.warning("checkpoint step %d unreadable (%s)", step, detail)
            continue
        log.info("serving weights restored from checkpoint step %d", step)
        return {k: take(k, tree[k]).to(device=v.device, dtype=v.dtype)
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
