"""Device mesh and process bootstrap: the port of
``move2kube_tpu/parallel/mesh.py``.

:class:`MeshConfig` keeps the reference's six axes in its order, outer to
inner (``data``, ``fsdp``, ``pipe``, ``tensor``, ``seq``, ``expert``), and
:func:`infer_mesh_config` its choice of extents. :func:`make_mesh` lays a
config (or a :class:`~move2kube_tpu_torch.parallel.topology.MeshPlan`)
over the world as a ``torch.distributed.device_mesh.DeviceMesh`` named by
those axes; size-1 axes stay, as in the reference.

How a pod maps onto ranks. JAX runs one process a host and that process
drives every chip of the host; PyTorch runs one process a card. The pod
keeps the JAX trainer's contract on the outside (one container process,
``resilience/supervisor.py`` as its parent, the JobSet's env as the source
of host identity); inside, that process starts one rank a visible card,
or a rank a forced device on the CPU (``M2KT_FORCE_DEVICES``), with
:func:`launch_local_ranks`, and exits with their code. The layout
(:func:`process_layout`):

- hosts = ``M2KT_NUM_HOSTS`` x ``M2KT_NUM_SLICES``, the host index
  ``M2KT_SLICE_ID`` x ``M2KT_NUM_HOSTS`` + ``JOB_COMPLETION_INDEX`` (or
  ``M2KT_HOST_INDEX``), as the reference's ``initialize_distributed``
  reads them;
- world = hosts x local ranks, rank = host index x local ranks + local
  rank (``M2KT_LOCAL_RANK``/``M2KT_LOCAL_WORLD``, which the launcher
  sets);
- ``torchrun``'s ``WORLD_SIZE``/``RANK``/``LOCAL_RANK``/
  ``LOCAL_WORLD_SIZE`` win when set;
- ``M2KT_FORCE_DEVICES`` (CPU ranks, the reference's forced host
  devices) models the whole world in one pod: one host, whatever
  ``M2KT_NUM_SLICES`` says to the planner.

:func:`initialize_distributed` starts the process group of that layout
(NCCL for the card, gloo for the CPU; a world of one too, so every path
runs in a group) with an explicit timeout (``M2KT_DIST_TIMEOUT_S``,
default 600 s), and refuses at once a world above one that names no
rendezvous (``M2KT_COORDINATOR`` host:port, or ``MASTER_ADDR`` and
``MASTER_PORT``; the ranks of a one-host pod meet at the store its
launcher hosts), where ``init_process_group`` would wait for absent
peers for 30 minutes.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

DEFAULT_TIMEOUT_S = 600.0


@dataclass
class MeshConfig:
    data: int = 1
    fsdp: int = 1
    pipe: int = 1    # pipeline stages (ROADMAP Queue 1 item 9e)
    tensor: int = 1
    seq: int = 1
    expert: int = 1  # MoE expert parallelism (item 9c)

    # outer -> inner: data-parallel axes first, the model axes innermost
    AXES = ("data", "fsdp", "pipe", "tensor", "seq", "expert")

    def total(self) -> int:
        n = 1
        for d in self.dims():
            n *= d
        return n

    def dims(self) -> tuple[int, ...]:
        return (self.data, self.fsdp, self.pipe, self.tensor, self.seq,
                self.expert)


def infer_mesh_config(n_devices: int, *, zero_stage: int = 0,
                      tensor_parallel: int = 1, seq_parallel: int = 1,
                      pipeline_parallel: int = 1,
                      expert_parallel: int = 1) -> MeshConfig:
    """Mesh dims for a device count and the detected GPU parallelism:
    tensor/seq/expert claim their factors first, pipeline next, the rest
    is data (fsdp under ZeRO >= 2); degrees that do not divide the device
    count are dropped."""
    tensor = max(1, tensor_parallel)
    seq = max(1, seq_parallel)
    expert = max(1, expert_parallel)
    pipe = max(1, pipeline_parallel)
    if n_devices % (tensor * seq * expert):
        tensor = seq = expert = 1
    inner = tensor * seq * expert
    if (n_devices // inner) % pipe:
        pipe = 1
    rest = n_devices // (inner * pipe)
    if zero_stage >= 2:
        return MeshConfig(data=1, fsdp=rest, pipe=pipe, tensor=tensor,
                          seq=seq, expert=expert)
    return MeshConfig(data=rest, fsdp=1, pipe=pipe, tensor=tensor, seq=seq,
                      expert=expert)


# the ROADMAP slice that brings each model axis the port does not run yet
# (Queue 1 item 9; data, fsdp, tensor, seq and expert run)
SLICE_OF_AXIS = {"pipe": "9e (pipelines)"}


def unported_axes(config: MeshConfig) -> list[str]:
    """The axes of ``config`` above 1 that the port does not run yet."""
    return [a for a in MeshConfig.AXES
            if a in SLICE_OF_AXIS and getattr(config, a) > 1]


def check_ported_mesh(config: MeshConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP slice of each axis
    of ``config`` the port does not run yet (data, fsdp, tensor, seq and
    expert run)."""
    axes = unported_axes(config)
    if axes:
        raise NotImplementedError(
            "mesh " + "x".join(str(d) for d in config.dims()) + " needs "
            + ", ".join(f"{a}={getattr(config, a)}: ROADMAP Queue 1 item "
                        f"{SLICE_OF_AXIS[a]}" for a in axes))


@dataclass(frozen=True)
class ProcessLayout:
    """Where this process sits: ``rank`` of ``world``, local rank
    ``local_rank`` of the ``local_world`` ranks of host ``host`` of
    ``hosts``."""
    world: int = 1
    rank: int = 0
    local_world: int = 1
    local_rank: int = 0
    hosts: int = 1
    host: int = 0


def _int(env, name: str, default: int) -> int:
    try:
        return int(env.get(name, "") or default)
    except ValueError:
        return default


def process_layout(env=None) -> ProcessLayout:
    """The layout the env describes (see the module docstring)."""
    env = os.environ if env is None else env
    if "WORLD_SIZE" in env and "RANK" in env:
        world, rank = _int(env, "WORLD_SIZE", 1), _int(env, "RANK", 0)
        local_world = _int(env, "LOCAL_WORLD_SIZE", 1)
        local_rank = _int(env, "LOCAL_RANK", rank % local_world)
        return ProcessLayout(world, rank, local_world, local_rank,
                             max(1, world // local_world),
                             rank // local_world)
    if env.get("M2KT_FORCE_DEVICES", "").isdigit():
        # forced CPU ranks model the whole world in one pod
        num_hosts = slices = 1
    else:
        num_hosts = max(1, _int(env, "M2KT_NUM_HOSTS", 1))
        slices = max(1, _int(env, "M2KT_NUM_SLICES", 1))
    index = _int(env, "JOB_COMPLETION_INDEX",
                 _int(env, "M2KT_HOST_INDEX", 0))
    host = _int(env, "M2KT_SLICE_ID", 0) * num_hosts + index
    local_world = max(1, _int(env, "M2KT_LOCAL_WORLD", 1))
    local_rank = _int(env, "M2KT_LOCAL_RANK", 0)
    hosts = num_hosts * slices
    return ProcessLayout(hosts * local_world, host * local_world + local_rank,
                         local_world, local_rank, hosts, host)


def current_layout() -> ProcessLayout:
    """The layout of the running process group (a world of one when none
    is up): rank and world from ``torch.distributed``, the host count from
    the env; the ranks of a host are consecutive."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return ProcessLayout()
    world, rank = dist.get_world_size(), dist.get_rank()
    hosts = process_layout().hosts
    if hosts < 1 or world % hosts:
        hosts = world
    local_world = world // hosts
    return ProcessLayout(world, rank, local_world, rank % local_world, hosts,
                         rank // local_world)


def batch_layout(layout: ProcessLayout, config: MeshConfig
                 ) -> ProcessLayout:
    """The layout of the batch's ranks: the reference shards the batch
    over ``(data, fsdp)`` only, so the ranks of one batch coordinate (the
    inner pipe, tensor, seq and expert axes, consecutive ranks) take the
    same rows. Raises where a host's ranks do not hold whole groups of
    them (every rank of a group must read its host's shard)."""
    inner = config.pipe * config.tensor * config.seq * config.expert
    if inner == 1:
        return layout
    if layout.local_world % inner:
        raise ValueError(
            f"{layout.local_world} ranks a host do not hold whole groups "
            f"of the {inner} ranks of one batch coordinate")
    return ProcessLayout(layout.world // inner, layout.rank // inner,
                         layout.local_world // inner,
                         layout.local_rank // inner, layout.hosts,
                         layout.host)


def rendezvous(env=None) -> str | None:
    """Where the env says the ranks meet, as a ``tcp://`` address, or
    None: ``M2KT_COORDINATOR`` (rank 0 hosts the store there), else
    ``MASTER_ADDR`` and ``MASTER_PORT``, else ``M2KT_LOCAL_STORE`` (the
    store :func:`launch_local_ranks` hosts for one pod's ranks)."""
    env = os.environ if env is None else env
    coordinator = env.get("M2KT_COORDINATOR", "")
    if coordinator:
        return f"tcp://{coordinator}"
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        return f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if env.get("M2KT_LOCAL_STORE"):
        return f"tcp://{env['M2KT_LOCAL_STORE']}"
    return None


def check_rendezvous(layout: ProcessLayout, env=None) -> None:
    """Raise ``ValueError`` at once for a world above one that names no
    rendezvous (the JAX trainer fails to start such a world too)."""
    if layout.world > 1 and rendezvous(env) is None:
        raise ValueError(
            f"a world of {layout.world} processes ({layout.hosts} hosts x "
            f"{layout.local_world} local ranks) names no rendezvous: set "
            "M2KT_COORDINATOR (host:port) or MASTER_ADDR and MASTER_PORT")


def timeout_seconds(env=None) -> float:
    env = os.environ if env is None else env
    try:
        return float(env.get("M2KT_DIST_TIMEOUT_S", "") or DEFAULT_TIMEOUT_S)
    except ValueError:
        return DEFAULT_TIMEOUT_S


def initialize_distributed(device=None, backend: str | None = None,
                           env=None) -> ProcessLayout:
    """Start the process group of :func:`process_layout` and return the
    layout. ``device``: the rank's device (a card selects NCCL and is made
    the current device; the CPU selects gloo); ``backend`` overrides the
    choice (gloo for ranks that share one card). Does nothing but return
    the layout when a group is already up."""
    import datetime

    import torch
    import torch.distributed as dist

    env = os.environ if env is None else env
    layout = process_layout(env)
    if dist.is_initialized():
        return current_layout()
    check_rendezvous(layout, env)
    dev = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, layout))
    timeout = datetime.timedelta(seconds=timeout_seconds(env))
    init = rendezvous(env)
    if layout.world == 1:
        store = dist.HashStore()
    elif init.startswith("tcp://") and init[6:] == env.get(
            "M2KT_LOCAL_STORE"):
        # the launcher holds the store's port: every rank is a client
        host, port = init[6:].rsplit(":", 1)
        store = dist.TCPStore(host, int(port), layout.world,
                              is_master=False, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init, rank=layout.rank,
                                world_size=layout.world, timeout=timeout)
        return layout
    dist.init_process_group(backend, store=store, rank=layout.rank,
                            world_size=layout.world, timeout=timeout)
    return layout


def make_mesh(config=None, device=None):
    """A ``DeviceMesh`` over the running world with the axes of
    :attr:`MeshConfig.AXES`, on the card unless ``device`` is the CPU.
    ``config`` is a :class:`MeshConfig` or a ``MeshPlan`` (its config; the
    port's plans keep the identity order), default all data."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from move2kube_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    config = getattr(config, "config", config)
    world = dist.get_world_size()
    config = config or MeshConfig(data=world)
    if config.total() != world:
        raise ValueError(f"mesh {config.dims()} needs {config.total()} "
                         f"devices, have {world}")
    return init_device_mesh(dev.type, config.dims(),
                            mesh_dim_names=MeshConfig.AXES)


def mesh_config_of(mesh) -> MeshConfig:
    """The extents of a ``DeviceMesh`` made by :func:`make_mesh`."""
    return MeshConfig(**{a: mesh.size(i)
                         for i, a in enumerate(MeshConfig.AXES)})


def local_device_count(device, env=None) -> int:
    """Ranks this pod starts: ``M2KT_FORCE_DEVICES`` on the CPU (the
    reference's forced host devices), the visible cards on a card."""
    import torch

    env = os.environ if env is None else env
    raw = env.get("M2KT_FORCE_DEVICES", "")
    if torch.device(device).type == "cuda":
        if raw:
            raise ValueError("M2KT_FORCE_DEVICES starts CPU ranks; set "
                             "M2KT_DEVICE=cpu with it")
        return max(1, torch.cuda.device_count())
    return int(raw) if raw.isdigit() and int(raw) > 0 else 1


def is_rank_process(env=None) -> bool:
    """True in a process that is itself a rank (started by
    :func:`launch_local_ranks` or ``torchrun``)."""
    env = os.environ if env is None else env
    return "M2KT_LOCAL_RANK" in env or "LOCAL_RANK" in env


def rank_device(device, layout: ProcessLayout):
    """A rank's device: a card with an index (``device``'s own, else card
    ``local_rank`` of those visible), or the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda",
                            layout.local_rank % torch.cuda.device_count())
    return dev


def launch_local_ranks(cmd: list[str], n: int, env=None,
                       grace_s: float = 10.0) -> int:
    """Run ``cmd`` as ``n`` local ranks (``M2KT_LOCAL_RANK`` 0..n-1 of
    ``M2KT_LOCAL_WORLD`` n) and return their common exit code.

    A pod of one host with no rendezvous gets a store that this process
    hosts on a port it holds until the ranks are done
    (``M2KT_LOCAL_STORE``), so no other process can take the port
    between its choice and the ranks' start.
    Unless the env sets ``OMP_NUM_THREADS``, each rank gets its share of
    the host's cores. SIGTERM and SIGINT are passed on to every rank (the preemption
    watcher's path). When a rank exits non-zero, the others have
    ``grace_s`` to exit on their own (a rank that loses a peer dies of it
    in its next collective, often before the peer that failed has
    finished dying); the ranks still running are then sent SIGTERM, and
    SIGKILL after ``grace_s`` more. The code of the ranks that exited on
    their own decides, the first that is not 1 before a 1: 1 is the
    uncaught error a rank that lost its peer dies of, and the code that
    tells why (83 for a lost slice, a signal) may come a moment after it.
    A rank killed by a signal is mirrored by this process dying of it."""
    base = dict(os.environ if env is None else env)
    base["M2KT_LOCAL_WORLD"] = str(n)
    # the ranks share the pod's cores, as torchrun shares them
    base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1)
                                               // n)))
    layout = process_layout(base)
    store = None  # held, with its port, until the ranks are done
    if layout.hosts == 1 and rendezvous(base) is None:
        import datetime

        import torch.distributed as dist

        store = dist.TCPStore("127.0.0.1", 0, n, is_master=True,
                              wait_for_workers=False,
                              timeout=datetime.timedelta(
                                  seconds=timeout_seconds(base)))
        base["M2KT_LOCAL_STORE"] = f"127.0.0.1:{store.port}"
    check_rendezvous(layout, base)
    procs = [subprocess.Popen(cmd, env=dict(base, M2KT_LOCAL_RANK=str(r)))
             for r in range(n)]
    # (exit time, code) of each rank in the order they exit: a rank that
    # dies takes its peers down with it a moment later (their next
    # collective fails), and the first death is the one that tells why
    exits: list[tuple[float, int]] = []
    lock = threading.Lock()
    changed = threading.Event()

    def _reap(p):
        rc = p.wait()
        with lock:
            exits.append((time.monotonic(), rc))
        changed.set()

    waiters = [threading.Thread(target=_reap, args=(p,), daemon=True)
               for p in procs]
    for t in waiters:
        t.start()

    def _forward(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {s: signal.signal(s, _forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
    code = 0
    try:
        while True:
            changed.wait(0.5)
            changed.clear()
            with lock:
                bad = [rc for _, rc in sorted(exits) if rc != 0]
                finished = len(exits) == n
            if bad or finished:
                break
        if bad:
            # the other ranks' own exits, for a moment
            settle = time.monotonic() + grace_s
            while time.monotonic() < settle:
                with lock:
                    if len(exits) == n:
                        break
                changed.wait(0.1)
                changed.clear()
            with lock:
                bad = [rc for _, rc in sorted(exits) if rc != 0]
            code = next((rc for rc in bad if rc != 1), bad[0])
            deadline = time.monotonic() + grace_s
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for t, p in zip(waiters, procs):
                t.join(timeout=max(0.1, deadline - time.monotonic()))
                if t.is_alive():
                    p.kill()
                    t.join()
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
    if code < 0:
        sys.stdout.flush()
        if -code not in (signal.SIGKILL, signal.SIGSTOP):  # not catchable
            signal.signal(-code, signal.SIG_DFL)
        os.kill(os.getpid(), -code)
    return code
