"""A 1-D device mesh over ``torch.distributed`` ranks (port of the 1-D part
of ``repro.launch.mesh``).

The reference is single-controller: one process holds a ``jax`` mesh and
``shard_map`` runs the body on every device.  PyTorch is
multi-controller: a mesh of κ ranks is a process group, and every rank
runs the same program on its own shard.  ``Mesh`` names the axis and
carries this rank's index, its device and the group, and offers the two
collectives the distributed engine and the pod path need, on device
tensors:

  * ``psum(x)``       -- ``all_reduce`` with SUM (``lax.psum``);
  * ``all_gather(x)`` -- a stacked ``(κ, ...)`` result (``lax.all_gather``);

and two on picklable host objects, for a controller rank that hands its
work to the others (``serve.DecompositionService`` over κ ranks):
``broadcast_object`` and ``all_gather_object``.

A mesh of one rank needs no process group; its collectives are the
identity, as a one-device ``shard_map`` is.  Ranks come up through
``init_ranks`` (a ``file://`` rendezvous) or ``spawn_ranks``, which runs a
function on κ spawned ranks with a hard time limit.

Backends.  NCCL when every rank has a GPU of its own (``world_size <=
torch.cuda.device_count()``), gloo otherwise: the CPU, or several ranks
sharing one card.  gloo takes host tensors, so the mesh copies a CUDA
tensor to the host and back around a gloo collective, explicitly, and
counts the copies (``stats["staged_copies"]``); the sweep and the kernel
stay on the card.  gloo also blocks the host for the collective's
duration, which ``stats["wait_s"]`` adds up (host clock, every backend).
``make_host_mesh`` is the trainer's 1-D mesh named ``data``.

For the dry run (``launch.dryrun``) the module also holds ``HW``, the
H100 SXM table its roofline reads, and ``make_production_mesh``, the
reference's production layouts as ``AbstractMesh``es: axis names and
sizes, no devices, no process group.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..obs import clock as obs_clock

AXIS = "sm"          # the distributed engine's axis (κ partitions ↦ κ ranks)
BATCH_AXIS = "batch"  # the pod path's axis


def backend_for(world_size: int, device) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


class Mesh:
    """One rank's view of a 1-D mesh: ``axis_name``, ``size`` (κ),
    ``rank``, this rank's ``device``, the process ``group`` (None for a
    mesh of one rank) and its ``backend``."""

    def __init__(self, axis_name: str, *, size: int = 1, rank: int = 0,
                 device="cuda", group=None, backend: str | None = None):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"bad mesh rank {rank} of {size}")
        if size > 1 and group is None:
            raise ValueError("a mesh of more than one rank needs a process group")
        self.axis_name = axis_name
        self.size = int(size)
        self.rank = int(rank)
        self.device = resolve_device(device)
        self.group = group
        self.backend = backend
        self.stats = {"collectives": 0, "staged_copies": 0, "wait_s": 0.0}

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis_name,)

    @property
    def axis_sizes(self) -> tuple[int]:
        return (self.size,)

    @property
    def ranks(self) -> list[int]:
        return list(range(self.size))

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_name!r}, rank {self.rank} of {self.size}, "
                f"{self.device}, {self.backend or 'no group'})")

    def _staged(self, x: torch.Tensor) -> bool:
        """True when the backend takes no CUDA tensor: stage through the host."""
        return self.backend == "gloo" and x.device.type == "cuda"

    def _run(self, x: torch.Tensor, collective):
        """``collective(host_or_device_tensor) -> tensor`` on ``x``, staged
        through the host when the backend needs it, counted and timed."""
        t0 = obs_clock.now()
        if self._staged(x):
            out = collective(x.cpu()).to(x.device)
            self.stats["staged_copies"] += 2
        else:
            out = collective(x)
        self.stats["collectives"] += 1
        self.stats["wait_s"] += obs_clock.now() - t0
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the mesh, on every rank (``x`` is not changed)."""
        if self.group is None:
            return x

        def all_reduce(t):
            t = t.clone() if t is x else t
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            return t

        return self._run(x, all_reduce)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``(size, *x.shape)``."""
        if self.group is None:
            return x[None]

        def gather(t):
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t.contiguous(), group=self.group)
            return torch.stack(parts)

        return self._run(x, gather)

    def broadcast_object(self, obj):
        """Rank 0's picklable ``obj`` on every rank (the other ranks' ``obj``
        is ignored); the identity on a mesh of one rank."""
        if self.size == 1:
            return obj
        box = [obj if self.rank == 0 else None]
        self._run_objects(lambda: dist.broadcast_object_list(box, src=0,
                                                             group=self.group))
        return box[0]

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj`` in rank order; ``[obj]`` on a mesh
        of one rank."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        self._run_objects(lambda: dist.all_gather_object(out, obj, group=self.group))
        return out

    def _run_objects(self, collective) -> None:
        """Run an object collective, counted and timed.  NCCL moves the
        pickled bytes through the current card: make it this rank's."""
        t0 = obs_clock.now()
        if self.backend == "nccl":
            with torch.cuda.device(self.device):
                collective()
        else:
            collective()
        self.stats["collectives"] += 1
        self.stats["wait_s"] += obs_clock.now() - t0

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh described by its axis names and sizes alone: what the
    sharding rules (``models.common.mesh_shape``) and the dry run read.
    It holds no devices and runs nothing."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production layouts: (data=16, model=16), and with
    ``multi_pod`` (pod=2, data=16, model=16), whose ``pod`` axis is pure
    data parallelism across hosts.  On H100s a 16-wide ``model`` axis
    spans two NVLink hosts of 8 cards."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


# One NVIDIA H100 SXM (80 GB HBM3, 700 W power limit) for the roofline
# model: NVIDIA's data sheet, dense rates.  ``ici_bw`` is NVLink's rate
# each way to the other cards of a host of 8; ``dcn_bw`` one 400 Gb/s
# network port per card across hosts; ``smem_bytes`` the shared memory
# one block can use.
HW = {
    "name": "h100_sxm",
    "peak_flops_bf16": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "ici_bw": 450e9,               # B/s
    "dcn_bw": 50e9,                # B/s
    "hbm_bytes": 80e9,
    "smem_bytes": 232448,
    "sm_count": 132,
}


def make_mesh(shape, axes, *, device="cuda") -> Mesh:
    """A 1-D mesh of ``shape[0]`` ranks named ``axes[0]``.  With a process
    group up, the mesh spans its world (``shape[0]`` must equal the world
    size, or be 1 for this rank alone); without one, only a mesh of one
    rank exists."""
    if len(shape) != 1 or len(axes) != 1:
        raise NotImplementedError(
            f"the port's meshes are 1-D, got shape {tuple(shape)} axes {tuple(axes)}")
    n = int(shape[0])
    if n < 1:
        raise ValueError("a mesh needs at least one rank")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n == world:
            return Mesh(axes[0], size=n, rank=rank, device=_rank_device(rank, device),
                        group=dist.group.WORLD, backend=dist.get_backend())
    if n != 1:
        raise ValueError(
            f"a mesh of {n} ranks needs a process group of {n} ranks "
            f"(init_ranks or spawn_ranks)")
    return Mesh(axes[0], device=device)


def make_batch_mesh(num_devices: int | None = None, *, device="cuda") -> Mesh:
    """The pod path's 1-D mesh over the batch axis: every rank of the
    process group (one rank without a group), or ``num_devices`` of them."""
    if num_devices is None:
        num_devices = (dist.get_world_size()
                       if dist.is_available() and dist.is_initialized() else 1)
    return make_mesh((int(num_devices),), (BATCH_AXIS,), device=device)


def make_host_mesh(*, device="cuda") -> Mesh:
    """The trainer's mesh (the reference's ``make_host_mesh`` default): 1-D
    over every rank of the process group (one rank without a group), named
    ``data``."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return make_mesh((world,), ("data",), device=device)


def _rank_device(rank: int, device) -> torch.device:
    """``cuda:{rank % device_count}`` for a CUDA mesh, else the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_ranks(rank: int, world_size: int, init_method: str, *,
               device="cuda") -> Mesh:
    """Join a process group of ``world_size`` ranks through ``init_method``
    (``file://<path>``; never a fixed TCP port) and return this rank's
    mesh over the ``AXIS`` axis, on the backend ``backend_for`` picks.
    The backend binds to the loopback interface unless
    ``GLOO_SOCKET_IFNAME`` / ``NCCL_SOCKET_IFNAME`` say otherwise: the
    ranks share one host."""
    dev = _rank_device(rank, device)
    backend = backend_for(world_size, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    os.environ.setdefault(
        "GLOO_SOCKET_IFNAME" if backend == "gloo" else "NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return Mesh(AXIS, size=world_size, rank=rank, device=dev,
                group=dist.group.WORLD, backend=backend)


def _rank_main(rank, fn, world_size, workdir, device, args):
    """One spawned rank: join the group, run ``fn(mesh, *args)``, write its
    result where ``spawn_ranks`` reads it."""
    torch.set_num_threads(1)
    mesh = init_ranks(rank, world_size, f"file://{workdir}/rendezvous",
                      device=device)
    try:
        out = fn(mesh, *args)
        mesh.barrier()
    finally:
        dist.destroy_process_group()
    (Path(workdir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def spawn_ranks(fn, world_size: int, args=(), *, timeout: float,
                device="cuda", workdir=None) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned ranks (start
    method ``spawn``: CUDA does not survive a fork) and return their
    results in rank order.  ``fn`` must be importable (a module-level
    function).  ``workdir`` (a fresh directory; default a new temporary
    one, removed afterwards) holds the rendezvous file and the results.
    Past ``timeout`` seconds every rank is killed and ``TimeoutError``
    raised.  A rank that raises ends every rank, and the first error the
    parent sees is raised here (the raising rank's, or a peer's whose
    collective it broke).  Build the kernel library before spawning, so
    that no two ranks compile it."""
    import torch.multiprocessing as mp

    own_dir = workdir is None
    workdir = Path(tempfile.mkdtemp()) if own_dir else Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, str(workdir), str(device),
                              tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {getattr(fn, '__name__', fn)} "
                        f"did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
                for r in range(world_size)]
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
