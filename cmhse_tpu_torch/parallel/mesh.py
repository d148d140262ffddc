"""The process group and the mesh, counterpart of
``cmhse_tpu/parallel/mesh.py``.

The JAX package runs one process over every local device and lets XLA
insert the collectives. The port's mesh has two forms:

* **one process a card** (``torchrun --nproc_per_node=N``): a rank is a
  device, and the collectives are ``torch.distributed`` calls the port
  makes itself, NCCL between cards and gloo between CPU processes (the
  tests). Training (``train_dp``) and sharded evaluation
  (``sharded_ranks``, ``validate_metrics(mesh=)``) run on this form only.
* **local**: one process holds a list of devices, shard *i* on
  ``devices[i]``, with no process group (:func:`make_mesh` with
  ``devices=``, :func:`local_devices` for every visible card). This is the
  JAX daemon's design: ``make_mesh((-1,), ("data",))`` over
  ``jax.devices()`` in one process, with its threads and locks. The
  Retriever's mesh (``Retriever(mesh=)``, ``--sharded`` serving) runs on
  it: each shard's top-k runs on its own device, and the candidates are
  copied to ``devices[0]`` and merged there (:func:`gather_shards`). On
  the one-process-a-card form a sharded daemon would need rank 0 to own
  the socket and broadcast every query, add, remove and compaction to the
  other ranks in lockstep, and keep the compaction's off-lock snapshot
  consistent across them: a protocol the JAX package does not have.

:func:`make_mesh` returns a small :class:`Mesh`, not torch's
``DeviceMesh``. The port needs three things of a mesh: the group of ranks
along its ``data`` axis (the ones whose rows make one global batch), this
rank's place in it, and the device (or, locally, the devices). A
``DeviceMesh`` would build a group for every axis, its constructor's
arguments differ between the torch of the card's machine (2.11) and of
this image (2.13), and it needs a process group even for one card. A
:class:`Mesh` of one rank with no process group is a plain single-device
run: its collectives are the identity.

Every collective here is issued synchronously (no ``async_op``): under
NCCL the caller's stream waits on the collective's before its next kernel.
So the cooperative GRU grids (K1, K2), which need every block resident at
once, are never enqueued beside a running NCCL kernel from this code.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from cmhse_tpu_torch.device import resolve_device

# torch 2.13 renamed all_gather_into_tensor (and warns on the old name);
# the card's torch 2.11 has only the old one
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# the CPU shards of a local mesh when the caller names no count: the host
# device count of the JAX package's CPU tests (tests/conftest.py)
CPU_SHARDS = 8


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the run, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Wait for every process of the run (nothing to wait for alone)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def local_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: the card ``cuda:LOCAL_RANK`` unless the caller
    asks for the CPU (``resolve_device``'s rule: no card, no run)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def maybe_initialize_distributed(
        device: str | torch.device | None = None) -> bool:
    """Start the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    A no-op without that environment, and when a group is already up
    (idempotent: a second ``fit`` in one process must not raise). The
    backend follows the device: NCCL for the card (``cuda:LOCAL_RANK``,
    made the current device), gloo only when the caller asks for the CPU.
    Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    if not all(v in os.environ for v in _TORCHRUN_VARS):
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


@dataclass(eq=False)
class Mesh:
    """A named mesh over the run's ranks, row-major: rank r sits at the
    coordinates of r in ``shape``. The batch is sharded over ``data`` only;
    another axis (``model``) holds replicas and sits idle, as the JAX
    package's 2-D mesh does.

    ``group`` is the process group of this rank's ``data`` axis (the whole
    world when the mesh has no other axis), None for a run of one process
    without a process group. ``devices``: the devices this process holds,
    one a shard (default ``(device,)``); more than one makes a local mesh
    (module docstring), whose ``device`` is ``devices[0]``."""

    shape: dict[str, int]
    device: torch.device
    rank: int = 0
    world: int = 1
    group: Any = field(default=None, repr=False)
    devices: tuple[torch.device, ...] = ()

    def __post_init__(self):
        if not self.devices:
            self.devices = (self.device,)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        names = self.axis_names
        i = names.index(axis)
        stride = math.prod(self.shape[a] for a in names[i + 1:])
        return (self.rank // stride) % self.shape[axis]

    @property
    def data_size(self) -> int:
        return self.shape.get("data", 1)

    @property
    def data_index(self) -> int:
        return self.coord("data") if "data" in self.shape else 0

    @property
    def is_local(self) -> bool:
        """One process holding several shards (module docstring)."""
        return len(self.devices) > 1

    def local_shards(self) -> list[tuple[int, torch.device]]:
        """The ``(shard index, device)`` pairs this process holds: its own
        ``data`` index under a process group, every shard on a local
        mesh."""
        if self.is_local:
            return list(enumerate(self.devices))
        return [(self.data_index, self.device)]

    def check_axis(self, axis: str) -> None:
        """The port shards over the ``data`` axis only."""
        if axis != "data" and self.shape.get(axis, 1) > 1:
            raise ValueError(f"the port's mesh shards over its 'data' axis "
                             f"only, not {axis!r}")

    def check_process_mesh(self, what: str) -> None:
        """Refuse a local mesh of several devices where the port keeps one
        card a process: training and sharded evaluation."""
        if self.is_local:
            raise ValueError(
                f"{what} runs one card a process (torchrun); a local mesh "
                f"of {len(self.devices)} devices serves only the "
                "Retriever's sharded top-k")


def local_devices(platform: str | None = None,
                  n: int | None = None) -> list[torch.device]:
    """Every device this process can hold a shard on, the counterpart of
    ``jax.devices()``: each visible card ``cuda:0 .. cuda:n-1`` (raising
    where there is none, ``resolve_device``'s rule), or, when the caller
    asks for the CPU (``platform="cpu"``), ``n`` CPU entries (default
    :data:`CPU_SHARDS`, the JAX tests' host device count). ``n`` for the
    cards takes the first ``n``."""
    if platform == "cpu":
        return [torch.device("cpu")] * (CPU_SHARDS if n is None else n)
    resolve_device(None)
    count = torch.cuda.device_count()
    if n is not None and not 0 < n <= count:
        raise ValueError(f"{n} cards asked for, {count} visible")
    return [torch.device("cuda", i) for i in range(n or count)]


def make_mesh(shape: tuple[int, ...] = (-1,),
              axis_names: tuple[str, ...] = ("data",),
              device: str | torch.device | None = None,
              devices=None) -> Mesh:
    """A named mesh over every rank of the run, ``-1`` taking the ranks the
    fixed axes leave: JAX's shape rules and errors (one ``-1``, a world
    that divides by the fixed axes, no more ranks asked than there are).
    Every rank runs the program, so a mesh must also hold every rank.

    Without a process group the mesh is this one process (a world of 1).
    ``device``: this rank's device (:func:`local_device`); the CPU takes a
    gloo group, the card an NCCL one.

    ``devices``: a local mesh instead (module docstring): this one process
    holds ``len(devices)`` shards, shard i on ``devices[i]`` (a device may
    repeat), under the same shape rules with ``len(devices)`` in place of
    the world; it shards over ``data`` only. Refused under a process group
    of more than one rank, whose ranks would each claim every shard."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         f"differ in length")
    if devices is not None:
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a local mesh needs at least one device")
        if process_count() > 1:
            raise ValueError(
                f"a local mesh of {len(devices)} devices under a process "
                f"group of {process_count()} ranks: run one process over "
                "the local devices, or one card a rank without devices=")
        world, rank = len(devices), 0
    else:
        world, rank = process_count(), process_index()
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 allowed in mesh shape, got {shape}")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        if world % known:
            raise ValueError(
                f"mesh shape {shape}: {world} devices do not divide by the "
                f"fixed axes (product {known}) — a silent remainder would "
                "leave devices idle")
        shape = tuple(world // known if s == -1 else s for s in shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {shape} holds {n} of the run's {world} "
                         "ranks; every rank runs the program, so the mesh "
                         "must hold them all")
    named = dict(zip(axis_names, shape))
    if devices is not None:
        if named.get("data", 1) != world:
            raise ValueError(f"a local mesh shards over 'data' only; mesh "
                             f"{named} leaves devices idle on another axis")
        return Mesh(shape=named, device=devices[0], devices=devices)
    dev = local_device(device)
    if dist.is_initialized():
        backend = dist.get_backend()
        if (backend == "nccl") != (dev.type == "cuda"):
            raise ValueError(f"a {backend} process group cannot drive a "
                             f"{dev.type} mesh")
    mesh = Mesh(shape=named, device=dev, rank=rank, world=world)
    if dist.is_initialized():
        mesh.group = _data_group(mesh)
    return mesh


def _data_group(mesh: Mesh):
    """The process group of the ranks that differ from this one only along
    ``data``. Every rank creates every such group, in the same order, as
    ``new_group`` requires."""
    if mesh.data_size == mesh.world:
        return dist.group.WORLD
    if "data" not in mesh.shape:
        groups = [[r] for r in range(mesh.world)]
    else:
        names = mesh.axis_names
        i = names.index("data")
        stride = math.prod(mesh.shape[a] for a in names[i + 1:])
        span = stride * mesh.data_size
        groups = [[base + d * stride for d in range(mesh.data_size)]
                  for base in range(mesh.world) if base % span < stride]
    mine = None
    for ranks in groups:
        g = dist.new_group(ranks)
        if mesh.rank in ranks:
            mine = g
    return mine


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[data * rows, ...]``: every rank's ``x`` along the ``data`` axis,
    in rank order (no autograd; ``train_dp.gather_rows`` is the
    differentiable one). Bool tensors travel as uint8."""
    if mesh.group is None:
        return x
    n = dist.get_world_size(mesh.group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = src.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    # synchronous: the caller's stream waits on it (module docstring)
    _all_gather_single(out, src.contiguous(), group=mesh.group)
    return out.bool() if x.dtype == torch.bool else out


def gather_shards(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The per-shard tensors this process holds (``parts[i]`` of
    ``mesh.local_shards()[i]``), every shard's rows in shard order, on
    ``mesh.devices[0]``: :func:`all_gather_rows` under a process group,
    copies and one ``cat`` on a local mesh."""
    if mesh.is_local:
        dev = mesh.devices[0]
        return torch.cat([p.to(dev) for p in parts])
    (part,) = parts
    return all_gather_rows(part, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ``data`` axis (a new tensor)."""
    if mesh.group is None:
        return x
    out = x.clone()
    # synchronous: the caller's stream waits on it (module docstring)
    dist.all_reduce(out, group=mesh.group)
    return out
