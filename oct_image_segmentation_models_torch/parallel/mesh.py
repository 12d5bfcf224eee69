"""The data-parallel mesh, counterpart of the JAX package's
``parallel/mesh.py``.

The JAX package runs one process per host with a mesh over that host's
chips. The port runs one process (rank) per device, in a
``torch.distributed`` process group, and lays the ranks out on a
:class:`Mesh` with two named axes, ``("node", "local")``, so that it
reproduces both JAX layouts:

- a node is a JAX process: it keeps the strided sample shard
  ``slice(node, None, nodes)`` trimmed to floor(N / nodes), and its
  batches are ``batch_size // nodes`` samples;
- a local rank is a device of that process's mesh: the node's ranks draw
  the same batches (each holds the node's shard in host memory, where the
  JAX process holds it once), and local rank ``l`` of ``L`` takes rows
  ``[l * b / L, (l + 1) * b / L)`` of each, as the mesh shards them.

Rank ``node * L + l`` is then the index of the device that gets these
rows in JAX's mesh. A world of 2 on one node is JAX's one-process
2-device mesh; two nodes of two ranks are two JAX processes of two
devices each.

Each rank has one device, ``cuda:{local_rank}`` unless the caller names
another (two ranks may share one card; a bare ``"cuda"`` is the local
rank's card). The process group's backend is
chosen explicitly (:func:`init_distributed`: NCCL for CUDA, gloo for the
CPU, unless the caller asks for another); gathers of numpy results go
over a gloo group, as JAX's ``process_allgather`` is host-level.

The spmd step's global batch (:func:`global_batch`) needs collectives
with a gradient: :func:`all_reduce_sum` and :func:`gather_rows`, built on
``dist.all_reduce`` alone in both directions. (The backward of
``torch.distributed.nn.functional.all_gather`` is a reduce-scatter under
NCCL and an all-to-all otherwise; gloo has no reduce-scatter, and its
all-to-all takes no CUDA tensors, while ranks that share a card run gloo
on CUDA tensors.)
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from .._device import resolve_device

MESH_AXES = ("node", "local")


def init_distributed(
    device,
    *,
    rank: int = None,
    world_size: int = None,
    init_method: str = "env://",
    backend: str = None,
    timeout: timedelta = None,
) -> None:
    """``torch.distributed.init_process_group`` for ranks on ``device``'s
    type: NCCL for ``cuda``, gloo for ``cpu``, unless ``backend`` names
    another (gloo on the card, for ranks that share one). ``rank`` and
    ``world_size`` default to the launcher's environment (``torchrun``)."""
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"timeout": timeout} if timeout is not None else {}
    if rank is not None:
        kwargs.update(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method, **kwargs)


@dataclass(frozen=True)
class Mesh:
    """A rank's place in the data-parallel world (see the module
    docstring): ``nodes`` x ``local_size`` ranks, this one ``rank`` on
    ``device``. Built by :func:`create_mesh`, which adds the host
    group."""

    nodes: int
    local_size: int
    rank: int
    device: torch.device
    host_group: object = None  # gloo ProcessGroup over every rank

    @property
    def world(self) -> int:
        return self.nodes * self.local_size

    @property
    def node(self) -> int:
        return self.rank // self.local_size

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_size

    def local_rows(self, n: int) -> slice:
        """This rank's rows of a node batch of ``n``."""
        return _rows(n, self.local_rank, self.local_size, "the node's ranks")

    def world_rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` split over every rank."""
        return _rows(n, self.rank, self.world, "the world's ranks")


def _rows(n: int, index: int, count: int, what: str) -> slice:
    if n % count:
        raise ValueError(f"a batch of {n} does not split evenly over {count} ({what})")
    per = n // count
    return slice(index * per, (index + 1) * per)


# The process group the layout below was built for, its ranks per node
# and device type, with the (node, local rank) of this rank and the host
# group: built once per process group, as each build creates groups.
_layout_cache = None


def _layout(local_size: int, device_type: str):
    """(node, local rank, host group) of this rank in the initialised
    process group, from a ``DeviceMesh`` over ``MESH_AXES``."""
    global _layout_cache
    world_group = dist.group.WORLD
    if (
        _layout_cache is None
        or _layout_cache[0] is not world_group
        or _layout_cache[1] != (local_size, device_type)
    ):
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        device_mesh = init_device_mesh(
            device_type, (world // local_size, local_size), mesh_dim_names=MESH_AXES
        )
        host_group = (
            world_group if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
        )
        node, local_rank = device_mesh.get_local_rank("node"), device_mesh.get_local_rank("local")
        _layout_cache = (world_group, (local_size, device_type), (node, local_rank, host_group))
    return _layout_cache[2]


def rank_device(device, rank: int, local_size: int) -> torch.device:
    """A rank's device: ``cuda:{local rank}`` for None or a bare
    ``"cuda"``, else ``device`` as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % local_size)
    return resolve_device(device)


def create_mesh(local_size: int = None, device=None) -> Mesh:
    """The mesh of this rank in the initialised process group.

    ``local_size`` is the number of ranks per node: the launcher's
    ``LOCAL_WORLD_SIZE`` when it sets one, else the whole world (one
    node). ``device`` defaults to ``cuda:{local_rank}``, as does a bare
    ``"cuda"``; it never falls back to the CPU on its own."""
    if not dist.is_initialized():
        raise ValueError(
            "create_mesh needs an initialised process group "
            "(parallel.mesh.init_distributed or torch.distributed.init_process_group)"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local_size < 1 or world % local_size:
        raise ValueError(f"{local_size} ranks per node do not divide a world of {world}")
    device = rank_device(device, rank, local_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    node, local_rank, host_group = _layout(local_size, device.type)
    mesh = Mesh(world // local_size, local_size, node * local_size + local_rank, device, host_group)
    if mesh.rank != rank:
        raise AssertionError(f"rank {rank} sits at node {node}, local rank {local_rank}")
    return mesh


def all_gather_host(obj, mesh: Mesh) -> list:
    """``obj`` of every rank, in rank order, over the host group."""
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` is True on any."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def sum_over_world(tensors: list) -> list:
    """The sum over every rank of each tensor, in one all-reduce of the
    tensors laid end to end. Returns new tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    parts = flat.split([t.numel() for t in tensors])
    return [part.view(t.shape) for part, t in zip(parts, tensors)]


def mean_over_world(tensors: list, mesh: Mesh) -> list:
    """The mean over every rank of each tensor (JAX's ``pmean``: the sum
    divided by the world size). Returns new tensors."""
    return [t / mesh.world for t in sum_over_world(tensors)]


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers, in place, on every rank."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


# --- the global batch of impl="spmd" over more than one rank ----------------
#
# JAX's "spmd" step is the one-device step on the global batch: the
# concatenation of every rank's rows in rank order. The step enters
# :func:`global_batch` for the duration of its forward and backward; inside
# it, every BatchNorm sums its statistics over the world
# (:func:`sum_over_global_batch`), and the random draws of dropout and the
# device augmentation draw the global batch's values from a stream that
# every rank shares and keep this rank's rows (:func:`draw_rows`). The
# switch is per thread, as ``torch.no_grad`` is: another thread of the
# process (an input producer) does not see it.

_switch = threading.local()


@contextlib.contextmanager
def global_batch(mesh: Mesh):
    """Compute on the global batch of ``mesh``'s world while inside (in
    this thread)."""
    prev = global_mesh()
    _switch.mesh = mesh
    try:
        yield
    finally:
        _switch.mesh = prev


def global_mesh():
    """The mesh whose global batch the current step computes on, or None."""
    return getattr(_switch, "mesh", None)


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """The sum over every rank; its gradient is the sum of every rank's
    gradient (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows in rank order (``Mesh.world_rows``), by an
    all-reduce of this rank's rows in a zero buffer; the gradient is the
    all-reduce of the gradient, this rank's rows of it."""

    @staticmethod
    def forward(ctx, t, world: int, rank: int):
        n = t.shape[0]
        ctx.rows = slice(rank * n, (rank + 1) * n)
        buf = t.new_zeros((world * n,) + tuple(t.shape[1:]))
        buf[ctx.rows] = t
        dist.all_reduce(buf)
        return buf

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)[ctx.rows], None, None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank, differentiable (``dist.all_reduce``
    in both directions)."""
    return _AllReduceSum.apply(t)


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The world's rows of ``t`` concatenated in rank order, differentiable
    (``dist.all_reduce`` in both directions, so that gloo carries it for
    CUDA tensors too)."""
    return _GatherRows.apply(t, mesh.world, mesh.rank)


def sum_over_global_batch(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the world inside :func:`global_batch`, else ``t``."""
    return t if global_mesh() is None else all_reduce_sum(t)


def global_batch_size(n: int) -> int:
    """The size of the global batch whose local part has ``n`` rows."""
    mesh = global_mesh()
    return n if mesh is None else n * mesh.world


def draw_rows(draw, shape) -> torch.Tensor:
    """``draw(shape)`` for a batch of ``shape[0]`` rows; inside
    :func:`global_batch`, the global batch's draw (from the stream every
    rank shares) and this rank's rows of it."""
    mesh = global_mesh()
    if mesh is None:
        return draw(tuple(shape))
    n = shape[0] * mesh.world
    return draw((n,) + tuple(shape[1:]))[mesh.world_rows(n)]
