"""Data parallelism over processes, one device each (port of the data axis
of ``tvqaplus_tpu/parallel/mesh.py``).

The JAX package lays its step out on a ("data", "ctx"[, "model"]) device
mesh and lets jit's SPMD partitioner insert the collectives.  Here the
``data`` axis is N processes (``torchrun``, or ``init_distributed`` as the
JAX multihost worker calls ``jax.distributed.initialize``) joined by one
``torch.distributed`` process group: NCCL on ``cuda``, gloo on the CPU.
Each rank holds a full copy of the state and runs rows ``[r b, (r + 1) b)``
of every global batch of ``N b`` rows; what JAX's partitioner derives, the
port does by hand:

* the gradient sum (``all_reduce_grads``): STAGE's losses are sums over
  the batch, so the global step's gradient is the SUM of the ranks'
  gradients (GSPMD's ``psum``), not their mean;
* the counts the cls loss rescales by (``all_reduce_sum``,
  models/losses.py), the log windows and the validation totals;
* the state at start and after a resume (``broadcast_state``), the rank-0
  decisions and files (``broadcast_object``, ``barrier``), and the rows of
  validation and serving in global order (``gather_objects``).

The ``ctx`` axis (context parallelism over Li) and the ``model`` axis
(tensor parallelism) are not ported: a mesh that asks for either raises.

Every helper takes a ``Mesh`` or None; with None, or a mesh without a
process group (world size 1 and no group), it does no communication.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

_NOT_PORTED = {
    "ctx": "context parallelism over Li (ROADMAP A9b)",
    "model": "the model axis, tensor parallelism (ROADMAP A9c)",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel layout of this process: ``data`` ranks (the world
    size), this process's ``rank`` and the process group that joins them
    (None without one: world size 1, no communication).  ``ctx`` and
    ``model`` are 1; ``model`` is None for a 2-entry mesh shape."""

    data: int
    ctx: int = 1
    model: Optional[int] = None
    rank: int = 0
    group: Any = None

    @property
    def shape(self):
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        out = {"data": self.data, "ctx": self.ctx}
        if self.model is not None:
            out["model"] = self.model
        return out

    @property
    def is_main(self):
        """Rank 0: the process that writes the run's files."""
        return self.rank == 0


def init_distributed(coordinator_address, num_processes, process_id,
                     local_device_ids=None, device="cuda"):
    """Join a run of ``num_processes`` processes (JAX mesh.py:70-77):
    ``init_process_group`` over ``tcp://coordinator_address`` (host:port)
    with NCCL for ``device`` ``cuda``, gloo for ``cpu``.  Returns this
    process's device: ``cuda:local_device_ids[0]``, else ``cuda:LOCAL_RANK``
    (0 when unset), or the CPU.  Idempotent: a second call returns the
    device and checks that the group matches."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        index = (local_device_ids[0] if local_device_ids
                 else int(os.environ.get("LOCAL_RANK", 0)))
        dev = torch.device("cuda", index)
    elif dev_type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {device}")
    backend = "nccl" if dev_type == "cuda" else "gloo"
    if dist.is_initialized():
        got = (dist.get_backend(), dist.get_world_size(), dist.get_rank())
        want = (backend, num_processes, process_id)
        if got != want:
            raise RuntimeError(f"a process group {got} (backend, world, "
                               f"rank) is already up; asked for {want}")
        return dev
    if dev_type == "cuda":
        torch.cuda.set_device(dev)
    # device_id (NCCL): the communicator is made here, before any step
    # could be captured in a CUDA graph
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        device_id=dev if dev_type == "cuda" else None)
    return dev


def init_from_env(device):
    """For an entry point: under ``torchrun`` (``WORLD_SIZE`` in the
    environment, with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
    ``LOCAL_RANK``) join its process group and return this rank's device
    (``cuda:LOCAL_RANK``, or the CPU with gloo); otherwise return
    ``device`` (a single process, no group)."""
    if "WORLD_SIZE" not in os.environ:
        return torch.device(device)
    env = os.environ
    return init_distributed(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            int(env["WORLD_SIZE"]), int(env["RANK"]),
                            device=device)


def close():
    """Leave the process group, if one is up (the end of an entry
    point)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def make_mesh(mesh_shape=(-1, 1)):
    """The mesh of a ("data", "ctx") or ("data", "ctx", "model") shape over
    the processes of the current group (JAX mesh.py:51-67).  One -1 entry
    absorbs the world size.  The data size must be the world size, and
    ``ctx`` and ``model`` 1: the other axes are not ported and raise."""
    sizes = [int(s) for s in mesh_shape]
    if len(sizes) not in (2, 3):
        raise ValueError(f"mesh shape {mesh_shape}: 2 or 3 entries")
    world, rank, group = _world()
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh shape {mesh_shape}: one -1 entry at most")
    if -1 in sizes:
        rest = 1
        for s in sizes:
            rest *= s if s != -1 else 1
        if rest < 1 or world % rest:
            raise ValueError(f"mesh shape {mesh_shape} does not divide "
                             f"{world} processes")
        sizes[sizes.index(-1)] = world // rest
    for name, size in zip(("ctx", "model"), sizes[1:]):
        if size != 1:
            raise ValueError(f"mesh shape {mesh_shape}: {name} = {size}; "
                             f"{_NOT_PORTED[name]} is not ported, so the "
                             f"mesh takes {name} = 1 only")
    if sizes[0] != world:
        raise ValueError(
            f"mesh shape {mesh_shape}: data = {sizes[0]}, but {world} "
            f"process(es) run; the data axis spans every process (launch "
            f"with torchrun --nproc_per_node {sizes[0]})")
    return Mesh(data=world, ctx=1, model=sizes[2] if len(sizes) == 3
                else None, rank=rank, group=group)


def make_multihost_mesh(ctx=1):
    """The mesh over every process of the group (JAX mesh.py:80-95); only
    ``ctx == 1`` is ported."""
    return make_mesh((-1, ctx))


def data_parallel_size(mesh):
    return mesh.shape["data"]


def _active(mesh):
    return mesh is not None and mesh.group is not None


def _sum_op(mesh):
    """The reduction of every all-reduce here: a SUM.  On NCCL it is a sum
    pre-multiplied by 1.0, the same bits at any world size (x * 1.0 is x),
    because NCCL does no device work at all for an in-place SUM over one
    rank, where a pre-multiplied sum launches its kernel: so a run on one
    card captures and replays the collective inside the step's CUDA graph
    as N cards do (chip_smoke.py, phase data_parallel)."""
    if dist.get_backend(mesh.group) == "nccl":
        return dist._make_nccl_premul_sum(1.0)
    return dist.ReduceOp.SUM


def rank_rows(mesh, n):
    """This rank's row range ``[r b, (r + 1) b)`` of a global batch of
    ``n = N b`` rows."""
    size = 1 if mesh is None else mesh.data
    if n % size:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{size} data ranks")
    b = n // size
    r = 0 if mesh is None else mesh.rank
    return r * b, (r + 1) * b


def shard_batch(mesh, batch, stacked=False):
    """A rank's rows ``[r b, (r + 1) b)`` of every array of a global batch:
    dim 0, or dim 1 when ``stacked`` (a leading K axis), as JAX's
    ``shard_batch`` lays the batch out (mesh.py:186-197)."""
    dim = 1 if stacked else 0
    out = {}
    for k, v in batch.items():
        lo, hi = rank_rows(mesh, v.shape[dim])
        out[k] = v[:, lo:hi] if stacked else v[lo:hi]
    return out


@torch.no_grad()
def all_reduce_sum(mesh, tensor):
    """``tensor`` summed over the ranks, in place; returns it."""
    if _active(mesh):
        dist.all_reduce(tensor, op=_sum_op(mesh), group=mesh.group)
    return tensor


@torch.no_grad()
def all_reduce_grads(mesh, params):
    """Sum the parameters' gradients over the ranks: one all-reduce over
    one flat float32 buffer, copied back into the gradients.

    A SUM, JAX's ``psum``: the cls, ts and att losses are sums over the
    batch's rows (models/losses.py), so the gradient of the global batch is
    the sum of the ranks' gradients.  DistributedDataParallel's average
    would shrink it by the world size, and with the coupled L2 decay and
    the clip at 10 that is another step, not a rescaled one.  Every rank's
    backward reaches the same parameters (the graph depends on the
    config and the batch's keys, which the ranks share)."""
    if not _active(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if any(g.dtype != torch.float32 for g in grads):
        raise TypeError("all_reduce_grads takes float32 gradients")
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=_sum_op(mesh), group=mesh.group)
    torch._foreach_copy_(
        grads, [c.view_as(g) for c, g in
                zip(flat.split([g.numel() for g in grads]), grads)])


@torch.no_grad()
def broadcast_state(mesh, model, optimizer=None, extra=None):
    """Rank 0's parameters, buffers, optimizer state (Adam's moments and
    step counts) and ``extra`` (picklable) on every rank, in place (the
    port's ``place_state`` / ``place_replicated``, JAX mesh.py:135-161).
    Returns ``extra`` as rank 0 has it."""
    if not _active(mesh):
        return extra
    params = list(model.parameters())
    tensors = params + list(model.buffers())
    if optimizer is not None:
        for p in params:
            st = optimizer.state.get(p, {})
            tensors += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    dev = params[0].device
    for t in tensors:
        if t.device == dev:
            dist.broadcast(t.data, src=0, group=mesh.group)
        else:                   # Adam's step counts on the CPU
            moved = t.to(dev)
            dist.broadcast(moved, src=0, group=mesh.group)
            t.copy_(moved)
    return broadcast_object(mesh, extra)


def broadcast_object(mesh, obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if not _active(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def gather_objects(mesh, obj):
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if not _active(mesh):
        return [obj]
    out = [None] * mesh.data
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def barrier(mesh):
    """Wait for every rank (after rank 0 wrote a file the others may
    read)."""
    if _active(mesh):
        dist.barrier(group=mesh.group)
