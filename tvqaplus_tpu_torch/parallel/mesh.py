"""The device mesh over processes, one device each (port of
``tvqaplus_tpu/parallel/mesh.py``).

The JAX package lays its step out on a ("data", "ctx"[, "model"]) device
mesh and lets jit's SPMD partitioner insert the collectives.  Here the mesh
is N processes (``torchrun``, or ``init_distributed`` as the JAX multihost
worker calls ``jax.distributed.initialize``) joined by one
``torch.distributed`` process group (NCCL on ``cuda``, gloo on the CPU),
laid out row-major over (data, ctx, model) as JAX reshapes its device list
(mesh.py:67): rank ``r = (d ctx + c) model + m``, so a rank's ctx and
model peers are contiguous ranks.  What JAX's partitioner derives, the port
does by hand:

* ``data``: each data row ``d`` runs rows ``[d b, (d + 1) b)`` of every
  global batch of ``data b`` rows.  STAGE's losses are sums over the
  batch, so the global step's gradient is the SUM of the rows' gradients
  (GSPMD's ``psum``), not their mean; the counts the cls loss rescales by,
  the log windows and the validation totals are summed over the data group
  (``all_reduce_sum``), and the rows of validation and serving gathered in
  global order over it (``gather_objects``).
* ``ctx``: context parallelism over the sampled-image axis Li.  Each ctx
  rank ``c`` of a data row holds slice ``c`` of Li of the batch's
  ``LI_KEYS`` (``shard_batch``, ``li_slice``).  STAGE never mixes frames
  before its head, so the per-frame chain runs on the local frames; one
  autograd-aware all-gather over the ctx group after it (``gather_ctx``,
  models/stage.py) hands the head, the losses and the span search the
  whole Li, replicated on every ctx rank.
* ``model``: tensor parallelism of the large weights.  JAX's rule
  (``state_shardings``) picks them: a leaf of at least 2 dims and
  ``TP_MIN_PARAMS`` elements whose last axis, in the JAX layout, the model
  size divides (``sharded_parameters``).  Each model rank holds its
  columns of such a dense layer (``place_model``); the layer all-gathers
  its output over the model group (models/layers.py ``dense``).  The
  weights the kernels take whole (the attention's and the tri bridge's
  3D x D projections, the encoders' pointwise convs: at hsz >= 256) keep
  their column blocks as well, and each forward all-gathers each whole
  weight once (``gather_weight``; models/stage.py): the work on it is
  replicated on every model rank, which holds its whole gradient, so the
  gather's backward takes this rank's block of it and sums nothing.

Gradients (``all_reduce_grads``): the gather's backward is the local slice
of the incoming gradient, which is the whole gradient on every ctx rank
(what follows the gather is the same on each).  So a parameter before the
gather gets the gradient through this rank's frames, to be summed over
data and ctx (the ``grad`` group: the ranks of one model coordinate); a
parameter after it (STAGE's head) holds the whole gradient of its data row
on every ctx rank, to be summed over data alone.  Model-sharded weights
sum at their own model coordinate; every other leaf's gradient is whole on
every model rank (the dense layer's input gradient is all-reduced over the
model group in its backward), to be summed over data (and ctx) alone.  A
gradient that several ranks hold whole counts once: the replicas other
than ctx 0 (the head) and model 0 (the replicated leaves) add zeros to the
sum, which also hands every replica the same bits where the card's
kernels (atomics in a backward) leave the replicas' own a rounding
apart.

Subgroups are made once, on every rank, in one order (``new_group`` is
collective).  A group that spans every process is the world group itself;
an axis of size 1 gets no group and makes no call, so a (N, 1) mesh runs
the collectives of a data-only mesh.  Every helper takes a ``Mesh`` or
None; with None, or a mesh without a process group, it does no
communication.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

# batch keys that carry Li at dim 1 (JAX mesh.py:36-41); sub_tokens (dim 1
# is St), the labels and the att_* entries carry no Li
LI_KEYS = ("sub_bert", "sub_win_idx", "sub_mask", "vid", "vid_mask",
           "ts_mask")
# minimum element count of a leaf that shards over "model" (JAX
# mesh.py:106-110)
TP_MIN_PARAMS = 65536


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a ("data", "ctx"[, "model"]) mesh: the axis
    sizes (``model`` None for a 2-entry mesh shape), its ``rank`` in the
    world and the process groups (None: no communication).  ``group`` is
    the world group; ``data_group``, ``ctx_group`` and ``model_group`` join
    the ranks that differ in that coordinate alone, ``grad_group`` the ranks
    of this model coordinate (data x ctx)."""

    data: int
    ctx: int = 1
    model: Optional[int] = None
    rank: int = 0
    group: Any = None
    data_group: Any = None
    ctx_group: Any = None
    model_group: Any = None
    grad_group: Any = None

    @property
    def shape(self):
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        out = {"data": self.data, "ctx": self.ctx}
        if self.model is not None:
            out["model"] = self.model
        return out

    @property
    def model_size(self):
        return self.model or 1

    @property
    def coords(self):
        """(d, c, m): this rank's place in the row-major grid."""
        m = self.rank % self.model_size
        c = (self.rank // self.model_size) % self.ctx
        return self.rank // (self.model_size * self.ctx), c, m

    @property
    def d(self):
        return self.coords[0]

    @property
    def c(self):
        return self.coords[1]

    @property
    def m(self):
        return self.coords[2]

    @property
    def is_main(self):
        """Rank 0: the process that writes the run's files."""
        return self.rank == 0


def init_distributed(coordinator_address, num_processes, process_id,
                     local_device_ids=None, device="cuda"):
    """Join a run of ``num_processes`` processes (JAX mesh.py:70-77):
    ``init_process_group`` over ``tcp://coordinator_address`` (host:port;
    an address with a scheme, such as a ``file://`` store, as it is)
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
        backend, init_method=coordinator_address
        if "://" in coordinator_address else f"tcp://{coordinator_address}",
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


def _mesh_sizes(mesh_shape, world):
    """(data, ctx, model) of ``mesh_shape`` over ``world`` processes; one
    -1 entry absorbs the rest (JAX mesh.py:51-67)."""
    sizes = [int(s) for s in mesh_shape]
    if len(sizes) not in (2, 3):
        raise ValueError(f"mesh shape {mesh_shape}: 2 or 3 entries")
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh shape {mesh_shape}: one -1 entry at most")
    if any(s < 1 and s != -1 for s in sizes):
        raise ValueError(f"mesh shape {mesh_shape}: sizes are >= 1 or -1")
    if -1 in sizes:
        rest = 1
        for s in sizes:
            rest *= s if s != -1 else 1
        if world % rest:
            raise ValueError(f"mesh shape {mesh_shape} does not divide "
                             f"{world} processes")
        sizes[sizes.index(-1)] = world // rest
    total = sizes[0] * sizes[1] * (sizes[2] if len(sizes) == 3 else 1)
    if total != world:
        raise ValueError(
            f"mesh shape {mesh_shape}: data x ctx x model = {total}, but "
            f"{world} process(es) run; the mesh spans every process (launch "
            f"with torchrun --nproc_per_node {total})")
    return sizes


def _axis_groups(sizes, rank, world, world_group):
    """The data, ctx, model and grad groups of ``rank`` on a (data, ctx,
    model) grid: every rank makes every subgroup, in one order."""
    data, ctx, model = sizes
    grid = [[[(d * ctx + c) * model + m for m in range(model)]
             for c in range(ctx)] for d in range(data)]
    members = {
        "data": [[grid[d][c][m] for d in range(data)]
                 for c in range(ctx) for m in range(model)],
        "ctx": [[grid[d][c][m] for c in range(ctx)]
                for d in range(data) for m in range(model)],
        "model": [grid[d][c] for d in range(data) for c in range(ctx)],
        "grad": [[grid[d][c][m] for d in range(data) for c in range(ctx)]
                 for m in range(model)],
    }
    made, out = {}, {}
    for name, lists in members.items():
        size = len(lists[0])
        # the data and grad groups of a world of one are the world group,
        # whose collectives a data-only mesh makes (chip_smoke.py, phase
        # data_parallel); a ctx or model axis of size 1 makes no call
        if world_group is None or (size == 1 and (
                world > 1 or name in ("ctx", "model"))):
            out[name] = None
            continue
        if size == world:
            out[name] = world_group
            continue
        mine = None
        for ranks in lists:
            key = tuple(ranks)
            if key not in made:
                made[key] = dist.new_group(ranks)
            if rank in ranks:
                mine = made[key]
        out[name] = mine
    return out


def make_mesh(mesh_shape=(-1, 1)):
    """The mesh of a ("data", "ctx") or ("data", "ctx", "model") shape over
    the processes of the current group (JAX mesh.py:51-67): one -1 entry
    absorbs the world size, and data x ctx x model must be the world
    size.  Makes the axes' subgroups (collective: every rank calls it)."""
    world, rank, group = _world()
    sizes = _mesh_sizes(mesh_shape, world)
    full = sizes + [1] * (3 - len(sizes))
    groups = _axis_groups(full, rank, world, group)
    return Mesh(data=full[0], ctx=full[1],
                model=sizes[2] if len(sizes) == 3 else None, rank=rank,
                group=group, data_group=groups["data"],
                ctx_group=groups["ctx"], model_group=groups["model"],
                grad_group=groups["grad"])


def make_multihost_mesh(ctx=1):
    """The ("data", "ctx") mesh over every process of the group (JAX
    mesh.py:80-95): ``ctx`` must divide the processes of a node
    (``LOCAL_WORLD_SIZE``, which ``torchrun`` sets; the world without it),
    so a data row's ctx ranks, contiguous ranks, share a node."""
    world, _, _ = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if ctx < 1 or local % ctx:
        raise ValueError(f"ctx = {ctx} must divide the node's process "
                         f"count {local} (LOCAL_WORLD_SIZE)")
    return make_mesh((-1, ctx))


def data_parallel_size(mesh):
    return mesh.shape["data"]


def _active(mesh):
    return mesh is not None and mesh.group is not None


def _sum_op(group):
    """The reduction of every all-reduce here: a SUM.  On NCCL it is a sum
    pre-multiplied by 1.0, the same bits at any world size (x * 1.0 is x),
    because NCCL does no device work at all for an in-place SUM over one
    rank, where a pre-multiplied sum launches its kernel: so a run on one
    card captures and replays the collective inside the step's CUDA graph
    as N cards do (chip_smoke.py, phase data_parallel)."""
    if dist.get_backend(group) == "nccl":
        return dist._make_nccl_premul_sum(1.0)
    return dist.ReduceOp.SUM


def _all_reduce(tensor, group):
    dist.all_reduce(tensor, op=_sum_op(group), group=group)


def rank_rows(mesh, n):
    """This data row's range ``[d b, (d + 1) b)`` of a global batch of
    ``n = data b`` rows."""
    size = 1 if mesh is None else mesh.data
    if n % size:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{size} data ranks")
    b = n // size
    d = 0 if mesh is None else mesh.d
    return d * b, (d + 1) * b


def li_slice(mesh, li):
    """This ctx rank's frames ``[c l, (c + 1) l)`` of an Li bucket of
    ``li = ctx l`` frames."""
    ctx = 1 if mesh is None else mesh.ctx
    if li % ctx:
        raise ValueError(f"an Li bucket of {li} frames does not split over "
                         f"ctx = {ctx} ranks; use img_buckets (and "
                         f"max_num_img) that ctx divides")
    n = li // ctx
    c = 0 if mesh is None else mesh.c
    return c * n, (c + 1) * n


def shard_batch(mesh, batch, stacked=False):
    """A rank's part of a global batch, as JAX's ``batch_shardings`` lays
    it out (mesh.py:164-183): rows ``[d b, (d + 1) b)`` of dim 0 (dim 1
    when ``stacked``, a leading K axis) of every array, and of the
    ``LI_KEYS`` also frames ``[c l, (c + 1) l)`` of the next dim."""
    dim = 1 if stacked else 0
    out = {}
    for k, v in batch.items():
        lo, hi = rank_rows(mesh, v.shape[dim])
        v = v[:, lo:hi] if stacked else v[lo:hi]
        if k in LI_KEYS and v.dim() > dim + 1:
            f0, f1 = li_slice(mesh, v.shape[dim + 1])
            v = v[:, :, f0:f1] if stacked else v[:, f0:f1]
        out[k] = v
    return out


# ------------------------------------------------------ the ctx gather
class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` (``size`` ranks, this one at
    ``index``); the backward is this rank's slice of the gradient, which is
    whole on every rank of the group (what follows the gather runs the same
    on each)."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.slice = (dim, index * x.shape[dim], x.shape[dim])
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(*ctx.slice), None, None, None, None


class _ReduceGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``group``: the
    input of a layer whose columns are split over the group, so each rank
    holds the input's gradient through every column."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _all_reduce(grad, ctx.group)
        return grad, None


def gather_ctx(mesh, x, dim):
    """``x`` (this rank's frames of an Li-sharded tensor, Li at ``dim``)
    gathered over the ctx group into the whole Li, differentiably; ``x``
    itself without a ctx axis."""
    if mesh is None or mesh.ctx == 1:
        return x
    if mesh.ctx_group is None:
        raise RuntimeError(f"a mesh of ctx = {mesh.ctx} needs a process "
                           f"group")
    return _Gather.apply(x, mesh.ctx_group, mesh.ctx, mesh.c,
                         dim % x.dim())


# ----------------------------------------------- the model axis (TP)
@dataclasses.dataclass(frozen=True)
class Shard:
    """A dense layer's place on the model axis: ``size`` ranks of
    ``group`` each hold ``Dout / size`` output columns, this one block
    ``index``.  ``whole``: the layer's weight is used whole (a kernel's
    weight; ``gather_weight``), not by columns (``dense``)."""
    group: Any
    size: int
    index: int
    whole: bool = False


def sharded_parameters(model, size):
    """{name: dim} of the parameters the model axis of ``size`` shards:
    JAX's ``state_shardings`` rule (mesh.py:113-133) on the JAX layout,
    a leaf of >= 2 dims and >= ``TP_MIN_PARAMS`` elements whose last axis
    ``size`` divides; empty at size 1.  That axis is dim 0 of a Linear
    weight (out, in) or a Conv1d weight (out, in / 1, k), whose flax
    kernels put out last (interop/weights.py), and dim 1 of the void
    vectors, laid out alike."""
    if size <= 1:
        return {}
    out = {}
    for name, p in model.named_parameters():
        dim = 1 if name == "non_visual_vectors" else 0
        if p.dim() >= 2 and p.numel() >= TP_MIN_PARAMS \
                and p.shape[dim] % size == 0:
            out[name] = dim
    return out


def _split_layer(model, name):
    """(the module holding the weight ``name``, whether it is used whole):
    an ``nn.Linear`` that runs through models/layers.py ``dense`` (which
    splits its columns), or a weight the kernels take whole (the
    attention's and the tri bridge's projections, the encoders' pointwise
    convs, ``gather_weight``); else raise: the port shards no other leaf,
    and never replicates one that JAX shards."""
    from tvqaplus_tpu_torch.models import layers
    path = name.rsplit(".", 1)[0]
    module = model.get_submodule(path)
    parent = model.get_submodule(path.rsplit(".", 1)[0]) if "." in path \
        else model
    if type(parent) is torch.nn.Sequential:   # LinearWrapper's ``conv``
        parent = model.get_submodule(path.rsplit(".", 2)[0])
    if type(parent) is layers.MLPBridge and parent.use_kernel:
        raise NotImplementedError(
            f"{name}: the MLP-bridge kernel (ops/mlp_bridge.py, B5) takes "
            f"whole weights; B5 at model > 1 is not ported (ROADMAP.md, B5 "
            f"at model > 1)")
    if name.endswith(".weight"):
        if isinstance(module, torch.nn.Linear) and type(parent) in (
                layers.MLPBridge, layers.InputEmbedding,
                layers.LinearWrapper, layers.MultiHeadedAttention):
            return module, False
        if isinstance(module, torch.nn.Linear) and type(parent) in (
                layers.DownProjection, layers.TriMLPBridge):
            return module, True
        if isinstance(module, torch.nn.Conv1d) and path.endswith(
                "pointwise_conv") and isinstance(
                parent, layers.DepthwiseSeparableConv):
            return module, True
    raise NotImplementedError(
        f"{name}: JAX's rule shards this leaf over the model axis, but the "
        f"port splits only dense layers that run in plain PyTorch (MLP "
        f"bridges, input embedding, linear wrappers, attention heads) and "
        f"the kernels' weights; see ROADMAP.md A9")


def place_model(mesh, model, optimizer=None):
    """Place ``model`` (whole weights, the same on every rank) on ``mesh``:
    it reads the mesh's ctx axis (models/stage.py), and on a model axis
    each sharded weight (``sharded_parameters``) keeps this rank's block of
    output columns, as do Adam's moments in ``optimizer`` when it holds
    them (JAX's ``place_state``, mesh.py:135-145).  The parameter objects
    stay, so an optimizer over them holds the shards.  Idempotent for one
    mesh, a no-op for None; returns the model."""
    if mesh is None or getattr(model, "mesh", None) is mesh:
        return model
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already placed on another mesh")
    shards, whole_layers = {}, []
    if mesh is not None and mesh.model_size > 1:
        if mesh.model_group is None:
            raise RuntimeError(f"a mesh of model = {mesh.model} needs a "
                               f"process group")
        named = dict(model.named_parameters())
        for name, dim in sharded_parameters(model, mesh.model_size).items():
            layer, whole = _split_layer(model, name)
            p = named[name]
            n = p.shape[dim] // mesh.model_size
            with torch.no_grad():
                p.data = p.data.narrow(dim, mesh.m * n, n).clone()
                state = {} if optimizer is None \
                    else optimizer.state.get(p, {})
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in state:
                        state[k] = state[k].narrow(dim, mesh.m * n,
                                                   n).clone()
            layer.shard = Shard(mesh.model_group, mesh.model_size, mesh.m,
                                whole)
            shards[name] = p
            if whole:
                whole_layers.append(layer)
    model.mesh = mesh
    model.shards = shards
    model.whole_layers = whole_layers
    return model


def gather_weight(layer):
    """The whole weight of ``layer``: this rank's block of output columns
    all-gathered over the model group when the model axis splits it (dim
    0, out, of a Linear or Conv1d weight), the weight itself otherwise.
    The backward is this rank's block of the whole gradient: the work on
    the whole weight is the same on every model rank, so each already
    holds the whole gradient, and a sum over the group would multiply it
    by the group's size."""
    shard = getattr(layer, "shard", None)
    if shard is None:
        return layer.weight
    return _Gather.apply(layer.weight, shard.group, shard.size, shard.index,
                         0)


def whole_weight(layer):
    """``layer``'s whole weight: the one its model's forward gathered
    (``layer.whole``, models/stage.py), else ``gather_weight``."""
    whole = getattr(layer, "whole", None)
    return whole if whole is not None else gather_weight(layer)


def copy_to_model(shard, x):
    """The input of a column-split layer: the identity forward, the
    gradient summed over the model group backward."""
    return _ReduceGrad.apply(x, shard.group)


def gather_columns(shard, h):
    """A column-split layer's output block gathered on the last dim over
    the model group; the backward is this rank's block."""
    return _Gather.apply(h, shard.group, shard.size, shard.index,
                         h.dim() - 1)


def _gather_full(mesh, t, dim=0):
    parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def check_whole(model):
    """Raise unless every dense layer of ``model`` holds its whole weight:
    a file written from a model split over the model axis would hold one
    rank's columns (write it inside ``full_state``)."""
    for name, mod in model.named_modules():
        if (isinstance(mod, torch.nn.Linear) and tuple(mod.weight.shape)
                != (mod.out_features, mod.in_features)) or (
                isinstance(mod, torch.nn.Conv1d)
                and mod.weight.shape[0] != mod.out_channels):
            raise ValueError(f"{name}.weight is one rank's block "
                             f"{tuple(mod.weight.shape)} of the model axis; "
                             f"write the state inside full_state")


@contextlib.contextmanager
def full_state(mesh, model, optimizer=None):
    """Inside: ``model``'s sharded weights and their Adam moments as whole
    tensors (all-gathered over the model group: collective, every rank
    enters), so ``state_dict()`` and the optimizer's state are a single
    process's (checkpoints, ``best_valid.pth``, the flax export).  On exit
    the shards come back, the same tensors as before (a captured CUDA
    graph reads their memory)."""
    shards = getattr(model, "shards", None)
    if not shards:
        yield model
        return
    kept = []
    with torch.no_grad():
        for p in shards.values():
            state = {} if optimizer is None else optimizer.state.get(p, {})
            moments = {k: state[k] for k in ("exp_avg", "exp_avg_sq")
                       if k in state}
            kept.append((p, p.data, state, moments))
        for p, data, state, moments in kept:
            p.data = _gather_full(mesh, data)
            for k, v in moments.items():
                state[k] = _gather_full(mesh, v)
    try:
        yield model
    finally:
        for p, data, state, moments in kept:
            p.data = data
            state.update(moments)


# ----------------------------------------------------- the reductions
@torch.no_grad()
def all_reduce_sum(mesh, tensor):
    """``tensor`` summed over the data group, in place; returns it: the
    rows' counts and totals (every ctx and model rank of a row holds the
    same)."""
    if mesh is not None and mesh.data_group is not None:
        _all_reduce(tensor, mesh.data_group)
    return tensor


def _flat_sum(grads, group):
    if not grads or group is None:
        return
    if any(g.dtype != torch.float32 for g in grads):
        raise TypeError("all_reduce_grads takes float32 gradients")
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat, group)
    torch._foreach_copy_(
        grads, [c.view_as(g) for c, g in
                zip(flat.split([g.numel() for g in grads]), grads)])


@torch.no_grad()
def all_reduce_grads(mesh, params, head=(), shards=()):
    """Sum the parameters' gradients over the mesh: one all-reduce of one
    flat float32 buffer, copied back into the gradients (two under a model
    axis: the replicated leaves over every rank, the split ones over the
    grad group).

    A SUM, JAX's ``psum``: the cls, ts and att losses are sums over the
    batch's rows (models/losses.py), so the gradient of the global batch is
    the sum of the rows' gradients.  DistributedDataParallel's average
    would shrink it by the world size, and with the coupled L2 decay and
    the clip at 10 that is another step, not a rescaled one.  ``head``: the
    parameters after the ctx gather; ``shards``: those split over the
    model axis; what each rank adds is in the module docstring.  Every
    rank's backward reaches the same parameters (the graph depends on the
    config and the batch's keys, which the ranks share)."""
    if not _active(mesh):
        return
    head = {id(p) for p in head}
    split = {id(p) for p in shards}
    _, c, m = mesh.coords
    whole, cols = [], []
    for p in params:
        if p.grad is None:
            continue
        if (c and id(p) in head) or (m and id(p) not in split):
            p.grad.zero_()      # another replica's copy counts
        (cols if id(p) in split else whole).append(p.grad)
    _flat_sum(whole, mesh.group if mesh.model_size > 1 else mesh.grad_group)
    _flat_sum(cols, mesh.grad_group)


@torch.no_grad()
def grad_sq_sum(mesh, model, params):
    """The squared global norm of the gradients: a model-sharded leaf's
    squares summed over the model group, every other leaf's once (its
    gradient is the same on every model rank)."""
    shards = {id(p) for p in getattr(model, "shards", {}).values()}
    sq = lambda gs: sum(torch.sum(g.float() * g.float())  # noqa: E731
                        for g in gs)
    rep = [p.grad for p in params
           if p.grad is not None and id(p) not in shards]
    split = [p.grad for p in params
             if p.grad is not None and id(p) in shards]
    total = sq(rep)
    if split:
        part = sq(split).reshape(1).clone()
        _all_reduce(part, mesh.model_group)
        total = total + part[0]
    return total


@torch.no_grad()
def broadcast_state(mesh, model, optimizer=None, extra=None):
    """Rank 0's parameters, buffers, optimizer state (Adam's moments and
    step counts) and ``extra`` (picklable) on every rank, in place (the
    port's ``place_replicated``, JAX mesh.py:148-161), before the model is
    placed on a model axis (``place_model``).  Returns ``extra`` as rank 0
    has it."""
    if not _active(mesh):
        return extra
    if getattr(model, "shards", None):
        raise ValueError("broadcast_state takes whole weights: call it "
                         "before place_model")
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
    """Every data row's ``obj`` (picklable), in data order, on every rank
    (gathered over the data group: the ctx and model ranks of a row hold
    the same)."""
    if mesh is None or mesh.data_group is None:
        return [obj]
    out = [None] * mesh.data
    dist.all_gather_object(out, obj, group=mesh.data_group)
    return out


def barrier(mesh):
    """Wait for every rank (after rank 0 wrote a file the others may
    read)."""
    if _active(mesh):
        dist.barrier(group=mesh.group)
