"""The data x model mesh over ``torch.distributed`` process groups, and the
collectives of the port's multi-device paths.

Counterpart of ``r2l_tpu/parallel/mesh.py`` (``make_mesh`` :27,
``batch_sharding`` :52, ``replicated_sharding`` :57, ``r2l_param_shardings``
:61, ``shard_pytree`` :92). The JAX package runs one SPMD process over a
``jax.sharding.Mesh`` and XLA inserts the collectives; the port runs one
process per device and calls them:

* ``make_mesh(axes)``: the ranks of the process group laid out as the axes
  say (``{'data': 4, 'model': 2}``; -1 is the rest), rank = the row-major
  index of its coordinates, as JAX reshapes its device list. Each rank
  holds the sub-group of each axis it lies on. ``sharded(mesh)`` is the one
  test of whether a path shards: a process group backs the mesh. Then
  every collective runs, at world size 1 too (a one-rank NCCL group issues
  them on the card); one process without a group is a mesh of size 1 whose
  collectives do nothing.
* ``shard_rows`` / ``gather_rows`` (``batch_sharding`` and
  ``replicated_sharding`` in JAX): a leading ray axis split over an axis,
  padded to a multiple with a fill value per array
  (``r2l_tpu/evaluate.py:136-175``), gathered back and sliced to its
  length.
* ``r2l_param_shardings``: Megatron tensor parallelism of the student over
  ``model`` on the plain path. Every rank keeps whole parameters and takes
  the same Adam update; the forward (``apply_r2l_tp``) uses a rank's slice:
  the head column-parallel (its outputs gathered), in each residual block
  the first linear column-parallel and the second row-parallel with one
  all-reduce, the tail replicated. ``sync_grads`` sums a sliced
  parameter's gradient over ``model`` (each rank filled its own slice) and
  every gradient over ``data`` (each rank's loss is its rows' share of the
  global batch mean).
* ``replicate_``: every parameter broadcast from rank 0 (the placement
  ``shard_pytree`` makes in JAX).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: ``axes`` (name -> size, in order), its
    coordinates, and for each axis the process group of the ranks that
    differ from it along that axis alone (None in a one-process run)."""
    axes: dict
    rank: int
    world: int
    coords: dict
    groups: dict
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    def size(self, axis: str) -> int:
        return int(self.axes.get(axis, 1))

    def index(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def distributed(self) -> bool:
        """Whether a process group backs the mesh (its axes have groups)."""
        return any(g is not None for g in self.groups.values())


def sharded(mesh: Mesh | None) -> bool:
    """Whether a step, frame or datagen run takes its sharded path: a mesh
    backed by a process group, of any world size."""
    return mesh is not None and mesh.distributed


def _resolve(axes: dict | None, n: int) -> dict:
    if not axes:
        return {"data": n}
    axes = dict(axes)
    wild = [k for k, v in axes.items() if v == -1]
    if wild:
        if len(wild) > 1:
            raise ValueError(f"mesh {axes}: at most one -1 axis")
        fixed = int(np.prod([v for v in axes.values() if v != -1]))
        axes[wild[0]] = n // fixed
    need = int(np.prod(list(axes.values())))
    if need != n:
        raise ValueError(f"mesh {axes} needs {need} processes, the process "
                         f"group has {n}")
    return axes


def make_mesh(axes: dict | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh of the current process group (all ranks on ``data`` by
    default). Every rank must call it, in the same order as the others: it
    creates the axes' process groups. ``device`` is where the collectives'
    tensors live (the rank's card under NCCL; the CPU under gloo)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axes = _resolve(axes, world)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.is_initialized()
                  and dist.get_backend() == "nccl" else torch.device("cpu"))
    names, sizes = list(axes), [int(v) for v in axes.values()]
    grid = np.arange(world).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    groups = {}
    for i, name in enumerate(names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks) if dist.is_initialized() \
                else None
            if rank in ranks:
                groups[name] = g
    return Mesh(axes, rank, world, coords, groups, torch.device(device))


def _span(n: int, mesh: Mesh, axis: str) -> tuple[int, int, int]:
    """(padded length, this rank's first row, rows per rank) of n rows
    split over ``axis``."""
    d = mesh.size(axis)
    per = -(-n // d)
    return per * d, mesh.index(axis) * per, per


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data",
               fill: float = 0.0) -> torch.Tensor:
    """This rank's rows of ``x`` [n, ...] split over ``axis``, after
    padding n to a multiple of the axis with ``fill`` (1.0 for ray
    directions keeps padded rays normalizable)."""
    if not sharded(mesh):
        return x
    n = x.shape[0]
    n_pad, lo, per = _span(n, mesh, axis)
    if n_pad != n:
        x = torch.cat([x, x.new_full((n_pad - n,) + tuple(x.shape[1:]),
                                     fill)])
    return x[lo:lo + per]


def gather_rows(local: torch.Tensor, mesh: Mesh, n: int,
                axis: str = "data") -> torch.Tensor:
    """Every rank's rows along ``axis`` in rank order, sliced to ``n``
    (the inverse of ``shard_rows``)."""
    if not sharded(mesh):
        return local[:n]
    src = local.contiguous()
    dtype = src.dtype
    if dtype in (torch.bfloat16, torch.float16):
        src = src.float()          # gloo has no collectives in half types
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src.to(mesh.device), group=mesh.group(axis))
    return torch.cat(parts)[:n].to(device=local.device, dtype=dtype)


def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str = "data"
                ) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place (and return it)."""
    if sharded(mesh):
        buf = t.to(mesh.device)
        dist.all_reduce(buf, group=mesh.group(axis))
        if buf is not t:
            t.copy_(buf)
    return t


def broadcast_value(x: float, mesh: Mesh | None) -> float:
    """Rank 0's value of ``x`` on every rank (in float64, so rank 0 keeps
    its own value); ``x`` itself without a process group."""
    if not sharded(mesh):
        return x
    t = torch.tensor([x], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, src=0)
    return float(t.item())


def replicate_(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Rank 0's parameters on every rank (in place)."""
    if sharded(mesh):
        with torch.no_grad():
            for p in module.parameters():
                buf = p.data.to(mesh.device)
                dist.broadcast(buf, src=0)
                if buf is not p.data:
                    p.data.copy_(buf)
    return module


# --------------------------------------------------------------------------
# Tensor parallelism over 'model' (Megatron), on the plain path
# --------------------------------------------------------------------------

def _tp_canonical(model: nn.Module) -> bool:
    cfg = model.cfg
    return cfg.body_arch == "resmlp" and cfg.n_learnable == 2


def r2l_param_shardings(mesh: Mesh, model: nn.Module,
                        model_axis: str = "model") -> dict:
    """Parameter name -> ``'column'`` (this rank uses a slice of the output
    rows), ``'row'`` (a slice of the input columns) or None (whole): the
    head and each block's first linear column-parallel, each block's second
    linear row-parallel, biases with their outputs, the tail whole. All
    None without a ``model`` axis above 1."""
    roles = {name: None for name, _ in model.named_parameters()}
    if mesh.size(model_axis) <= 1:
        return roles
    if not _tp_canonical(model):
        raise ValueError("tensor parallelism over 'model' takes the "
                         "resmlp body with two linears per block")
    if model.cfg.netwidth % mesh.size(model_axis):
        raise ValueError(f"netwidth {model.cfg.netwidth} does not split "
                         f"over a {mesh.size(model_axis)}-way model axis")
    roles["head.0.weight"] = roles["head.0.bias"] = "column"
    for i in range(len(model.body)):
        for p in ("weight", "bias"):
            roles[f"body.{i}.body.0.{p}"] = "column"
        roles[f"body.{i}.body.2.weight"] = "row"
    return roles


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the
    model group backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.float().contiguous()
        all_reduce_(g32, ctx.mesh, ctx.axis)
        return g32.to(g.dtype), None, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the partial products summed over the model group
    forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    """Column slices gathered along the last axis; backward, this rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.i, ctx.w = mesh.index(axis), x.shape[-1]
        parts = [torch.empty_like(x, dtype=torch.float32)
                 for _ in range(mesh.size(axis))]
        dist.all_gather(parts, x.float().contiguous(),
                        group=mesh.group(axis))
        return torch.cat(parts, dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.i * ctx.w:(ctx.i + 1) * ctx.w], None, None


def apply_r2l_tp(model: nn.Module, x: torch.Tensor, mesh: Mesh,
                 model_axis: str = "model") -> torch.Tensor:
    """``model(x)`` with the width split over ``model_axis`` (the roles of
    ``r2l_param_shardings``); ``model(x)`` itself without such an axis.
    The same rounding points as ``R2L.forward`` (each dot accumulated in
    f32 and cast to the compute dtype); a row-parallel product's partial
    sums meet in f32."""
    m = mesh.size(model_axis)
    if m <= 1:
        return model(x)
    r2l_param_shardings(mesh, model, model_axis)      # validates
    cfg = model.cfg
    cd = cfg.compute_dtype
    width = cfg.netwidth // m
    i = mesh.index(model_axis)
    sl = slice(i * width, (i + 1) * width)
    head, _, tail = model.linears()
    h = model.act(x.to(cd) @ head.weight[sl].to(cd).T
                  + head.bias[sl].to(cd))
    h = _GatherFromModel.apply(h, mesh, model_axis)
    out = h
    for blk in model.body:
        l1, inact, l2 = blk.body[0], blk.body[1], blk.body[2]
        t = _CopyToModel.apply(out, mesh, model_axis)
        a = inact(t @ l1.weight[sl].to(cd).T + l1.bias[sl].to(cd))
        part = a.float() @ l2.weight[:, sl].to(cd).float().T
        y = _ReduceFromModel.apply(part, mesh, model_axis).to(cd)
        y = y + l2.bias.to(cd)
        out = model.outact(y * cfg.res_scale + out)
    out = out + h if cfg.use_residual else out
    y = out.float() @ tail.weight.to(cd).float().T + tail.bias.float()
    return y if cfg.linear_tail else torch.sigmoid(y)


def sync_grads(module: nn.Module, mesh: Mesh, roles: dict | None = None,
               model_axis: str = "model", data_axis: str = "data") -> None:
    """Complete each rank's gradients after a backward on its rows: a
    sliced parameter's (``roles``) summed over ``model_axis``, then every
    parameter's over ``data_axis``; one flat buffer per collective."""
    params = [(n, p) for n, p in module.named_parameters()
              if p.grad is not None]
    roles = roles or {}

    def reduce(ps, axis):
        if not ps or not sharded(mesh):
            return
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        all_reduce_(flat, mesh, axis)
        off = 0
        for p in ps:
            k = p.grad.numel()
            p.grad.copy_(flat[off:off + k].view_as(p.grad))
            off += k

    reduce([p for n, p in params if roles.get(n)], model_axis)
    reduce([p for _, p in params], data_axis)
