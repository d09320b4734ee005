"""Collectives of the sharded step: what GSPMD inserts in the JAX package
(seld_tpu/parallel/sharding.py::time_batch_sharding) written out as
differentiable torch.distributed calls.

`attention_mesh(mesh, time_sharded)` scopes the mesh for the model's
layers, the loss and attention (the JAX package's name; the train and eval
steps run inside it): under it a
BatchNorm takes its statistics over the world, a convolution or max-pool
that spans time takes its edge rows from its time neighbours, Dropout
keeps its slice of a global-shape mask, and attention runs the ring (K5).

The autograd Functions:
  * all_reduce_sum: the sum over a group; its backward sums the
    cotangents over the same group, because every rank's result feeds
    that rank's own part of the loss;
  * halo_exchange: a time chunk with `width` rows of each neighbour's
    edge on either side (`fill` at the global edges); its backward sends
    each halo's cotangent back to the rank that owns those rows, which
    adds it;
  * all_gather_time: the model group's chunks concatenated in time
    order; its backward sums the cotangents over the group and keeps this
    rank's chunk (a reduce-scatter).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from seld_tpu_torch.parallel.mesh import Mesh

_CONTEXT = contextvars.ContextVar("seld_tpu_torch_attention_mesh", default=(None, False))


@contextlib.contextmanager
def attention_mesh(mesh: Mesh | None, time_sharded: bool = False):
    """Scope `mesh` (None: none) for the layers, the loss and attention
    inside the block; time_sharded says the tensors are time chunks. A
    ContextVar: other threads keep their own."""
    token = _CONTEXT.set((mesh, bool(time_sharded and mesh is not None)))
    try:
        yield
    finally:
        _CONTEXT.reset(token)


def current_mesh() -> tuple[Mesh | None, bool]:
    """(mesh, time_sharded) of the innermost attention_mesh."""
    return _CONTEXT.get()


def time_mesh() -> Mesh | None:
    """The mesh when the tensors are time chunks split over more than one
    rank, else None: what a layer that spans time asks."""
    mesh, time_sharded = _CONTEXT.get()
    return mesh if time_sharded and mesh.n_model > 1 else None


def world_mesh() -> Mesh | None:
    """The mesh when it holds more than one rank, else None: what a
    reduction over the global batch asks."""
    mesh, _ = _CONTEXT.get()
    return mesh if mesh is not None and mesh.world_size > 1 else None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of x over `group` (default: every rank), differentiable."""
    return _AllReduceSum.apply(x, group)


def _exchange(sends: list, recvs: list) -> None:
    """Post (tensor, global peer) sends and receives together and wait."""
    ops = ([dist.P2POp(dist.isend, t, peer) for t, peer in sends]
           + [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _neighbours(mesh: Mesh) -> tuple[int | None, int | None]:
    """Global ranks of the previous and next time chunk (None at an edge)."""
    m = mesh.model_rank
    left = mesh.model_ranks[m - 1] if m > 0 else None
    right = mesh.model_ranks[m + 1] if m + 1 < mesh.n_model else None
    return left, right


def _edge(x: torch.Tensor, dim: int, start: int, width: int) -> torch.Tensor:
    return x.narrow(dim, start, width).contiguous()


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, width, fill, mesh):
        ctx.dim, ctx.width, ctx.mesh = dim, width, mesh
        left, right = _neighbours(mesh)
        t = x.shape[dim]
        if width > t:
            raise ValueError(f"halo of {width} rows needs time chunks of at least {width}, "
                             f"got {t}")
        shape = list(x.shape)
        shape[dim] = width
        halo_l = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        halo_r = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        sends, recvs = [], []
        if left is not None:
            sends.append((_edge(x, dim, 0, width), left))
            recvs.append((halo_l, left))
        if right is not None:
            sends.append((_edge(x, dim, t - width, width), right))
            recvs.append((halo_r, right))
        _exchange(sends, recvs)
        return torch.cat([halo_l, x, halo_r], dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, width, mesh = ctx.dim, ctx.width, ctx.mesh
        left, right = _neighbours(mesh)
        t = g.shape[dim] - 2 * width
        gx = g.narrow(dim, width, t).contiguous()
        sends, recvs, adds = [], [], []
        if left is not None:  # my left halo's cotangent belongs to the left rank
            sends.append((_edge(g, dim, 0, width), left))
            back = torch.empty_like(sends[-1][0])
            recvs.append((back, left))
            adds.append((0, back))
        if right is not None:
            sends.append((_edge(g, dim, width + t, width), right))
            back = torch.empty_like(sends[-1][0])
            recvs.append((back, right))
            adds.append((t - width, back))
        _exchange(sends, recvs)
        for start, back in adds:
            gx.narrow(dim, start, width).add_(back)
        return gx, None, None, None, None


def halo_exchange(x: torch.Tensor, dim: int, width: int, fill: float,
                  mesh: Mesh) -> torch.Tensor:
    """x (this rank's time chunk along `dim`) with `width` rows of each
    time neighbour's edge on either side, `fill` where the window ends,
    differentiable. Every rank of the model group must call it."""
    return _HaloExchange.apply(x, dim, width, fill, mesh)


class _AllGatherTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.n_model)]
        dist.all_gather(parts, x, group=mesh.model_group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.mesh.model_group)
        chunk = g.shape[ctx.dim] // ctx.mesh.n_model
        return g.narrow(ctx.dim, ctx.mesh.model_rank * chunk, chunk), None, None


def all_gather_time(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model group's time chunks of x concatenated along `dim` in time
    order, differentiable."""
    return _AllGatherTime.apply(x, dim, mesh)
