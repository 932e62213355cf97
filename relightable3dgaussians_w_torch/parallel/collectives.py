"""Differentiable collectives over a `torch.distributed` process group.

Each forward is one collective; each backward is JAX's transpose of it, so a
loss that crosses ranks has the gradients JAX's shard_map gives:

* `all_reduce` (psum)          <-> all_reduce of the cotangents;
* `all_gather` (tiled, dim 0)  <-> each rank sums, over all ranks, the
  cotangents of its own slice (a reduce-scatter, written as an all_reduce and
  a slice: both torch versions the port runs on have it, and it is one code
  path for gloo and NCCL);
* `all_to_all` (dim 0 blocks)  <-> the all_to_all back.

They are `torch.autograd.Function`s of their own rather than
`torch.distributed.nn.functional`, whose backward differs between backends and
versions. With a group of one rank each is the identity, and so is its
backward: no collective is issued.

gloo moves CUDA tensors for all_reduce only; it refuses them for all_gather
and all_to_all. For a gloo group (the CPU tests, and ranks that share one card)
those two stage a CUDA tensor through a host buffer; `HOST_STAGED` names the
ops that did. NCCL never stages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

HOST_STAGED: set[str] = set()   # ops that staged a CUDA tensor through the host (gloo)


def _staged(x: torch.Tensor, group, op: str) -> bool:
    """True where gloo would refuse `x` for `op`: the op then runs on a host copy."""
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        HOST_STAGED.add(op)
        return True
    return False


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce of a tensor that carries no gradient; returns it."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.contiguous()
    if _staged(src, group, "all_gather"):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(x.device)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    src = x.contiguous()
    if _staged(src, group, "all_to_all"):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group) * ctx.rows
        return g[r:r + ctx.rows], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the group's ranks (psum); differentiable."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` concatenated along dim 0 in rank order (JAX's tiled
    all_gather); differentiable."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...] with n = rows for each rank in rank order: block j goes to
    rank j, and the result holds the blocks received, in the senders' rank
    order (JAX's all_to_all with split and concat axis 0, tiled);
    differentiable."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)
