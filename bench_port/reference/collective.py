"""The one collective the references need, written out with plain
``torch.distributed`` (nothing of the program): a sum over the ranks whose
gradient is the sum of the ranks' gradients.

Each rank of a data-parallel reference step holds its own rows; where a
number is of the whole batch (batch norm's means, the positive count) the
ranks sum their parts. Every rank calls it at the same point of the same
computation, the backward's recomputation included, so that the
collectives pair up.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Sum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, differentiable."""
    return _Sum.apply(t, group)
