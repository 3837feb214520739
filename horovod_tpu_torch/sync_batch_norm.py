"""Cross-rank synchronized batch normalization.

The port of ``horovod_tpu/torch/sync_batch_norm.py``, over the port's own
allreduce († ``horovod/torch/sync_batch_norm.py``): a drop-in
``_BatchNorm`` replacement whose batch statistics are computed over the
GLOBAL batch (all ranks), for
the small-per-rank-batch regime where per-rank statistics destabilize
training.  Upstream gathers count/mean/var with allgather and reduces
gradient terms with allreduce on NCCL; here both rounds are single
``allreduce(Sum)`` calls through the engine (sum / sum-of-squares /
count forward, sum_dy / sum_dy_xhat backward) — statistically identical,
one collective per direction.  The summed count also makes uneven per-rank
batches exact (the reference's count allgather serves the same purpose).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.batchnorm import _BatchNorm

import horovod_tpu_torch as hvd

__all__ = ["SyncBatchNorm"]


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        # Channel axis is dim 1; reduce over batch + spatial dims.
        c = x.shape[1]
        red = [0] + list(range(2, x.dim()))
        local_count = x.numel() / c

        # One fused allreduce for [sum, sumsq, count] († upstream's
        # count/mean/var allgather round, collapsed).  Summing the counts
        # keeps uneven per-rank batches exact.
        stats = torch.cat([x.sum(red), (x * x).sum(red),
                           x.new_tensor([local_count])])
        stats = hvd.allreduce(stats, op=hvd.Sum,
                              name="sync_batch_norm.fwd")
        total = stats[2 * c]
        mean = stats[:c] / total
        var = stats[c:2 * c] / total - mean * mean

        shape = [1, c] + [1] * (x.dim() - 2)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        y = xhat * weight.view(shape) + bias.view(shape)

        ctx.save_for_backward(xhat, weight, invstd)
        ctx.total = float(total)
        ctx.red = red
        ctx.mark_non_differentiable(mean, var, total)
        return y, mean, var, total

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dtotal):
        xhat, weight, invstd = ctx.saved_tensors
        c = xhat.shape[1]
        shape = [1, c] + [1] * (xhat.dim() - 2)

        sum_dy = dy.sum(ctx.red)
        sum_dy_xhat = (dy * xhat).sum(ctx.red)
        # † backward allreduce round: dx needs the GLOBAL reduction terms
        # (the normalization statistics were global).
        reduced = hvd.allreduce(torch.cat([sum_dy, sum_dy_xhat]),
                                op=hvd.Sum, name="sync_batch_norm.bwd")
        g_sum_dy, g_sum_dy_xhat = reduced[:c], reduced[c:]

        n = ctx.total
        dx = (weight.view(shape) * invstd.view(shape)) * (
            dy - (g_sum_dy.view(shape) + xhat * g_sum_dy_xhat.view(shape)) / n)
        # weight/bias grads stay LOCAL († upstream): DistributedOptimizer
        # averages them afterwards exactly like every other parameter.
        return dx, sum_dy_xhat, sum_dy, None


class SyncBatchNorm(_BatchNorm):
    """† ``hvd.SyncBatchNorm``: BatchNorm1d/2d/3d with global statistics.

    Running statistics follow stock ``nn.BatchNorm`` semantics, including
    ``momentum=None`` (cumulative moving average) and
    ``track_running_stats=False`` (always normalize with batch stats).
    Eval mode and single-rank jobs fall back to the stock kernel.
    """

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(
                f"expected at least 2D input, got {x.dim()}D")

    def forward(self, x):
        self._check_input_dim(x)

        # Stock _BatchNorm bookkeeping: exponential factor, with
        # momentum=None meaning cumulative average 1/num_batches_tracked.
        eaf = 0.0 if self.momentum is None else self.momentum
        if self.training and self.track_running_stats \
                and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                eaf = 1.0 / float(self.num_batches_tracked)

        if not self.training or hvd.size() == 1:
            # Stock semantics verbatim: in eval without running stats,
            # normalize with batch statistics (bn_training).
            bn_training = self.training or (self.running_mean is None
                                            and self.running_var is None)
            track = not self.training or self.track_running_stats
            return F.batch_norm(
                x,
                self.running_mean if track else None,
                self.running_var if track else None,
                self.weight, self.bias, bn_training, eaf, self.eps)

        weight = self.weight if self.affine else x.new_ones(x.shape[1])
        bias = self.bias if self.affine else x.new_zeros(x.shape[1])
        y, mean, var, total = _SyncBatchNormFn.apply(x, weight, bias,
                                                     self.eps)

        if self.track_running_stats and self.running_mean is not None:
            with torch.no_grad():
                n = float(total)  # true global count (uneven-batch exact)
                unbiased = var * n / max(n - 1.0, 1.0)
                self.running_mean.mul_(1 - eaf).add_(mean, alpha=eaf)
                self.running_var.mul_(1 - eaf).add_(unbiased, alpha=eaf)
        return y
