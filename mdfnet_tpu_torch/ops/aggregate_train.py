"""Train-mode fused warp + aggregate (K9): port of
``mdfnet_tpu/ops/pallas/aggregate_vjp.py`` (``rowsweep_aggregate_train``,
line 81), C/G == 2.

Forward (two kernels, ``ops/cuda/aggregate_kernel.py``):

1. the stats kernel: per source view, (sum s, sum s^2) of DepthWeight's
   pre-BN field s = k0 . sim over the whole batch's (B, D, H, W) plane
   sweep, in f64. Train-mode BN normalises s with these batch statistics
   (reference net/unit/homoaggregate.py:17-19), which the aggregation pass
   must know before it runs. From them: the mean, the biased variance, the
   unbiased one and the per-view affine (``aggregate_vjp.py:55-62``);
2. the aggregate kernel (K1) with that per-view affine, which also returns
   the weight sum.

Backward: the closed form of ``aggregate_vjp.py:99-170``. Every view is
re-warped in one launch of the sample kernel (K6) at the coordinates of
``ops/warp.py:sweep_sample_coords``, in f32 as K1 interpolates; the
similarity, DepthWeight and batch-statistics BN chain runs in f32 PyTorch
ops (JAX leaves it to XLA), its scalar sums in f64; the features'
cotangents go back through one launch of the splat kernel (K7). The volume
gradient uses the forward's own volume and weight sum. Projections and
hypotheses get no gradient (the reference computes them under no_grad).

The statistics output carries no gradient: like JAX's backward, which
drops its cotangent (``aggregate_vjp.py:102``), the port treats the running
statistics as a side output of the step. The reference's BN does not
differentiate through its running statistics either.
"""
from __future__ import annotations

import torch

from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import (
    rowsweep_aggregate_with_wsum, rowsweep_stats)
from mdfnet_tpu_torch.ops.cuda.splat_kernel import splat_2d
from mdfnet_tpu_torch.ops.cuda.warp_kernel import sample_2d
from mdfnet_tpu_torch.ops.warp import sweep_sample_coords
from mdfnet_tpu_torch.utils import tracing

EPS = 1e-5   # DepthWeight's BatchNorm epsilon


def _sum64(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.float64)


def bn_backward(d_shat: torch.Tensor, s_hat: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    """Batch-statistics BatchNorm backward of one view's field: the
    cotangent of s from that of s_hat = (s - mu) r, with the means over
    ALL of the field (its f64 sums keep the cancellation exact)."""
    n = d_shat.numel()
    m1 = (_sum64(d_shat) / n).float()
    m2 = (_sum64(d_shat * s_hat) / n).float()
    return r * (d_shat - m1 - s_hat * m2)


class _RowsweepAggregateTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, src_diffs, ref_diffs, src_projs, ref_proj, depth_hypos,
                k0, gamma, beta, k1, b1, plain):
        b, _, h, w, _ = src_diffs.shape
        n = b * depth_hypos.shape[1] * h * w
        sums = rowsweep_stats(src_diffs, ref_diffs, src_projs, ref_proj,
                              depth_hypos, k0, plain=plain)    # (S, 2) f64
        mu = sums[:, 0] / n
        var_b = (sums[:, 1] / n - mu * mu).clamp_min(0.0)      # biased
        var_u = var_b * (n / max(n - 1, 1))
        mu, var_b = mu.float(), var_b.float()
        bn_s = gamma.float() * torch.rsqrt(var_b + EPS)        # (S,)
        bn_o = beta.float() - mu * bn_s
        vol, wsum = rowsweep_aggregate_with_wsum(
            src_diffs, ref_diffs, src_projs, ref_proj, depth_hypos, k0, bn_s,
            bn_o, k1, b1, plain=plain)
        ctx.save_for_backward(src_diffs, ref_diffs, src_projs, ref_proj,
                              depth_hypos, k0, gamma, beta, k1, b1, vol,
                              wsum, mu, var_b)
        ctx.plain = plain
        stats = torch.stack([mu, var_u.float()], dim=1)
        ctx.mark_non_differentiable(stats)
        return vol, stats

    @staticmethod
    @tracing.spanned("vjp/aggregate")
    def backward(ctx, d_vol, _d_stats):
        (src, ref, src_projs, ref_proj, hypos, k0, gamma, beta, k1, b1, vol,
         wsum, mu, var_b) = ctx.saved_tensors
        b, n_src, h, w, g = src.shape
        d = hypos.shape[1]
        d_vol = d_vol.float()
        k0f = k0.float().reshape(g)
        gf, bf = gamma.float().reshape(()), beta.float().reshape(())
        k1f, b1f = k1.float().reshape(()), b1.float().reshape(())
        r = torch.rsqrt(var_b + EPS)                               # (S,)
        q = torch.sigmoid(ref.float())[:, None]                    # (B,1,H,W,G)
        winv = 1.0 / wsum[..., None]                               # (B,D,H,W,1)
        x, y = sweep_sample_coords(src_projs, ref_proj, hypos, h, w)
        warped = sample_2d(src.float().reshape(b * n_src, h, w, g), x, y,
                           plain=ctx.plain).reshape(b, n_src, d, h, w, g)
        d_warped = torch.empty_like(warped)
        d_q = torch.zeros_like(q[:, 0])
        zero = torch.zeros((), dtype=torch.float64, device=src.device)
        d_k0 = torch.zeros(g, dtype=torch.float64, device=src.device)
        d_gamma = d_beta = d_k1 = d_b1 = zero
        for v in range(n_src):
            p = torch.sigmoid(warped[:, v])                        # (B,D,H,W,G)
            sim = p * q + (1.0 - p) * (1.0 - q)
            s_hat = ((sim * k0f).sum(-1) - mu[v]) * r[v]           # (B,D,H,W)
            a = s_hat * gf + bf
            hrelu = torch.relu(a)
            wgt = torch.sigmoid(hrelu * k1f + b1f)
            d_w = (d_vol * (sim - vol)).sum(-1) * winv[..., 0]
            d_sim = d_vol * (wgt[..., None] * winv)
            d_lin = d_w * (wgt * (1.0 - wgt))
            d_k1 = d_k1 + _sum64(d_lin * hrelu)
            d_b1 = d_b1 + _sum64(d_lin)
            d_a = (d_lin * k1f) * (a > 0.0)
            d_gamma = d_gamma + _sum64(d_a * s_hat)
            d_beta = d_beta + _sum64(d_a)
            d_s = bn_backward(d_a * gf, s_hat, r[v])
            d_k0 = d_k0 + (sim * d_s[..., None]).sum(dim=(0, 1, 2, 3),
                                                     dtype=torch.float64)
            d_sim = d_sim + d_s[..., None] * k0f
            d_q += ((2.0 * p - 1.0) * d_sim).sum(1)
            d_warped[:, v] = (p * (1.0 - p)) * (2.0 * q - 1.0) * d_sim
        d_src = splat_2d(d_warped.reshape(b * n_src, d, h, w, g), x, y, h, w,
                         plain=ctx.plain)
        q0 = q[:, 0]
        d_ref = d_q * (q0 * (1.0 - q0))          # through q = sigmoid(ref)
        return (d_src.reshape(src.shape).to(src.dtype), d_ref.to(ref.dtype),
                None, None, None, d_k0.to(k0.dtype).reshape(k0.shape),
                d_gamma.to(gamma.dtype).reshape(gamma.shape),
                d_beta.to(beta.dtype).reshape(beta.shape),
                d_k1.to(k1.dtype).reshape(k1.shape),
                d_b1.to(b1.dtype).reshape(b1.shape), None)


def rowsweep_aggregate_train(src_diffs: torch.Tensor, ref_diffs: torch.Tensor,
                             src_projs: torch.Tensor, ref_proj: torch.Tensor,
                             depth_hypos: torch.Tensor, k0: torch.Tensor,
                             gamma: torch.Tensor, beta: torch.Tensor,
                             k1: torch.Tensor, b1: torch.Tensor, *,
                             plain: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The train-mode fused aggregate, differentiable in the features and in
    DepthWeight's parameters.

    Args:
        src_diffs: (B, S, H, W, G) source pair differences, bf16 or f32,
            contiguous.
        ref_diffs: (B, H, W, G) reference pair differences, same dtype; the
            kernels take q = sigmoid(ref_diffs), and the gradient returned
            for ref_diffs is q's chained through that sigmoid.
        src_projs: (B, S, 4, 4); ref_proj: (B, 4, 4).
        depth_hypos: (B, D, H, W) or (B, D, 1, 1).
        k0: (G,) DepthWeight conv0 weights; gamma, beta: its BN's weight and
            bias; k1, b1: its conv1 weight and bias.
        plain: every kernel's plain PyTorch version (also on the card).
    Returns:
        (volume (B, D, H, W, G) f32, stats (S, 2) f32 [batch mean, unbiased
        batch variance] per source view, for the BN running statistics;
        stats carries no gradient).
    """
    return _RowsweepAggregateTrain.apply(src_diffs, ref_diffs, src_projs,
                                         ref_proj, depth_hypos, k0, gamma,
                                         beta, k1, b1, plain)
