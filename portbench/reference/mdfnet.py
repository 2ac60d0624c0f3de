"""Plain float32 PyTorch reference of MDF-Net (zongh5a/MDF-Net, net/core.py
and net/unit/*), frozen with the benchmark.

It is the yardstick that decides ``correct``: the port's eval forward and
train step are compared with this model on the same weights and inputs. It
imports nothing of the port and of the JAX package, and runs standard
``torch.nn`` layers on NCHW / NCDHW tensors: convolutions, transposed
convolutions, BatchNorm, ``grid_sample`` for the plane-sweep warp,
a fixed 0.75 / 0.25 stencil for the 2x upsamples. The submodules carry the reference
``state_dict`` names (``Backbone``, ``Homoaggre``, ``Regular``, ``Refine``),
so one state dict loads into this model and into the port.

``set_operand_dtype(dtype)`` rounds the operands (input and weight) of
every convolution that the configuration runs in its compute dtype to
``dtype`` with a per-tensor scale before the float32 convolution, and the
gradients that reach them in the backward: the control of the comparison
(float8 e4m3 for a bfloat16 configuration). The aggregate's visibility net
(DepthWeight) runs in float32 in every configuration and is never rounded.

Departures from the reference code, each also made by the port: the
aggregate's per-source loop is the same arithmetic as the reference's
batched one; stage depths are returned for the comparison.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


def _scaled(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` scaled so that its largest magnitude is float8's largest,
    rounded to ``dtype`` and scaled back: float8 with a per-tensor scale,
    as float8 training stores its operands."""
    amax = t.abs().amax().clamp(min=torch.finfo(torch.float32).tiny)
    scale = E4M3_MAX / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Round(torch.autograd.Function):
    """The operand rounded in the forward, its gradient in the backward."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return _scaled(t, dtype)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, ctx.dtype), None


def round_operand(t: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``t`` in ``dtype`` with a per-tensor scale (and so its gradient), or
    ``t`` itself where ``dtype`` is None."""
    return t if dtype is None else _Round.apply(t, dtype)


class Conv2d(nn.Conv2d):
    operand: torch.dtype | None = None

    def forward(self, x):
        return self._conv_forward(round_operand(x, self.operand),
                                  round_operand(self.weight, self.operand),
                                  self.bias)


class Conv3d(nn.Conv3d):
    operand: torch.dtype | None = None

    def forward(self, x):
        return self._conv_forward(round_operand(x, self.operand),
                                  round_operand(self.weight, self.operand),
                                  self.bias)


class ConvTranspose3d(nn.ConvTranspose3d):
    """k3, stride 2, padding 1, output_padding 1, no bias."""
    operand: torch.dtype | None = None

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, stride=2, padding=1, output_padding=1,
                         bias=False)

    def forward(self, x):
        return F.conv_transpose3d(
            round_operand(x, self.operand),
            round_operand(self.weight, self.operand), None, self.stride,
            self.padding, self.output_padding)


def cbr(cin: int, cout: int, k: int = 3, stride: int = 1,
        ndim: int = 2) -> nn.Module:
    conv = (Conv2d if ndim == 2 else Conv3d)(cin, cout, k, stride,
                                             (k - 1) // 2, bias=False)
    return _CBR(conv, (nn.BatchNorm2d if ndim == 2 else nn.BatchNorm3d)(cout))


class _CBR(nn.Module):
    """Conv + BN + ReLU: keys ``conv.weight``, ``bn.*``."""

    def __init__(self, conv: nn.Module, bn: nn.Module):
        super().__init__()
        self.conv, self.bn = conv, bn

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _up_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """2x along ``axis`` with half-pixel centres, edges replicated: output
    2k is 0.75 x[k] + 0.25 x[k-1], output 2k+1 is 0.75 x[k] + 0.25 x[k+1].
    (``F.interpolate`` gives the same, but multiplies an edge's neighbour
    by a weight of 0, which turns an infinite curve width into NaN.)"""
    axis %= x.dim()
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)],
                    axis)
    out = torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt],
                      axis + 1)
    return out.flatten(axis, axis + 1)


def up2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample over the trailing two axes, half-pixel centres
    (``align_corners=False``)."""
    return _up_axis(_up_axis(x, -1), -2)


class FPN4Scales(nn.Module):
    def __init__(self, chs=(8, 16, 32, 64)):
        super().__init__()
        c0, c1, c2, c3 = chs
        self.conv01 = nn.Sequential(cbr(3, c0), cbr(c0, c0))
        self.conv12 = nn.Sequential(cbr(c0, c1, 5, 2), cbr(c1, c1),
                                    cbr(c1, c1))
        self.conv23 = nn.Sequential(cbr(c1, c2, 5, 2), cbr(c2, c2),
                                    cbr(c2, c2))
        self.conv34 = nn.Sequential(cbr(c2, c3, 5, 2), cbr(c3, c3),
                                    cbr(c3, c3))
        self.lat2 = Conv2d(c1, c3, 1, bias=True)
        self.lat3 = Conv2d(c2, c3, 1, bias=True)
        self.out2 = Conv2d(c3, c1, 1, bias=False)
        self.out3 = Conv2d(c3, c2, 1, bias=False)
        self.out4 = Conv2d(c3, c3, 1, bias=False)

    def forward(self, x):
        """x (N, 3, H, W) -> (y4 1/8, y3 1/4, y2 1/2), coarsest first."""
        x2 = self.conv12(self.conv01(x))
        x3 = self.conv23(x2)
        x4 = self.conv34(x3)
        y4 = self.out4(x4)
        x3 = up2(x4) + self.lat3(x3)
        y3 = self.out3(x3)
        x2 = up2(x3) + self.lat2(x2)
        return y4, y3, self.out2(x2)


def plane_sweep(src: torch.Tensor, src_proj: torch.Tensor,
                ref_proj: torch.Tensor, hypos: torch.Tensor) -> torch.Tensor:
    """Warp source features (B, C, H, W) onto the reference camera's planes
    at depths ``hypos`` (B, D, H, W) or (B, D, 1, 1): (B, C, D, H, W).
    Bilinear, zeros outside, in the reference's mixed convention
    (coordinates normalised by (W - 1) / 2, ``align_corners=False``)."""
    b, c, h, w = src.shape
    d = hypos.shape[1]
    rel = src_proj @ torch.linalg.inv(ref_proj)
    rot, trans = rel[:, :3, :3], rel[:, :3, 3:4]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=src.device),
        torch.arange(w, dtype=torch.float32, device=src.device),
        indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones_like(xs).reshape(-1)])
    xyz = (rot @ grid)[:, :, None, :] * hypos.reshape(b, 1, d, -1) \
        + trans[:, :, :, None]                       # (B, 3, D, H*W)
    gx = xyz[:, 0] / xyz[:, 2] / ((w - 1) / 2) - 1
    gy = xyz[:, 1] / xyz[:, 2] / ((h - 1) / 2) - 1
    coords = torch.stack([gx, gy], -1).reshape(b, d * h, w, 2)
    out = F.grid_sample(src, coords, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(b, c, d, h, w)


class _ConvBN(nn.Module):
    def __init__(self, g: int):
        super().__init__()
        self.conv = nn.Conv3d(g, 1, 1, bias=False)
        self.bn = nn.BatchNorm3d(1)


class VectorAggregate(nn.Module):
    """Group-wise vector similarity over the sources, weighted by the
    visibility net (reference net/unit/homoaggregate.py:8-46)."""

    def __init__(self, ngroups: int):
        super().__init__()
        self.ngroups = ngroups
        self.depth_weight = nn.Sequential(_ConvBN(ngroups),
                                          nn.Conv3d(1, 1, 1, bias=True))

    def _unit(self, x):
        """Softmax over each group's channels: (B, G, C/G, ...)."""
        return torch.softmax(x.reshape((x.shape[0], self.ngroups, -1)
                                       + x.shape[2:]), 2)

    def forward(self, feats, ref_proj, src_projs, hypos):
        """feats (B, V, C, h, w) -> (B, G, D, h, w) cost volume."""
        ref = self._unit(feats[:, 0])[:, :, :, None]        # (B,G,c,1,h,w)
        conv_bn, conv1 = self.depth_weight
        vol = wsum = 0.0
        for s in range(feats.shape[1] - 1):
            warped = plane_sweep(feats[:, s + 1], src_projs[:, s], ref_proj,
                                 hypos)
            sim = (self._unit(warped) * ref).sum(2)           # (B,G,D,h,w)
            wgt = torch.sigmoid(conv1(F.relu(conv_bn.bn(conv_bn.conv(sim)))))
            vol = vol + wgt * sim
            wsum = wsum + wgt
        return vol / wsum


def _up_block(x, trconv, bn, skip):
    """ConvTranspose3d + BN + ReLU, cropped to the skip, plus the skip."""
    y = F.relu(bn(trconv(x)))
    return y[:, :, :skip.shape[2], :skip.shape[3], :skip.shape[4]] + skip


class RegularNet3Scales(nn.Module):
    def __init__(self, cin: int, c: int = 16):
        super().__init__()
        c0, c1, c2 = c, 2 * c, 4 * c
        self.conv01 = nn.Sequential(cbr(cin, c0, ndim=3), cbr(c0, c0, ndim=3))
        self.conv12 = nn.Sequential(cbr(c0, c1, 3, 2, 3), cbr(c1, c1, ndim=3),
                                    cbr(c1, c1, ndim=3))
        self.conv232 = nn.Sequential(cbr(c1, c2, 3, 2, 3), cbr(c2, c2, ndim=3),
                                     cbr(c2, c2, ndim=3),
                                     ConvTranspose3d(c2, c1),
                                     nn.BatchNorm3d(c1), nn.ReLU())
        self.conv10 = nn.Sequential(ConvTranspose3d(c1, c0),
                                    nn.BatchNorm3d(c0), nn.ReLU())
        self.prob = Conv3d(c0, 1, 3, 1, 1, bias=False)

    def forward(self, x):
        """x (B, G, D, h, w) -> (B, D, h, w) probabilities."""
        skip0 = self.conv01(x)
        skip1 = self.conv12(skip0)
        v = self.conv232[:3](skip1)
        v = _up_block(v, self.conv232[3], self.conv232[4], skip1)
        v = _up_block(v, self.conv10[0], self.conv10[1], skip0)
        return torch.softmax(self.prob(v)[:, 0], 1)


class RegularNet4Scales(nn.Module):
    def __init__(self, cin: int, c: int = 8):
        super().__init__()
        c0, c1, c2, c3 = c, 2 * c, 4 * c, 8 * c
        self.conv01 = cbr(cin, c0, ndim=3)
        self.conv12 = nn.Sequential(cbr(c0, c1, 3, 2, 3), cbr(c1, c1, ndim=3))
        self.conv23 = nn.Sequential(cbr(c1, c2, 3, 2, 3), cbr(c2, c2, ndim=3))
        self.conv343 = nn.Sequential(cbr(c2, c3, 3, 2, 3), cbr(c3, c3, ndim=3),
                                     ConvTranspose3d(c3, c2),
                                     nn.BatchNorm3d(c2), nn.ReLU())
        self.trconv32 = nn.Sequential(ConvTranspose3d(c2, c1),
                                      nn.BatchNorm3d(c1), nn.ReLU())
        self.trconv21 = nn.Sequential(ConvTranspose3d(c1, c0),
                                      nn.BatchNorm3d(c0), nn.ReLU())
        self.prob = Conv3d(c0, 1, 3, 1, 1, bias=False)

    def forward(self, x):
        x1 = self.conv01(x)
        x2 = self.conv12(x1)
        x3 = self.conv23(x2)
        v = self.conv343[:2](x3)
        v = _up_block(v, self.conv343[2], self.conv343[3], x3)
        v = _up_block(v, self.trconv32[0], self.trconv32[1], x2)
        v = _up_block(v, self.trconv21[0], self.trconv21[1], x1)
        return torch.softmax(self.prob(v)[:, 0], 1)


class Res(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(c, c, 3, 1, 1, bias=False), nn.ReLU(),
                                  Conv2d(c, c, 3, 1, 1, bias=False))

    def forward(self, x):
        return x + 0.1 * self.conv(x)


class RefineNet2(nn.Module):
    """Half-res depth to full res by PixelShuffle (reference
    net/unit/refine.py:8-46)."""

    def __init__(self, c: int = 8, nres: int = 3):
        super().__init__()
        self.conv0 = Conv2d(1, c, 3, 1, 1, bias=False)
        self.ress = nn.ModuleList(Res(c) for _ in range(nres))
        self.conv1 = Conv2d(c, c, 3, 1, 1, bias=False)
        self.conv2 = nn.Sequential(Conv2d(c, 4 * c, 3, 1, 1, bias=False),
                                   nn.PixelShuffle(2),
                                   Conv2d(c, 1, 3, 1, 1, bias=False))

    def forward(self, depth, depth_range):
        dmin = depth_range[:, 0].reshape(-1, 1, 1)
        dmax = depth_range[:, 1].reshape(-1, 1, 1)
        x = ((depth.detach() - dmin) / (dmax - dmin))[:, None]
        v = skip = self.conv0(x)
        for res in self.ress:
            v = res(v)
        out = self.conv2(skip + self.conv1(v))[:, 0]
        return dmin + out * (dmax - dmin)


# ------------------------------------------------------------ hypotheses

_FLOOR = 1e-40


def uniform_hypotheses(depth_range, d):
    steps = torch.arange(d, dtype=torch.float32, device=depth_range.device)
    dmin, dmax = depth_range[:, 0], depth_range[:, 1]
    h = dmin[:, None] + steps[None] * ((dmax - dmin) / (d - 1))[:, None]
    return h[:, :, None, None]


def _width_laplace(depth, prob, hypos):
    y = torch.log(prob.clamp(min=_FLOOR))
    x = (hypos - depth[:, None]).abs()
    return 1.0 / ((x * y).sum(1) / (x * x).sum(1)).abs()


def _width_gauss1(depth, prob, hypos):
    """|-1/b0| of the least-squares parabola log p = b0 x^2 + b1 x + b2."""
    z = torch.log(prob.clamp(min=_FLOOR))
    x = hypos.expand_as(z)
    n = float(z.shape[1])
    s4, s3, s2, s1 = ((x ** k).sum(1) for k in (4, 3, 2, 1))
    v0, v1, v2 = (x * x * z).sum(1), (x * z).sum(1), z.sum(1)
    det = s4 * (s2 * n - s1 * s1) - s3 * (s3 * n - s1 * s2) \
        + s2 * (s3 * s1 - s2 * s2)
    det0 = v0 * (s2 * n - s1 * s1) - s3 * (v1 * n - s1 * v2) \
        + s2 * (v1 * s1 - s2 * v2)
    return (-1.0 / (det0 / det)).abs()


_WIDTHS = {"gauss1": _width_gauss1, "laplace": _width_laplace}


@torch.no_grad()
def refined_hypotheses(depth, depth_range, prob, hypos, d, curve, thresh):
    """The MDF step (reference net/unit/depthhypos.py): a curve fitted to
    each pixel's posterior gives the next stage's search radius."""
    dmin, dmax = depth_range[:, 0], depth_range[:, 1]
    s = up2(_WIDTHS[curve](depth, prob, hypos))
    depth = up2(depth)
    log_t = float(torch.log(torch.tensor(thresh, dtype=torch.float32)))
    r = (-s * log_t).sqrt() if curve == "gauss1" else (s * log_t).abs()
    r = r.clamp(min=1e-6).minimum((dmax.max() - dmin.min()) / 2)
    r = r.minimum(((dmax - dmin) * 0.2)[:, None, None])
    steps = torch.arange(d, dtype=torch.float32,
                         device=depth.device).reshape(1, d, 1, 1)
    h = (depth - 0.5 * r)[:, None] + (r / (d - 1))[:, None] * steps
    return h.maximum(dmin.reshape(-1, 1, 1, 1)).minimum(
        dmax.reshape(-1, 1, 1, 1))


def confidence(prob):
    """Mass of the 4 bins [i-1, i+2] around the floored soft-argmax index."""
    b, d, h, w = prob.shape
    padded = F.pad(prob, (0, 0, 0, 0, 1, 2))
    window = sum(padded[:, k:k + d] for k in range(4))
    index = torch.arange(d, dtype=prob.dtype, device=prob.device)
    i = (prob * index.reshape(1, d, 1, 1)).sum(1).to(torch.int64)
    return torch.gather(window, 1, i.clamp(0, d - 1)[:, None])[:, 0]


# ------------------------------------------------------------ the network

class MDFNet(nn.Module):
    """CoreNet of the reference with the default topology: the vector
    aggregate, uniform / gauss1 / laplace hypotheses, RefineNet2."""

    def __init__(self, chs=(8, 16, 32, 64), ndepths=(48, 24, 8),
                 ngroups=(32, 16, 8), curve_classes=(None, "gauss1", "laplace"),
                 prob_threshs=(0.0, 0.95, 1e-5)):
        super().__init__()
        self.ndepths, self.curves = tuple(ndepths), tuple(curve_classes)
        self.threshs = tuple(prob_threshs)
        self.Backbone = FPN4Scales(tuple(chs))
        self.Homoaggre = nn.ModuleList(VectorAggregate(g) for g in ngroups)
        self.Regular = nn.ModuleList(
            [RegularNet3Scales(ngroups[0], 16)]
            + [RegularNet4Scales(g, 8) for g in ngroups[1:]])
        self.Refine = RefineNet2()

    def set_operand_dtype(self, dtype: torch.dtype | None) -> None:
        """Round every compute-dtype convolution's operands to ``dtype``."""
        for m in self.modules():
            if isinstance(m, (Conv2d, Conv3d, ConvTranspose3d)):
                m.operand = dtype

    def forward(self, imgs, extrinsics, intrinsics, depth_range,
                plain: bool = False, train: bool = False) -> dict:
        """The port's calling convention: imgs (B, V, H, W, 3) channels-last,
        extrinsics (B, V, 4, 4), intrinsics (B, V, 3, 3), depth_range (B, 2).
        ``plain`` is accepted and ignored. Returns, in eval, the full-res
        depth and confidence (B, H, W) and ``stage_depths``; in training,
        ``depth``: the four depths coarse to fine. Eval runs under
        ``no_grad``."""
        ctx = contextlib.nullcontext() if train else torch.no_grad()
        with ctx:
            return self._forward(imgs, extrinsics, intrinsics, depth_range,
                                 train)

    def _forward(self, imgs, extrinsics, intrinsics, depth_range, train):
        b, v = imgs.shape[:2]
        x = imgs.float().permute(0, 1, 4, 2, 3)                # (B,V,3,H,W)
        depth_range = depth_range.float()
        if train:     # one backbone call per view: per-view BN statistics
            per_view = [self.Backbone(x[:, i]) for i in range(v)]
            feats = [torch.stack(f, 1) for f in zip(*per_view)]
        else:
            feats = [f.reshape((b, v) + f.shape[1:])
                     for f in self.Backbone(x.reshape((b * v,) + x.shape[2:]))]
        depths, depth, prob, hypos = [], None, None, None
        for s, d in enumerate(self.ndepths):
            scale = torch.tensor([0.5 ** (3 - s), 0.5 ** (3 - s), 1.0],
                                 device=imgs.device).reshape(3, 1)
            proj = torch.cat([(intrinsics.float() * scale)
                              @ extrinsics.float()[..., :3, :4],
                              extrinsics.float()[..., 3:4, :4]], -2)
            if self.curves[s] is None:
                hypos = uniform_hypotheses(depth_range, d)
            else:
                hypos = refined_hypotheses(depth, depth_range, prob, hypos, d,
                                           self.curves[s], self.threshs[s])
            cost = self.Homoaggre[s](feats[s], proj[:, 0], proj[:, 1:], hypos)
            prob = self.Regular[s](cost)
            depth = (prob * hypos).sum(1)
            depths.append(depth)
        final = self.Refine(depth, depth_range)
        if train:
            return {"depth": depths + [final]}
        conf = confidence(prob)
        conf = conf.repeat_interleave(2, -1).repeat_interleave(2, -2)
        return {"depth": final, "confidence": conf, "stage_depths": depths}


def smooth_l1(pred, target):
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def depth_loss(depths, gt_pyramid, depth_range):
    """Sum over the 4 scales of the smooth-L1 error averaged over the pixels
    whose ground truth exceeds the item's minimum depth (reference
    net/loss.py:6-27; an empty mask counts 0)."""
    dmin = depth_range[:, 0].float().reshape(-1, 1, 1)
    total = 0.0
    for depth, key in zip(depths, ("3", "2", "1", "0")):
        gt = gt_pyramid[key].float()
        mask = (gt > dmin).float()
        total = total + (smooth_l1(depth.float(), gt) * mask).sum() \
            / mask.sum().clamp(min=1.0)
    return total


def adam(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam(lr, betas (0.9, 0.999), eps 1e-8), the reference's optimizer."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, foreach=False)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               batch: dict, plain: bool = False) -> torch.Tensor:
    """Forward, loss, backward, Adam; the loss before the update."""
    optimizer.zero_grad(set_to_none=True)
    out = model(batch["imgs"], batch["extrinsics"], batch["intrinsics"],
                batch["depth_range"], train=True)
    loss = depth_loss(out["depth"], batch["ref_depths"], batch["depth_range"])
    loss.backward()
    optimizer.step()
    return loss.detach()


@contextlib.contextmanager
def exact_f32():
    """Full float32 convolutions and matmuls (no TF32) inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags[:2]
        torch.set_float32_matmul_precision(flags[2])
