"""Rank programs of the spatial-sharding tests (tests/test_torch_spatial*.py),
started by ``mdfnet_tpu_torch.parallel.spawn_ranks`` on the CPU over gloo.
This module imports nothing of JAX: a spawned rank imports it by name.

A rank runs its band of each case under ``halo.spatial_sharding`` and rank
0 writes the all-gathered results to ``<out>/rank0.pt``. :func:`op_cases`
builds the hooked ops with seeded weights, the same in the test and in
every rank. Collectives time out after ``COLLECTIVE_TIMEOUT`` seconds, so a
rank waiting for a dead peer fails rather than hangs.
"""
import torch

from mdfnet_tpu_torch.config import ModelConfig
from mdfnet_tpu_torch.models.aggregate import VectorAggregate
from mdfnet_tpu_torch.models.backbone import FPN4Scales, banded_chain
from mdfnet_tpu_torch.models.layers import (ConvBNReLU, TrConvBNReLU3D,
                                            init_parameters)
from mdfnet_tpu_torch.models.refine import RefineNet2
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.models.regularize import ProbConv
from mdfnet_tpu_torch.ops.sample import resize_bilinear_2x, upsample_2x_nhwc
from mdfnet_tpu_torch.parallel import (all_gather_rows, halo_exchange,
                                       init_data_parallel,
                                       spatial_eval_forward, spatial_sharding)

COLLECTIVE_TIMEOUT = 60.0


def _join(rank, world, init_method):
    torch.set_num_threads(1)
    return init_data_parallel(rank, world, "gloo", init_method,
                              timeout=COLLECTIVE_TIMEOUT)


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    init_parameters(module, gen)
    with torch.no_grad():         # BN statistics away from (0, 1)
        for name, buf in module.named_buffers():
            if "running_mean" in name:
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif "running_var" in name:
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return module.eval()


def _projections(w: int, h: int, n_src: int) -> tuple:
    """(ref_proj, src_projs) of a pinhole rig with sideways baselines."""
    proj = torch.eye(4).repeat(1, n_src + 1, 1, 1)
    proj[:, :, 0, 0] = proj[:, :, 1, 1] = 1.2 * w
    proj[:, :, 0, 2], proj[:, :, 1, 2] = w / 2, h / 2
    shifts = torch.tensor([0.0, -18.0, 22.0, 9.0][:n_src + 1])
    proj[0, :, 0, 3] = shifts * 1.2 * w / 100.0
    proj[0, :, 1, 3] = shifts * 0.5 * h / 100.0
    return proj[:, 0], proj[:, 1:]


def op_cases() -> dict:
    """name -> (op, input, its H axis, the output's H axis): each hooked op
    of the eval forward, on seeded inputs and weights."""
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen)
    cases = {}
    cases["resize_bilinear_2x"] = (resize_bilinear_2x, randn(2, 16, 12),
                                   1, 1)
    cases["upsample_2x_nhwc"] = (upsample_2x_nhwc, randn(2, 16, 12, 8), 1, 1)
    for ndim, shape in ((2, (2, 32, 12, 8)), (3, (1, 4, 16, 8, 8))):
        for k, stride in ((3, 1), (3, 2), (5, 2)):
            if ndim == 3 and k == 5:
                continue
            m = _seeded(ConvBNReLU(8, 16, k, stride, ndim=ndim),
                        10 * ndim + k + stride)
            cases[f"conv{ndim}d k{k} s{stride}"] = (
                lambda x, m=m: m(x), randn(*shape), ndim - 1, ndim - 1)
    tr = _seeded(TrConvBNReLU3D(16, 8), 7)
    skip = randn(1, 4, 16, 8, 8)

    def trconv(x):
        # the skip is the band's rows of a full-height tensor
        from mdfnet_tpu_torch.parallel import current_ctx
        ctx, res = current_ctx(), skip
        if ctx is not None:
            band = skip.shape[2] // ctx.n
            res = skip[:, :, ctx.rank * band:(ctx.rank + 1) * band]
        return tr(x, residual=res)
    cases["trconv3d + skip"] = (trconv, randn(1, 2, 8, 4, 16), 2, 2)
    prob = _seeded(ProbConv(8), 8)
    cases["ProbConv"] = (prob, randn(1, 4, 16, 8, 8), 2, 2)
    fpn = _seeded(FPN4Scales((8, 8, 16, 32)), 9)
    cases["trunk chain"] = (
        lambda x: banded_chain(x, *zip(*(m.folded(x.dtype)
                                         for m in fpn.eval_chains()[0][0])),
                               final_stride=2),
        randn(2, 32, 12, 3), 1, 1)
    ref = _seeded(RefineNet2(), 11)
    cases["refine chain"] = (
        lambda d: ref(d, torch.tensor([[425.0, 935.0]] * 2)),
        425.0 + 510.0 * torch.rand((2, 48, 12), generator=gen), 1, 1)
    for g, c, name in ((8, 16, "K1 (C/G = 2)"), (4, 16, "K6 (C/G = 4)")):
        agg = _seeded(VectorAggregate(g), 12)
        ref_proj, src_projs = _projections(12, 16, 2)
        hyp = torch.linspace(425.0, 935.0, 6).reshape(1, 6, 1, 1)
        cases[name] = (lambda f, agg=agg, rp=ref_proj, sp=src_projs, hy=hyp:
                       agg(f, rp, sp, hy), randn(1, 3, 16, 12, c), 2, 2)
    return cases


def ops_rank(rank, world, init_method, out, fault=False):
    """Every case of :func:`op_cases` on this rank's band, all-gathered;
    ``fault``: the halo exchanges receive zeros instead of rows."""
    group = _join(rank, world, init_method)
    try:
        if fault:
            _zero_halo_rows()
        result = {}
        with torch.no_grad(), spatial_sharding(group):
            for name, (op, x, h_in, h_out) in op_cases().items():
                band = x.shape[h_in] // world
                y = op(x.narrow(h_in, rank * band, band))
                result[name] = all_gather_rows(y, h_out)
            # JAX test_spatial.py:31-56's array, zero and replicate edges
            x = torch.arange(32.0 * 6).reshape(32, 6)[rank * 8:rank * 8 + 8]
            result["halo zero"] = all_gather_rows(
                halo_exchange(x, 0, 2, 2, edge="zero"), 0)
            result["halo replicate"] = all_gather_rows(
                halo_exchange(x, 0, 1, 1, edge="replicate"), 0)
        if rank == 0:
            torch.save(result, f"{out}/rank0.pt")
    finally:
        torch.distributed.destroy_process_group()


def _zero_halo_rows():
    """The injected fault: every halo exchange delivers zero rows in place
    of the neighbours' (the collectives still pair up; the all-gathers of
    the sources are left as they are)."""
    from mdfnet_tpu_torch.parallel import halo
    rows = halo._neighbour_rows

    def zeroed(x, h_axis, lo, hi):
        return tuple(None if t is None else torch.zeros_like(t)
                     for t in rows(x, h_axis, lo, hi))
    halo._neighbour_rows = zeroed


def forward_rank(rank, world, init_method, inputs, out):
    """``spatial_eval_forward`` of a model from ``inputs`` (its config
    fields, state_dict and eval arguments); rank 0 writes depth and
    confidence."""
    group = _join(rank, world, init_method)
    try:
        setup = torch.load(inputs)
        model = build_model(ModelConfig(**setup["config"]), device="cpu")
        model.load_state_dict(setup["state_dict"], strict=True)
        got = spatial_eval_forward(model, *setup["args"], group)
        if rank == 0:
            torch.save({k: got[k] for k in ("depth", "confidence")},
                       f"{out}/rank0.pt")
    finally:
        torch.distributed.destroy_process_group()
