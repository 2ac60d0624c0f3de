"""Exact spatial (H-band) sharding of the eval forward's ops in the port
(``parallel/halo.py``), on gloo ranks on the CPU (the plain versions): the
halo exchange against the JAX package's on a 4-device CPU mesh, and each
hooked op run band-wise on 2 and 4 ranks against the unsharded op. The
rank programs are ``tests/_torch_spatial_ranks.py`` (no JAX: a spawned rank
imports it by name); every spawn is joined within ``SPAWN_TIMEOUT``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from _torch_port_helpers import alternative, build_port
from _torch_spatial_ranks import op_cases, ops_rank
from mdfnet_tpu.parallel import make_mesh
from mdfnet_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from mdfnet_tpu.parallel.halo import spatial_sharding as jax_sharding
from mdfnet_tpu_torch.cli.eval import align_crop
from mdfnet_tpu_torch.ops.cuda.aggregate_kernel import rowsweep_aggregate
from mdfnet_tpu_torch.ops.regress import confidence_regression
from mdfnet_tpu_torch.parallel import halo, spawn_ranks
from mdfnet_tpu_torch.parallel.spatial import band_rows, check_model

# spawn, import and the ops take ~5 s on the CPU
SPAWN_TIMEOUT = 120
WORLDS = (2, 4)
OPS = list(op_cases())
# the ops whose band reads its neighbours' rows through halo_exchange (the
# aggregates read the all-gathered sources instead)
STENCILS = [name for name in OPS if not name.startswith(("K1", "K6"))]


def _spawn(tmp_path_factory, n: int, fault: bool = False) -> dict:
    out = tmp_path_factory.mktemp(f"ops{n}{'fault' if fault else ''}")
    spawn_ranks(ops_rank, n, (f"file://{out}/pg", str(out), fault),
                timeout=SPAWN_TIMEOUT)
    return torch.load(out / "rank0.pt")


@pytest.fixture(scope="module")
def bands(tmp_path_factory):
    return {n: _spawn(tmp_path_factory, n) for n in WORLDS}


@pytest.fixture(scope="module")
def unsharded():
    with torch.no_grad():
        return {name: op(x) for name, (op, x, _, _) in op_cases().items()}


def test_halo_exchange_matches_jax(bands):
    """test_spatial.py:31-56's array over 4 ranks: zero rows (lo = hi = 2)
    and replicated edge rows (lo = hi = 1) equal JAX's halo_exchange on a
    4-device CPU mesh, bit for bit, and the global padding they stand
    for."""
    n = 4
    mesh = make_mesh(data=1, spatial=n, devices=jax.devices()[:n])
    x = jnp.arange(32.0 * 6).reshape(32, 6)

    def band_fn(xb):
        with jax_sharding("spatial", n):
            return (jax_halo_exchange(xb, 0, lo=2, hi=2, edge="zero"),
                    jax_halo_exchange(xb, 0, lo=1, hi=1, edge="replicate"))
    z, r = jax.shard_map(band_fn, mesh=mesh, in_specs=(P("spatial", None),),
                         out_specs=(P("spatial", None),) * 2,
                         check_vma=False)(x)
    got = bands[n]
    np.testing.assert_array_equal(got["halo zero"].numpy(), np.asarray(z))
    np.testing.assert_array_equal(got["halo replicate"].numpy(),
                                  np.asarray(r))
    xp = np.pad(np.asarray(x), ((2, 2), (0, 0)))
    xe = np.pad(np.asarray(x), ((1, 1), (0, 0)), mode="edge")
    zb = got["halo zero"].numpy().reshape(n, 12, 6)
    rb = got["halo replicate"].numpy().reshape(n, 10, 6)
    for i in range(n):
        np.testing.assert_array_equal(zb[i], xp[i * 8:i * 8 + 12])
        np.testing.assert_array_equal(rb[i], xe[i * 8:i * 8 + 10])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", OPS)
def test_hooked_op_bandwise_equals_unsharded(bands, unsharded, name, n):
    """Each hooked op of the eval forward (the upsamples, 2D and 3D convs
    at stride 1 and 2, the transposed conv with its skip, ProbConv, the
    trunk's and refine's chains on the chain kernel's plain version, K1's
    and K6's plain versions on a band reference against all-gathered
    sources) run band-wise over n ranks equals the unsharded op's rows:
    within 1e-6 (an f32 sum order may move; on this CPU they are equal)."""
    got, want = bands[n][name], unsharded[name]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_a_halo_of_zeros_is_caught(tmp_path_factory, unsharded):
    """The injected fault: halo exchanges that deliver zero rows move every
    stencil op's output far beyond the 1e-6 bound."""
    faulty = _spawn(tmp_path_factory, 2, fault=True)
    for name in STENCILS:
        err = (faulty[name] - unsharded[name]).abs().max().item()
        assert err > 1e-3, (name, err)


@pytest.mark.parametrize("hypos", ["planes", "per pixel"])
def test_k1_band_launch_equals_full_launch_rows(hypos):
    """K1's plain version with a band reference (H rows from row0 of the
    Hs-row sources) gives the full launch's rows, bit for bit: the band's
    sample coordinates are the full launch's."""
    rng = np.random.RandomState(0)
    b, s, hs, w, g, d = 1, 2, 16, 12, 8, 5
    src = torch.from_numpy(rng.randn(b, s, hs, w, g).astype(np.float32))
    ref = torch.from_numpy(rng.randn(b, hs, w, g).astype(np.float32))
    proj = torch.eye(4).repeat(1, s + 1, 1, 1)
    proj[:, :, 0, 0] = proj[:, :, 1, 1] = 14.0
    proj[:, :, 0, 2], proj[:, :, 1, 2] = 6.0, 8.0
    proj[0, 1:, 0, 3] = torch.tensor([-3.0, 2.5])
    proj[0, 1:, 1, 3] = torch.tensor([1.5, -2.0])
    hyp = torch.linspace(4.0, 9.0, d).reshape(1, d, 1, 1)
    if hypos == "per pixel":
        hyp = hyp + torch.from_numpy(
            rng.rand(b, d, hs, w).astype(np.float32))
    dw = (torch.from_numpy(rng.randn(g).astype(np.float32)),
          torch.tensor(0.9), torch.tensor(0.1), torch.tensor(1.3),
          torch.tensor(-0.2))
    full = rowsweep_aggregate(src, ref, proj[:, 1:], proj[:, 0], hyp, *dw)
    for row0, h in ((0, 4), (4, 8), (12, 4)):
        rows = slice(row0, row0 + h)
        band_hyp = hyp if hypos == "planes" else hyp[:, :, rows]
        got = rowsweep_aggregate(src, ref[:, rows], proj[:, 1:], proj[:, 0],
                                 band_hyp, *dw, row0=row0)
        assert torch.equal(got, full[:, :, rows]), row0


@pytest.mark.parametrize("height,n,want", [
    (1184, 1, 1184), (1184, 2, 1152), (1056, 2, 1024), (1184, 4, 1152),
    (1056, 4, 1024)])
def test_align_crop(height, n, want):
    """The eval CLI's crop for --spatial n: down to a multiple of 32 n (JAX
    cli/eval.py:96-108)."""
    assert align_crop(height, n) == want


def test_band_rows_need_32_n_alignment():
    assert band_rows(128, 4, 2) == slice(64, 96)
    with pytest.raises(ValueError, match="multiple"):
        band_rows(96, 2, 0)


@pytest.mark.parametrize("unit", ["variance", "refine1", "all four"])
def test_inexact_units_are_refused(unit):
    """The units that JAX's sharding does not compute within
    test_spatial.py's bounds (the variance aggregate, RefineNet v1) raise
    ValueError naming them, before any rank starts."""
    names = {"variance": "variance aggregate", "refine1": "RefineNet v1",
             "all four": "variance aggregate"}
    with pytest.raises(ValueError, match=names[unit]):
        check_model(build_port(alternative(unit)))


@pytest.mark.parametrize("unit", ["atv", "gauss0"])
def test_exact_alternatives_are_not_refused(unit):
    check_model(build_port(alternative(unit)))


def test_units_raise_inside_a_band():
    """Inside a spatial context the refused units, the bicubic confidence
    EMA and training raise ValueError themselves."""
    token = halo._CTX.set(halo.SpatialCtx(None, 0, 2))
    try:
        prob = torch.softmax(torch.randn(1, 4, 8, 8), 1)
        with pytest.raises(ValueError, match="bicubic"):
            confidence_regression(prob, torch.rand(1, 4, 4))
        model = build_port(alternative("all four"))
        proj = torch.eye(4).repeat(1, 3, 1, 1)
        with pytest.raises(ValueError, match="variance"):
            model.Homoaggre[0](torch.zeros(1, 3, 8, 8, 32), proj[:, 0],
                               proj[:, 1:], torch.ones(1, 4, 1, 1))
        with pytest.raises(ValueError, match="RefineNet v1"):
            model.Refine(torch.zeros(1, 8, 8, 3), torch.ones(1, 4, 4),
                         torch.tensor([[425.0, 935.0]]))
        with pytest.raises(ValueError, match="eval forward only"):
            model(torch.zeros(1, 3, 32, 32, 3), proj, proj[..., :3, :3],
                  torch.tensor([[425.0, 935.0]]), train=True)
    finally:
        halo._CTX.reset(token)
