"""The port's spatially sharded eval forward (``parallel/spatial.py``) on 2
and 4 gloo ranks on the CPU at 128x64, 3 views, against the port's
unsharded forward (JAX test_spatial.py's bounds: depth max / range <= 1e-5,
confidence max <= 1e-4) and JAX's unsharded XLA f32 forward on the same
weights (test_corenet_matches_jax's bounds), for a C/G = 2 configuration
(``SMALL``: K1 at every stage) and for JAX's ``test_spatial.SMALL`` (C/G = 1
at stage 0: K6 there, K1 after); and the alternative units that JAX shards
exactly (ATV hypotheses, gauss0 curves) against the port's unsharded
forward. JAX's own sharded forward compiles for minutes on the CPU: the
checks against it are marked slow (not the bicubic EMA's, a function's)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port_helpers import (SMALL, alternative, build_port, depth_error,
                                 jax_model_and_port, scene_args, to_torch)
from _torch_spatial_ranks import forward_rank
from mdfnet_tpu_torch.parallel import spawn_ranks
from test_spatial import SMALL as JAX_SPATIAL_SMALL

SPAWN_TIMEOUT = 120
WORLDS = (2, 4)
CONFIGS = {"C/G = 2 (K1)": SMALL, "test_spatial.SMALL (K6)":
           JAX_SPATIAL_SMALL}
HEIGHT, WIDTH = 128, 64


def sharded(tmp_path, config, port, args, n) -> dict:
    """Rank 0's {"depth", "confidence"} of ``spatial_eval_forward`` over n
    ranks of ``port``'s weights."""
    inputs = tmp_path / "inputs.pt"
    torch.save({"config": dataclasses.asdict(config),
                "state_dict": port.state_dict(), "args": to_torch(*args)},
               inputs)
    spawn_ranks(forward_rank, n, (f"file://{tmp_path}/pg", str(inputs),
                                  str(tmp_path)), timeout=SPAWN_TIMEOUT)
    return {k: v.numpy() for k, v in torch.load(tmp_path / "rank0.pt")
            .items()}


def assert_unsharded_bounds(got: dict, want: dict) -> None:
    """JAX test_spatial.py's bounds: max errors, not percentiles."""
    err = depth_error(got["depth"], want["depth"])
    assert err.max() <= 1e-5, err.max()
    cerr = np.abs(got["confidence"] - want["confidence"])
    assert cerr.max() <= 1e-4, cerr.max()


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request, tmp_path_factory):
    config = CONFIGS[request.param]
    args = scene_args(HEIGHT, WIDTH, nviews=3)
    jm, variables, port = jax_model_and_port(config, args)
    import jax
    ref = jax.jit(lambda *a: jm.apply(variables, *a, train=False))(*args)
    out = port(*to_torch(*args))
    got = {n: sharded(tmp_path_factory.mktemp(f"n{n}"), config, port, args,
                      n) for n in WORLDS}
    return {"jax": {k: np.asarray(v) for k, v in ref.items()},
            "port": {k: v.numpy() for k, v in out.items()}, "sharded": got,
            "port model": port, "config": config}


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_forward_matches_unsharded(case, n):
    assert case["sharded"][n]["depth"].shape == (1, HEIGHT, WIDTH)
    assert_unsharded_bounds(case["sharded"][n], case["port"])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_forward_matches_jax(case, n):
    """test_corenet_matches_jax's bounds: depth error / range median <=
    1e-5, max <= 1e-3; confidence within 1e-4."""
    got, ref = case["sharded"][n], case["jax"]
    err = depth_error(got["depth"], ref["depth"])
    assert np.median(err) <= 1e-5 and err.max() <= 1e-3, \
        (np.median(err), err.max())
    np.testing.assert_allclose(got["confidence"], ref["confidence"],
                               atol=1e-4)


def test_the_k6_case_runs_the_sample_path(case):
    """test_spatial.SMALL samples C/G = 1 features at stage 0 (K6's path)
    and the pair differences after; SMALL takes K1 at every stage."""
    port, config = case["port model"], case["config"]
    ratios = [config.chs[3 - s] // config.ngroups[s] for s in range(3)]
    if config is JAX_SPATIAL_SMALL:
        assert ratios == [1, 2, 2] and not port.Backbone.emit_diffs
    else:
        assert ratios == [2, 2, 2] and port.Backbone.emit_diffs


@pytest.mark.parametrize("unit", ["atv", "gauss0"])
def test_exact_alternatives_shard_exactly(tmp_path, unit):
    """JAX shards ATV hypotheses and gauss0 curves within test_spatial.py's
    bounds (test_jax_spatial_reading_decides_each_unit); so does the port,
    at n = 2, against its unsharded forward."""
    config = alternative(unit)
    port = build_port(config, seed=3)
    args = scene_args(HEIGHT, WIDTH, nviews=3)
    want = {k: v.numpy() for k, v in port(*to_torch(*args)).items()}
    assert_unsharded_bounds(sharded(tmp_path, config, port, args, 2), want)


@pytest.mark.slow
@pytest.mark.parametrize("unit", ["variance", "atv", "refine1", "gauss0"])
def test_jax_spatial_reading_decides_each_unit(unit):
    """JAX's spatial_eval_forward against its unsharded forward on a
    2-device CPU mesh at 64x64 (``-s`` prints the reading): the units it
    shards within test_spatial.py's bounds are sharded in the port, the
    others refused (parallel/spatial.py:check_model)."""
    import jax
    from mdfnet_tpu.models import build_model as build_jax_model
    from mdfnet_tpu.parallel import make_mesh
    from mdfnet_tpu.parallel.spatial import spatial_eval_forward as jax_sef
    from mdfnet_tpu_torch.parallel.spatial import check_model
    config = dataclasses.replace(alternative(unit), warp_impl="gather")
    args = [jax.numpy.asarray(a) for a in scene_args(64, 64, nviews=3)]
    jm = build_jax_model(config)
    variables = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a,
                                           train=False))(*args)
    ref = jax.jit(lambda *a: jm.apply(variables, *a, train=False))(*args)
    mesh = make_mesh(data=1, spatial=2, devices=jax.devices()[:2])
    out = jax.jit(lambda *a: jax_sef(jm, variables, mesh, *a))(*args)
    err = depth_error(out["depth"], ref["depth"]).max()
    cerr = np.abs(np.asarray(out["confidence"])
                  - np.asarray(ref["confidence"])).max()
    exact = err <= 1e-5 and cerr <= 1e-4
    print(f"{unit}: JAX sharded vs unsharded depth max / range {err:.3e}, "
          f"confidence max {cerr:.3e}: {'exact' if exact else 'not exact'}")
    if exact:
        check_model(build_port(alternative(unit)))
    else:
        with pytest.raises(ValueError):
            check_model(build_port(alternative(unit)))


def test_jax_bicubic_ema_is_not_exact_under_sharding():
    """JAX's confidence_regression with last_confidence (the bicubic EMA,
    which no CoreNet config uses) in a 2-device shard_map against the
    unsharded call (``-s`` prints the reading): resize_bicubic_2x has no
    halo, so it is not exact, and the port refuses it
    (test_torch_spatial.py::test_units_raise_inside_a_band)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from mdfnet_tpu.ops.regress import confidence_regression
    from mdfnet_tpu.parallel import make_mesh
    from mdfnet_tpu.parallel.halo import spatial_sharding
    rng = np.random.RandomState(0)
    prob = jax.nn.softmax(jax.numpy.asarray(
        rng.randn(1, 8, 64, 32).astype(np.float32)), axis=1)
    last = jax.numpy.asarray(rng.rand(1, 32, 16).astype(np.float32))
    ref = np.asarray(confidence_regression(prob, last_confidence=last))
    mesh = make_mesh(data=1, spatial=2, devices=jax.devices()[:2])

    def band(p, c):
        with spatial_sharding("spatial", 2):
            return confidence_regression(p, last_confidence=c)
    out = jax.shard_map(band, mesh=mesh, in_specs=(
        P(None, None, "spatial", None), P(None, "spatial", None)),
        out_specs=P(None, "spatial", None), check_vma=False)(prob, last)
    err = np.abs(np.asarray(out) - ref).max()
    print(f"bicubic EMA: JAX sharded vs unsharded confidence max {err:.3e}")
    assert err > 1e-4


@pytest.mark.slow
def test_port_sharded_matches_jax_sharded(tmp_path):
    """JAX's own spatial_eval_forward at n = 2 on test_spatial.SMALL vs the
    port's on the same weights: test_corenet_matches_jax's bounds."""
    import jax
    from mdfnet_tpu.parallel import make_mesh
    from mdfnet_tpu.parallel.spatial import spatial_eval_forward as jax_sef
    args = scene_args(HEIGHT, WIDTH, nviews=3)
    jm, variables, port = jax_model_and_port(JAX_SPATIAL_SMALL, args)
    mesh = make_mesh(data=1, spatial=2, devices=jax.devices()[:2])
    ref = jax.jit(lambda *a: jax_sef(jm, variables, mesh, *a))(*args)
    got = sharded(tmp_path, JAX_SPATIAL_SMALL, port, args, 2)
    err = depth_error(got["depth"], ref["depth"])
    assert np.median(err) <= 1e-5 and err.max() <= 1e-3
    np.testing.assert_allclose(got["confidence"], ref["confidence"],
                               atol=1e-4)
