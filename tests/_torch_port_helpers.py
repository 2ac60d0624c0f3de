"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The oracle is the JAX package on its exact XLA path in f32
(``warp_impl="gather"``, ``pallas_conv=False``), run on the CPU as the JAX
tests run it. Inputs come from numpy seeds or the synthetic scenes; weights
come from the JAX model's ``init`` (BatchNorm statistics perturbed from a
numpy seed, so the folded epilogues are exercised), exported through
``variables_to_state_dict`` and loaded with ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mdfnet_tpu.config import ModelConfig
from mdfnet_tpu.data.synthetic import make_batch, make_structured_scene
from mdfnet_tpu.models import build_model as build_jax_model
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.utils.weights import state_dict_from_jax_variables

# Tier-1 runs 6 xdist workers on the CPU: keep each one's torch pool small
torch.set_num_threads(2)

# narrow widths with C/G == 2 at every stage, as in the default config
SMALL = ModelConfig(chs=(8, 8, 16, 32), ngroups=(16, 8, 4))
DEPTH_EXTENT = 935.0 - 425.0   # the synthetic scenes' depth range


def scene_args(height: int = 64, width: int = 96, nviews: int = 3,
               structure: str = "steps") -> list[np.ndarray]:
    """(imgs, extrinsics, intrinsics, depth_range) of a synthetic scene."""
    scene = make_structured_scene(height=height, width=width, nviews=nviews,
                                  structure=structure)
    batch = make_batch(scene, batch=1)
    return [batch[k] for k in ("imgs", "extrinsics", "intrinsics",
                               "depth_range")]


def perturb_batchnorm(tree, rng: np.random.RandomState):
    """Random BN affine and running statistics (JAX init leaves them at
    scale 1, bias 0, mean 0, var 1, where folding is trivial)."""
    def visit(node, name=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a
    return visit(tree)


def jax_model_and_port(config: ModelConfig, args, seed: int = 0):
    """(JAX CoreNet on the exact f32 XLA path, its variables as numpy, the
    port loaded with the same weights)."""
    jm = build_jax_model(dataclasses.replace(
        config, warp_impl="gather", pallas_conv=False,
        compute_dtype="float32"))
    variables = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(seed), *a,
                                           train=False))(
        *map(jnp.asarray, args))
    variables = perturb_batchnorm(jax.tree_util.tree_map(np.asarray,
                                                         variables),
                                  np.random.RandomState(seed))
    port = build_model(config)
    port.load_state_dict(state_dict_from_jax_variables(variables),
                         strict=True)
    return jm, variables, port


def to_torch(*arrays) -> list[torch.Tensor]:
    return [torch.from_numpy(np.array(a)) for a in arrays]


def depth_error(a, b) -> np.ndarray:
    """|a - b| as a fraction of the scenes' depth range."""
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) \
        / DEPTH_EXTENT
