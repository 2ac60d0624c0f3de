"""The port's CoreNet eval forward at the full default widths vs the JAX
CoreNet on its exact f32 XLA path, on the same weights."""
import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_port_helpers import (depth_error, jax_model_and_port, scene_args,
                                 to_torch)
from mdfnet_tpu.config import ModelConfig
from mdfnet_tpu.utils.pth_import import save_reference_checkpoint
from mdfnet_tpu_torch.models.registry import build_model, count_params
from mdfnet_tpu_torch.utils.weights import load_checkpoint


@pytest.fixture(scope="module")
def full_width():
    """Default ModelConfig (all widths), tiny 64x96 image, 3 views."""
    args = scene_args(64, 96, nviews=3, structure="steps")
    jm, variables, port = jax_model_and_port(ModelConfig(), args)
    forward = jax.jit(lambda *a: jm.apply(variables, *a, train=False))
    return args, variables, port, forward


@pytest.mark.parametrize("structure", ["steps", "sphere", "ridges", "plane"])
def test_corenet_matches_jax(full_width, structure):
    """Depth discontinuities, curved and slanted relief, a plane."""
    _, _, port, forward = full_width
    args = scene_args(64, 96, nviews=3, structure=structure)
    ref = {k: np.asarray(v) for k, v in forward(*args).items()}
    out = port(*to_torch(*args))
    assert out["depth"].shape == (1, 64, 96)
    assert bool(out["coverage_ok"])
    err = depth_error(out["depth"].numpy(), ref["depth"])
    # f32 on both sides; XLA and ATen sum in different orders, and the
    # fitting's clamps/thresholds can flip for a single pixel, hence a
    # median far below the max bound
    assert np.median(err) <= 1e-5 and err.max() <= 1e-3, \
        (np.median(err), err.max())
    # confidence is a sum of up to 4 probabilities: f32 rounding only
    np.testing.assert_allclose(out["confidence"].numpy(), ref["confidence"],
                               atol=1e-4)


def test_param_count_matches_reference(full_width):
    _, variables, port, _ = full_width
    n_jax = sum(np.asarray(v).size
                for v in jax.tree_util.tree_leaves(variables["params"]))
    assert count_params(port) == n_jax == 1_206_380


def test_pth_round_trip(full_width, tmp_path):
    """save_reference_checkpoint (the reference .pth schema) -> the port
    loads it strictly -> the same output as the directly loaded weights."""
    args, variables, port, _ = full_width
    path = str(tmp_path / "ref.pth")
    save_reference_checkpoint(path, variables, epoch=7)
    other = build_model(seed=1)
    assert load_checkpoint(other, path) == 7
    inputs = to_torch(*args)
    a, b = port(*inputs), other(*inputs)
    torch.testing.assert_close(a["depth"], b["depth"], rtol=0, atol=0)
    torch.testing.assert_close(a["confidence"], b["confidence"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("field,value", [("aggregate_impl", "variance"),
                                         ("hypo_impl", "atv"),
                                         ("refine_impl", "refine1")])
def test_alternative_units_not_ported(field, value):
    with pytest.raises(NotImplementedError):
        build_model(ModelConfig(**{field: value}))


def test_port_imports_no_jax():
    """The card's machine has no JAX: the port's modules must not need it."""
    code = ("import sys, mdfnet_tpu_torch\n"
            "from mdfnet_tpu_torch.models.registry import build_model\n"
            "import mdfnet_tpu_torch.cli.eval, mdfnet_tpu_torch.evaluate\n"
            "import mdfnet_tpu_torch.data, chip_smoke\n"
            "import mdfnet_tpu_torch.train, mdfnet_tpu_torch.train_lib\n"
            "build_model()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)


def _imported_packages(path: str) -> set:
    """Top-level package names that a Python file imports (``ast``)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_port_module_imports_jax():
    """No module of the port, imported or not by the check above, names
    ``jax``, ``jaxlib`` or ``flax`` in an import."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "mdfnet_tpu_torch")
    files = [os.path.join(d, f) for d, _, names in os.walk(pkg)
             for f in names if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        bad = _imported_packages(path) & {"jax", "jaxlib", "flax"}
        assert not bad, (os.path.relpath(path, root), bad)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the JAX package's host helpers only through the
    port (``mdfnet_tpu_torch.data``), never by importing ``mdfnet_tpu``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tops = _imported_packages(os.path.join(root, "chip_smoke.py"))
    assert "mdfnet_tpu_torch" in tops
    assert not tops & {"mdfnet_tpu", "jax", "jaxlib", "flax"}, tops


@pytest.mark.parametrize("compute_dtype,dtype", [
    (None, torch.float32), ("bfloat16", torch.bfloat16)])
def test_build_model_compute_dtype(compute_dtype, dtype):
    """``compute_dtype`` overrides the default config's; weights stay f32."""
    model = build_model(compute_dtype=compute_dtype)
    assert model.dtype == dtype
    assert model.ndepths == ModelConfig().ndepths
    assert {p.dtype for p in model.parameters()} == {torch.float32}
