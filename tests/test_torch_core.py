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
from mdfnet_tpu.config import ModelConfig as JaxModelConfig
from mdfnet_tpu.utils.pth_import import save_reference_checkpoint
from mdfnet_tpu_torch.config import ModelConfig
from mdfnet_tpu_torch.models.registry import build_model, count_params
from mdfnet_tpu_torch.utils.weights import load_checkpoint


@pytest.fixture(scope="module")
def full_width():
    """Default ModelConfig (all widths), tiny 64x96 image, 3 views."""
    args = scene_args(64, 96, nviews=3, structure="steps")
    jm, variables, port = jax_model_and_port(JaxModelConfig(), args)
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
    other = build_model(seed=1, device="cpu")
    assert load_checkpoint(other, path) == 7
    inputs = to_torch(*args)
    a, b = port(*inputs), other(*inputs)
    torch.testing.assert_close(a["depth"], b["depth"], rtol=0, atol=0)
    torch.testing.assert_close(a["confidence"], b["confidence"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("field,value", [
    ("aggregate_impl", "variance"), ("hypo_impl", "atv"),
    ("refine_impl", "refine1"), ("curve_classes", (None, "gauss0", "gauss0"))])
def test_alternative_units_build(field, value):
    """Each alternative unit builds at the default widths on the CPU and
    runs a forward to finite maps of the input's size."""
    model = build_model(ModelConfig(**{field: value}), device="cpu")
    args = to_torch(*scene_args(64, 96, nviews=3, structure="plane"))
    out = model(*args)
    assert out["depth"].shape == out["confidence"].shape == (1, 64, 96)
    assert bool(torch.isfinite(out["depth"]).all()
                & torch.isfinite(out["confidence"]).all())


def test_alternative_units_refuse_the_fused_warp():
    """``warp_impl="fused"`` trains the vector aggregate only, as in JAX."""
    with pytest.raises(ValueError, match="fused"):
        build_model(ModelConfig(warp_impl="fused", refine_impl="refine1"),
                    device="cpu")


def test_port_imports_no_jax():
    """The card's machine has no JAX, and the port keeps its own copies of
    the JAX package's host modules: with ``mdfnet_tpu`` blocked, every
    module of the port and ``chip_smoke`` imports, a model builds, and no
    module of ``jax``, ``jaxlib``, ``flax`` or ``mdfnet_tpu`` is loaded."""
    code = ("import pkgutil, sys\n"
            "sys.modules['mdfnet_tpu'] = None\n"
            "import mdfnet_tpu_torch, chip_smoke\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "mdfnet_tpu_torch.__path__, 'mdfnet_tpu_torch.')]\n"
            "assert len(names) > 25, names\n"
            "for name in names:\n"
            "    __import__(name)\n"
            "from mdfnet_tpu_torch.models.registry import build_model\n"
            "build_model(device='cpu')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mdfnet_tpu') "
            "and sys.modules[m] is not None]\n"
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
    ``jax``, ``jaxlib``, ``flax`` or ``mdfnet_tpu`` in an import."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "mdfnet_tpu_torch")
    files = [os.path.join(d, f) for d, _, names in os.walk(pkg)
             for f in names if f.endswith(".py")]
    assert len(files) > 20
    assert {os.path.join(pkg, f) for f in (
        "parallel/mesh.py", "parallel/halo.py", "parallel/spatial.py",
        "cli/viz.py", "benchmarks/tanks_submit.py")} \
        <= set(files)
    for path in files:
        bad = _imported_packages(path) & {"jax", "jaxlib", "flax",
                                          "mdfnet_tpu"}
        assert not bad, (os.path.relpath(path, root), bad)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports the port and nothing of ``mdfnet_tpu`` or
    JAX."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tops = _imported_packages(os.path.join(root, "chip_smoke.py"))
    assert "mdfnet_tpu_torch" in tops
    assert not tops & {"mdfnet_tpu", "jax", "jaxlib", "flax"}, tops


@pytest.mark.parametrize("compute_dtype,dtype", [
    (None, torch.float32), ("bfloat16", torch.bfloat16)])
def test_build_model_compute_dtype(compute_dtype, dtype):
    """``compute_dtype`` overrides the default config's; weights stay f32."""
    model = build_model(compute_dtype=compute_dtype, device="cpu")
    assert model.dtype == dtype
    assert model.ndepths == ModelConfig().ndepths
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.mark.parametrize("main,argv", [
    ("mdfnet_tpu_torch.cli.eval", ["-p", "missing.pth"]),
    ("mdfnet_tpu_torch.train", ["-d", "dtu", "--epochs", "1"])])
def test_cli_without_a_card_fails_loudly(monkeypatch, capsys, main, argv):
    """With no CUDA device and no ``--device cpu``, each CLI exits non-zero
    with a message, before it reads any data."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        importlib.import_module(main).main(argv)
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_build_model_without_a_card_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model()


def test_c_signatures_match_the_sources():
    """Every C entry point of ``csrc/*.cu`` is declared to ctypes with its
    argument kinds (pointer, int, float), in order: a mismatch would pass
    a cut pointer or a wrong int to the kernel, and no compiler sees it."""
    import re
    from mdfnet_tpu_torch.ops.cuda import build
    src = "".join(p.read_text() for p in sorted(build.CSRC.glob("*.cu")))
    found = {}
    for m in re.finditer(r'extern "C" int (mdf_\w+)\(([^)]*)\)', src):
        found[m[1]] = [
            build._P if "*" in a else build._F if a.split()[0] == "float"
            else build._I for a in m[2].split(",")]
    assert found == build.SIGNATURES
