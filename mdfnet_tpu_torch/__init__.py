"""mdfnet_tpu_torch — the PyTorch + CUDA port of ``mdfnet_tpu`` for NVIDIA Hopper.

The JAX package ``mdfnet_tpu`` is the frozen reference; this package mirrors
its module names so each module's counterpart is easy to find. It imports
``torch`` and never ``jax``. The JAX-free host modules of the reference
(``mdfnet_tpu.config``, ``mdfnet_tpu.data.*``,
``mdfnet_tpu.utils.pth_import``) are reused by import.

Layout
------
- :mod:`mdfnet_tpu_torch.geometry` — camera math (projection, plane sweep)
- :mod:`mdfnet_tpu_torch.ops`      — sampling / warp / fitting / regression,
  and ``ops.cuda``: the hand-written Hopper kernels, each beside its plain
  PyTorch version
- :mod:`mdfnet_tpu_torch.models`   — ``nn.Module`` cascade in the reference
  ``state_dict`` schema
- :mod:`mdfnet_tpu_torch.evaluate`, :mod:`mdfnet_tpu_torch.cli.eval` — the
  eval loop and its CLI
"""

__version__ = "0.1.0"
