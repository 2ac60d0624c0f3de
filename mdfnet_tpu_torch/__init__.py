"""mdfnet_tpu_torch — the PyTorch + CUDA port of ``mdfnet_tpu`` for NVIDIA Hopper.

The JAX package ``mdfnet_tpu`` is the frozen reference; this package mirrors
its module names so each module's counterpart is easy to find. It imports
``torch`` and nothing of ``jax`` or of ``mdfnet_tpu``: where it needs one of
the JAX package's JAX-free host modules (``config``, ``data``,
``utils/pth_import``), it keeps its own copy under the same name.

Entry points (``models.registry.build_model``, ``train.train``, the train and
eval CLIs) run on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); a CPU tensor runs every kernel's plain
PyTorch version.

Layout
------
- :mod:`mdfnet_tpu_torch.config`, :mod:`mdfnet_tpu_torch.data` — configs,
  file formats, datasets, batch loader, synthetic scenes
- :mod:`mdfnet_tpu_torch.geometry` — camera math (projection, plane sweep)
- :mod:`mdfnet_tpu_torch.ops`      — sampling / warp / fitting / regression,
  and ``ops.cuda``: the hand-written Hopper kernels, each beside its plain
  PyTorch version
- :mod:`mdfnet_tpu_torch.models`   — ``nn.Module`` cascade in the reference
  ``state_dict`` schema
- :mod:`mdfnet_tpu_torch.evaluate`, :mod:`mdfnet_tpu_torch.cli.eval` — the
  eval loop and its CLI; :mod:`mdfnet_tpu_torch.train` — the train CLI
"""

__version__ = "0.1.0"
