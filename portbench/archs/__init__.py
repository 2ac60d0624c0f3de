"""What the benchmark knows of each architecture beyond its plain reference.

A configuration's ``reference`` key names its architecture: the plain
float32 model is ``reference/<reference>.py`` and what the benchmark knows
about it is ``archs/<reference>.py``. A new architecture comes as those two
files; no file of the harness names one.

The reference module holds ``exact_f32()`` (a context without TF32) and,
where a cell trains it, ``adam(model, lr)`` and ``train_step(model,
optimizer, batch)``. Its model takes the port's calling convention,
``model(imgs, extrinsics, intrinsics, depth_range, train=False)``, returns
in eval ``depth``, ``confidence`` and ``stage_depths`` and in training
``depth`` (the depths that the loss reads), and has
``set_operand_dtype(dtype)`` for the control.

The architecture's module holds:

- ``build(cfg) -> nn.Module``: the reference model that the configuration
  describes (its weights are drawn by the harness);
- ``LAYERS``: the top-level module names, the same in the port's model and
  in the reference, that spans, ``breakdown`` labels and the work count are
  grouped by;
- ``layer_work(cfg, shapes, macs, params)``: per layer of ``LAYERS``, a dict
  of ``macs`` (the multiply-adds of its convolutions, as
  :func:`portbench.lib.count.forward_work` tallied them and hands them
  over in ``macs``, or those with the layer's own terms added),
  ``flops_f32`` (float32 operations outside the convolutions) and
  ``bytes`` (its boundary traffic). A layer with ``flops_f32`` runs its
  convolutions inside them, on the CUDA cores; only the other layers'
  multiply-adds go to the tensor cores;
- ``stages(cfg)``: the number of stage depths the model reports;
- ``stage_hooks(model, n)``: hooks on the port's model (or the reference)
  whose ``close()`` removes them and returns the ``n`` stage depths of the
  map that ran under them.
"""
from __future__ import annotations

import importlib


def of(cfg: dict):
    """``archs/<cfg["reference"]>.py``."""
    return importlib.import_module(f"portbench.archs.{cfg['reference']}")
