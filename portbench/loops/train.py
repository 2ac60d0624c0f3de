"""The ``train`` loop: back-to-back ``train_lib.train_step`` calls on
batches copied from pinned host memory, each step's loss read on the host
as the train CLI reads it.

The first ``checked_steps`` run in set-up, from the initial state, on
batches whose rows all differ; after the window the reference follows them
from the same state on the same batches. Faults that a test or
``calibrate.py`` may plant: ``unchanged state`` (a step that computes its
gradients and leaves the parameters as they were) and ``half batch`` (each
step on the first half of its batch).
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench.lib import harness as h

SHAPE = "train"
LABELS = ("input copy", "train step", "forward", "optimizer", "loss read")
BACKWARD = "backward"
FAULTS = ("unchanged state", "half batch")
BETA1 = 0.9


class Loop:
    def __init__(self, run):
        self.run = run
        shape = run.cfg[SHAPE]
        self.batch = shape["batch"]
        self.n = run.mix["batches"]
        self.host = h.make_data(shape, run.mix, self.n * self.batch,
                                run.seed, run.device)
        self.step_fn = step_fn(run.fault)
        self.optimizer = None
        self.losses = []

    def item(self, i: int) -> dict:
        k = i % self.n
        return h.rows(self.host, k * self.batch, (k + 1) * self.batch)

    def attach(self, model):
        from mdfnet_tpu_torch.train_lib import make_optimizer
        self.optimizer = make_optimizer(model, self.run.cfg[SHAPE]["lr"])
        return model

    def one(self, model, i: int) -> float:
        spans = self.run.spans
        with spans("input copy"):
            batch = h.to_device(self.item(i), self.run.device)
        with spans("train step"):
            loss = self.step_fn(model, self.optimizer, batch)
        with spans("loss read"):
            return float(loss)

    def warmup(self, model) -> list:
        """The checked steps: from the initial state, on the first batches,
        keeping each loss, the first gradient as Adam holds it, and the
        parameters and running statistics after the last. Returns the
        seconds each step took."""
        steps, took = self.run.mix["checked_steps"], []
        for i in range(steps):
            t = time.perf_counter()
            self.losses.append(self.one(model, i))
            took.append(time.perf_counter() - t)
            if i == 0:
                self.grads = {n: self._first_grad(p)
                              for n, p in model.named_parameters()}
        self.after = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
        self.next = steps
        return took

    def _first_grad(self, p):
        st = self.optimizer.state.get(p, {})
        if "exp_avg" not in st:
            return torch.zeros_like(p)
        return st["exp_avg"].detach() / (1.0 - BETA1)

    def window(self, model, seconds: float, min_items: int = 0) -> dict:
        losses, i = [], self.next
        start = time.perf_counter()
        while (time.perf_counter() - start < seconds
               or len(losses) < min_items):
            losses.append(self.one(model, i))
            i += 1
        elapsed = time.perf_counter() - start
        self.next = i
        return {"items": len(losses), "seconds": elapsed,
                "nonfinite": sum(not np.isfinite(x) for x in losses)}

    def traced(self, model, n: int) -> None:
        for _ in range(n):
            self.one(model, self.next)
            self.next += 1

    def span_hooks(self, model) -> list:
        spans = self.run.spans
        return [model.register_forward_pre_hook(
                    lambda *_: spans.enter("forward")),
                model.register_forward_hook(lambda *_: spans.exit()),
                self.optimizer.register_step_pre_hook(
                    lambda *_: spans.enter("optimizer")),
                self.optimizer.register_step_post_hook(
                    lambda *_: spans.exit())]

    def check(self, state: dict) -> dict:
        """The reference follows the checked steps from the same state on
        the same batches. Per step the loss's relative gap; per leaf the
        gap between the program's and the reference's norms of the first
        gradient, of the parameters' change after the steps and of the
        running statistics' change, over the larger of the reference's
        norm of that leaf and of the median leaf; the worst."""
        run = self.run
        ref = h.reference_module(run.cfg)
        model = h.build_reference(run.cfg, state, run.device).train()
        opt = ref.adam(model, run.cfg[SHAPE]["lr"])
        want_loss, grads = [], {}
        with ref.exact_f32():
            for i in range(len(self.losses)):
                batch = h.to_device(self.item(i), run.device)
                want_loss.append(float(ref.train_step(model, opt, batch)))
                if i == 0:
                    grads = {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}
        after = model.state_dict()
        gaps = [abs(a - b) / abs(b) for a, b in zip(self.losses, want_loss)]
        gnorm = {n: float(g.norm()) for n, g in grads.items()}
        median = statistics.median(gnorm.values())
        moved = [n for n, v in gnorm.items() if v >= 1e-3 * median]
        stats = [k for k in after if k.endswith(("running_mean",
                                                 "running_var"))]
        grad = h.leaf_gaps(self.grads, grads, list(gnorm))
        change = h.leaf_gaps({n: self.after[n] - state[n] for n in moved},
                             {n: after[n] - state[n] for n in moved}, moved)
        stat = h.leaf_gaps({n: self.after[n] - state[n] for n in stats},
                           {n: after[n] - state[n] for n in stats}, stats)
        readings = {"loss": max(gaps), "loss1": gaps[0]}
        for key, leaves in (("grad", grad), ("change", change),
                            ("stats", stat)):
            readings[key] = max(leaves.values())
            readings[key + "_median"] = statistics.median(leaves.values())
        return {"readings": readings, "missing": 0,
                "checked": len(self.losses),
                "excluded": sorted(set(gnorm) - set(moved)),
                "losses": self.losses, "reference_losses": want_loss,
                "worst_leaves": {k: max(v, key=v.get) for k, v in (
                    ("grad", grad), ("change", change), ("stats", stat))}}


def step_fn(fault: str | None):
    """``train_lib.train_step``, or it with a planted fault."""
    from mdfnet_tpu_torch.train_lib import loss_and_grads, train_step
    if fault is None:
        return train_step
    if fault == "unchanged state":
        def step(model, optimizer, batch):
            optimizer.zero_grad(set_to_none=True)
            return loss_and_grads(model, batch)
        return step
    if fault == "half batch":
        def step(model, optimizer, batch):
            half = batch["imgs"].shape[0] // 2
            return train_step(model, optimizer, h.rows(batch, 0, half))
        return step
    raise ValueError(f"unknown fault {fault!r}")
