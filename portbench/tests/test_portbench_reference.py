"""The frozen reference against the port's plain float32 versions at a tiny
size: the same weights give the same eval forward and train step (this
test imports both; the reference imports nothing of the port)."""
import copy
import statistics

import torch

from portbench import archs
from portbench.lib import harness

EVAL = harness.loop_module("eval")
TRAIN = harness.loop_module("train")
F32 = 1e-4       # float32 sums in other orders; relative to the depth range


def f32_cell(cell):
    cell = copy.deepcopy(cell)
    cell["cfg"]["compute_dtype"] = "float32"
    return cell


def test_reference_state_dict_is_the_ports(tiny_cell):
    cell = tiny_cell("dtu.eval")
    item = EVAL.Loop(harness.Run(cell, 5, "cpu")).item(0)
    state = harness.make_state(cell["cfg"], cell["mix"], 5, "cpu", item)
    port = harness.build_program(cell["cfg"], state, "cpu", False)
    assert port.state_dict().keys() == state.keys()


def test_eval_forward_matches_the_ports_plain_f32(tiny_cell):
    cell = f32_cell(tiny_cell("dtu.eval"))
    run = harness.Run(cell, 9, "cpu")
    loop = EVAL.Loop(run)
    state = harness.make_state(cell["cfg"], cell["mix"], 9, "cpu",
                               loop.item(0))
    port = harness.build_program(cell["cfg"], state, "cpu", False)
    ref = harness.build_reference(cell["cfg"], state, "cpu")
    args = [loop.item(1)[k] for k in harness.INPUTS]
    stages = archs.of(cell["cfg"]).stage_hooks(port, 3)
    got = port(*args, plain=True)
    got_stages = stages.close()
    want = ref(*args)
    for a, b in zip(got_stages + [got["depth"]],
                    want["stage_depths"] + [want["depth"]]):
        assert float((a - b).abs().max()) / 510.0 < F32
    assert float((got["confidence"] - want["confidence"]).abs().mean()) < F32


def test_train_step_matches_the_ports_plain_f32(tiny_cell):
    from mdfnet_tpu_torch.train_lib import make_optimizer, train_step
    cell = f32_cell(tiny_cell("dtu.train"))
    run = harness.Run(cell, 4, "cpu")
    loop = TRAIN.Loop(run)
    state = harness.make_state(cell["cfg"], cell["mix"], 4, "cpu",
                               loop.item(0))
    port = harness.build_program(cell["cfg"], state, "cpu", True)
    ref_mod = harness.reference_module(cell["cfg"])
    ref = harness.build_reference(cell["cfg"], state, "cpu").train()
    batch = loop.item(0)
    loss_p = float(train_step(port, make_optimizer(port, 1e-3), batch,
                              plain=True))
    loss_r = float(ref_mod.train_step(ref, ref_mod.adam(ref, 1e-3), batch))
    assert abs(loss_p - loss_r) / loss_r < 1e-5
    grads_p = dict(port.named_parameters())
    gaps = harness.leaf_gaps({n: p.grad for n, p in grads_p.items()},
                             {n: p.grad for n, p in ref.named_parameters()},
                             list(grads_p))
    assert statistics.median(gaps.values()) < 1e-4
    for k in state:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(port.state_dict()[k], ref.state_dict()[k],
                                  rtol=1e-4, atol=1e-5), k
