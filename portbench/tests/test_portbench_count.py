"""The work counts that the rooflines and utilisations read, against hand
counts at tiny shapes, and the four cells' counts pinned."""
import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from portbench.archs import mdfnet
from portbench.lib import count, harness
from portbench.lib.peaks import PEAKS

# count.forward_work of each cell's configuration at its own shapes, read
# before the architectures moved into portbench/archs: {layer: (macs,
# flops_f32, bytes, params)}
PINNED = {
    "dtu.eval": {
        "Backbone": (70600337760, 0, 189791664, 175832),
        "Homoaggre.0": (187545600, 4216934400, 200806592, 36),
        "Homoaggre.1": (193228800, 4432896000, 231116800, 20),
        "Homoaggre.2": (136396800, 3243212800, 212172800, 12),
        "Regular.0": (50471544960, 0, 97487648, 436624),
        "Regular.1": (18007042240, 0, 102886704, 294552),
        "Regular.2": (15701645760, 0, 76361648, 292824),
        "Refine": (3165148224, 0, 9484960, 6480),
    },
    "dtu.train": {
        "Backbone": (48607559040, 0, 131423664, 175832),
        "Homoaggre.0": (129761280, 2917662720, 138937088, 36),
        "Homoaggre.1": (133693440, 3067084800, 159907840, 20),
        "Homoaggre.2": (94371840, 2243952640, 146800640, 12),
        "Regular.0": (34347879936, 0, 67719968, 436624),
        "Regular.1": (12347260672, 0, 71367984, 294552),
        "Regular.2": (10813726464, 0, 53014448, 292824),
        "Refine": (2184092928, 0, 6566560, 6480),
    },
    "tanks.eval": {
        "Backbone": (166235840672, 0, 446406064, 175832),
        "Homoaggre.0": (501811200, 10991185920, 239247552, 36),
        "Homoaggre.1": (517017600, 11569029120, 296017920, 20),
        "Homoaggre.2": (364953600, 8483143680, 324403200, 12),
        "Regular.0": (54018815616, 0, 104276768, 436624),
        "Regular.1": (19272532672, 0, 110075184, 294552),
        "Regular.2": (16805068224, 0, 81686448, 292824),
        "Refine": (3387571776, 0, 10150560, 6480),
    },
    "blendedmvs.train": {
        "Backbone": (98543645760, 0, 265772464, 175832),
        "Homoaggre.0": (262766592, 5908267008, 281347200, 36),
        "Homoaggre.1": (270729216, 6210846720, 323813376, 20),
        "Homoaggre.2": (191102976, 4544004096, 297271296, 12),
        "Regular.0": (69823938816, 0, 136237856, 436624),
        "Regular.1": (25055799936, 0, 143916336, 294552),
        "Regular.2": (21921441408, 0, 106753968, 292824),
        "Refine": (4425549696, 0, 13284000, 6480),
    },
}


def brute_taps(n, k, stride, pad, out):
    return sum(1 for o in range(out) for t in range(k)
               if 0 <= o * stride - pad + t < n)


def test_taps_in_matches_brute_force():
    for n in (1, 2, 5, 8, 13):
        for k, stride in ((1, 1), (3, 1), (3, 2), (5, 2)):
            pad = (k - 1) // 2
            out = (n + 2 * pad - k) // stride + 1
            assert count.taps_in(n, k, stride, pad, out) == \
                brute_taps(n, k, stride, pad, out)


def test_conv_macs_hand_counts():
    # 3x3, padding 1 on a 4x4 input: corners meet 4 taps, edges 6, the
    # inner 4 pixels 9: 4*4 + 8*6 + 4*9 = 100 per (ci, co) pair
    assert count.conv_macs((1, 2, 4, 4), (1, 5, 4, 4), (5, 2, 3, 3),
                           (1, 1), (1, 1)) == 100 * 2 * 5
    # 1x1: every output reads one tap
    assert count.conv_macs((2, 3, 6, 7), (2, 4, 6, 7), (4, 3, 1, 1),
                           (1, 1), (0, 0)) == 2 * 3 * 4 * 6 * 7


def test_conv_macs_equal_the_products_of_a_direct_conv():
    """The count equals the nonzero products of the convolution itself:
    with input and weight all ones the output sums them."""
    for shape, k, stride in (((1, 1, 7, 9), 5, 2), ((1, 1, 5, 6), 3, 1)):
        x = torch.ones(shape)
        w = torch.ones(1, 1, k, k)
        y = F.conv2d(x, w, stride=stride, padding=(k - 1) // 2)
        assert count.conv_macs(shape, y.shape, w.shape, (stride, stride),
                               ((k - 1) // 2,) * 2) == int(y.sum())


def test_trconv_macs_count_taps_that_meet_the_input():
    x = torch.ones(1, 1, 3, 4, 5)
    w = torch.ones(1, 1, 3, 3, 3)
    y = F.conv_transpose3d(x, w, stride=2, padding=1, output_padding=1)
    assert count.trconv_macs(x.shape, y.shape, w.shape, (2,) * 3,
                             (1,) * 3) == int(y.sum())
    # k3, stride 2, padding 1, output_padding 1: 3n - 1 taps per axis
    assert count.trconv_macs((2, 4, 3, 4, 5), (2, 6, 6, 8, 10),
                             (4, 6, 3, 3, 3), (2,) * 3, (1,) * 3) == \
        2 * 4 * 6 * 8 * 11 * 14


MODULES = {
    "dilated 2": (nn.Conv2d(1, 1, 3, padding=2, dilation=2), (1, 1, 9, 11)),
    "dilated 6": (nn.Conv2d(1, 1, 3, padding=6, dilation=6), (1, 1, 9, 14)),
    "dilated 6, stride 2": (nn.Conv2d(2, 3, 3, 2, padding=3, dilation=6),
                            (2, 2, 13, 10)),
    "grouped": (nn.Conv2d(4, 8, 3, padding=1, groups=2), (2, 4, 6, 7)),
    "depthwise 1-D": (nn.Conv1d(4, 4, 5, padding=2, groups=4), (1, 4, 9)),
    "transposed 2-D": (nn.ConvTranspose2d(1, 1, 3, 2, padding=1,
                                          output_padding=1), (1, 1, 5, 7)),
    "transposed, grouped, dilated": (
        nn.ConvTranspose2d(4, 6, 3, 1, padding=2, groups=2, dilation=3),
        (1, 4, 5, 7)),
    "transposed 3-D": (nn.ConvTranspose3d(2, 3, 3, 2, padding=1,
                                          output_padding=1), (1, 2, 3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(MODULES))
def test_module_macs_equal_the_products_of_a_direct_conv(case):
    """The count that the tally takes from a module's stride, padding,
    dilation and groups equals the nonzero products of the module's own
    convolution: with input and weight all ones and no bias, the output
    sums them."""
    m, shape = MODULES[case]
    m = copy.deepcopy(m)
    with torch.no_grad():
        m.weight.fill_(1.0)
        m.bias.zero_()
        y = m(torch.ones(shape))
    assert count.module_macs(m, shape, y.shape) == int(y.sum())


def test_module_macs_refuse_padding_they_cannot_count():
    for m in (nn.Conv2d(1, 1, 3, padding="same"),
              nn.Conv2d(1, 1, 3, padding=1, padding_mode="reflect")):
        with pytest.raises(ValueError):
            count.module_macs(m, (1, 1, 5, 5), (1, 1, 5, 5))


def test_aggregate_ops_formula():
    # per point: 3G sigmoids, per source 38 + 21G, G divisions
    assert mdfnet.aggregate_ops(10, 4, 8) == 10 * (24 + 4 * (38 + 168) + 8)


def test_least_ms_takes_the_larger_bound():
    ops_bound = {"macs": 989e9 / 2, "flops_f32": 0, "bytes": 1.0, "params": 0}
    assert abs(count.least_ms(ops_bound) - 1.0) < 1e-9
    assert count.bound_by(ops_bound) == "operations"
    bytes_bound = {"macs": 0, "flops_f32": 0,
                   "bytes": PEAKS["hbm_bytes_per_s"] * 2e-3, "params": 0}
    assert abs(count.least_ms(bytes_bound, passes=3) - 6.0) < 1e-9
    assert count.bound_by(bytes_bound) == "bytes"


def test_forward_work_counts_every_conv_of_the_tiny_model():
    cfg = {"reference": "mdfnet", "compute_dtype": "bfloat16",
           "model": {"chs": [8, 16, 32, 64], "ndepths": [48, 24, 8],
                     "ngroups": [32, 16, 8],
                     "curve_classes": [None, "gauss1", "laplace"],
                     "prob_threshs": [0.0, 0.95, 1e-5]}}
    shape = {"batch": 1, "views": 3, "height": 64, "width": 96}
    work = count.forward_work(cfg, shape, train=False)
    assert set(work) == set(mdfnet.LAYERS)
    # the first backbone conv alone: 3 -> 8, 3x3 on 3 views of 64x96
    first = count.conv_macs((3, 3, 64, 96), (3, 8, 64, 96), (8, 3, 3, 3),
                            (1, 1), (1, 1))
    assert work["Backbone"]["macs"] > first
    # the aggregate's visibility net is its only convolution: G + 1 MACs
    # a (point, source), its G -> 1 and its 1 -> 1 conv
    assert work["Homoaggre.0"]["macs"] == 48 * 8 * 12 * 2 * (32 + 1)
    # a train forward runs the same convolutions
    train = count.forward_work(cfg, shape, train=True)
    assert count.conv_flops(train) == count.conv_flops(work)
    assert all(w["bytes"] > 0 and w["params"] > 0 for w in work.values())


@pytest.mark.parametrize("name", sorted(PINNED))
def test_forward_work_of_each_cell_is_pinned(name):
    """Each cell's count at its own shapes, exactly: the rooflines and
    utilisations can move only with the traced times."""
    cell = harness.load_cell(name)
    kind = cell["cell"]["traffic"]
    work = count.forward_work(cell["cfg"], cell["cfg"][kind],
                              train=kind == "train")
    assert list(work) == list(PINNED[name])
    assert {k: tuple(v[f] for f in ("macs", "flops_f32", "bytes", "params"))
            for k, v in work.items()} == PINNED[name]
