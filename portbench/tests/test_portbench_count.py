"""The work counts that the rooflines and utilisations read, against hand
counts at tiny shapes."""
import torch
import torch.nn.functional as F

from portbench.lib import count
from portbench.lib.peaks import PEAKS


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
    assert count.trconv_macs(x.shape, w.shape) == int(y.sum())
    assert count.trconv_macs((2, 4, 3, 4, 5), (4, 6, 3, 3, 3)) == \
        2 * 4 * 6 * 8 * 11 * 14


def test_aggregate_ops_formula():
    # per point: 3G sigmoids, per source 38 + 21G, G divisions
    assert count.aggregate_ops(10, 4, 8) == 10 * (24 + 4 * (38 + 168) + 8)


def test_least_ms_takes_the_larger_bound():
    ops_bound = {"macs": 989e9 / 2, "flops_f32": 0, "bytes": 1.0, "params": 0}
    assert abs(count.least_ms(ops_bound) - 1.0) < 1e-9
    assert count.bound_by(ops_bound) == "operations"
    bytes_bound = {"macs": 0, "flops_f32": 0,
                   "bytes": PEAKS["hbm_bytes_per_s"] * 2e-3, "params": 0}
    assert abs(count.least_ms(bytes_bound, passes=3) - 6.0) < 1e-9
    assert count.bound_by(bytes_bound) == "bytes"


def test_forward_work_counts_every_conv_of_the_tiny_model():
    cfg = {"compute_dtype": "bfloat16",
           "model": {"chs": [8, 16, 32, 64], "ndepths": [48, 24, 8],
                     "ngroups": [32, 16, 8],
                     "curve_classes": [None, "gauss1", "laplace"],
                     "prob_threshs": [0.0, 0.95, 1e-5]}}
    shape = {"batch": 1, "views": 3, "height": 64, "width": 96}
    work = count.forward_work(cfg, shape, train=False)
    assert set(work) == set(count.LAYERS)
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
