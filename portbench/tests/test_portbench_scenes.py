"""The inputs and weights are a function of the seed alone."""
import torch

from portbench.lib import scenes, weights
from portbench.lib.harness import make_data
from portbench.reference.mdfnet import MDFNet

BIG = 2 ** 31 + 12345          # seeds reach past 32 signed bits
MIX = {"generator": "plane", "focal_per_width": 1.5, "view_span": 48.0}
SHAPE = {"views": 3, "height": 32, "width": 48}


def test_scenes_are_deterministic_by_seed():
    for gen in ("plane", "structured"):
        mix = dict(MIX, generator=gen)
        a = make_data(SHAPE, mix, 4, BIG, "cpu")
        b = make_data(SHAPE, mix, 4, BIG, "cpu")
        c = make_data(SHAPE, mix, 4, BIG + 1, "cpu")
        assert torch.equal(a["imgs"], b["imgs"])
        assert torch.equal(a["ref_depths"]["0"], b["ref_depths"]["0"])
        assert not torch.equal(a["imgs"], c["imgs"])
        assert all(bool(torch.isfinite(v).all()) for k, v in a.items()
                   if k != "ref_depths")


def test_every_seed_draws_the_same_stratified_set():
    for seed in (0, 7, BIG):
        p = scenes.draw(seed, 8)
        assert sorted(p["structure"]) == sorted(scenes.STRUCTURES * 2)
        bins = sorted(int((b - 560.0) / 200.0 * 8) for b in p["base"])
        assert bins == list(range(8))


def test_ranges_that_follow_depth_hold_each_scene_and_differ():
    data = scenes.plane_scenes(5, 4, 2, 16, 24, focal=36.0, baseline=12.0,
                               device="cpu", range_follows_depth=True)
    lo, hi = data["depth_range"][:, :1, None], data["depth_range"][:, 1:, None]
    assert bool(((data["depth"] > lo) & (data["depth"] < hi)).all())
    mids = sorted(float(m) for m in data["depth_range"].mean(1))
    assert [round(b - a) for a, b in zip(mids, mids[1:])] == [50, 50, 50]
    fixed = scenes.plane_scenes(5, 4, 2, 16, 24, focal=36.0, baseline=12.0,
                                device="cpu")
    assert torch.equal(fixed["imgs"], data["imgs"])
    assert bool((fixed["depth_range"] == torch.tensor(
        scenes.DEPTH_RANGE)).all())


def test_structured_depth_is_the_visible_surface():
    data = scenes.structured_scenes(3, 4, 2, 16, 24, focal=36.0,
                                    baseline=12.0, device="cpu")
    z = data["depth"]
    assert bool(((z > 425.0) & (z < 935.0)).all())
    assert data["imgs"].shape == (4, 2, 16, 24, 3)


def test_weights_are_deterministic_by_seed():
    with torch.device("meta"):
        model = MDFNet()
    a = weights.make_state(model, BIG, "cpu", sharpen=True)
    b = weights.make_state(model, BIG, "cpu", sharpen=True)
    c = weights.make_state(model, BIG + 1, "cpu", sharpen=True)
    assert a.keys() == model.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Backbone.conv01.0.conv.weight"],
                           c["Backbone.conv01.0.conv.weight"])
    w = a["Backbone.conv01.0.conv.weight"]
    assert float(w.abs().max()) <= 1.0 / 27 ** 0.5
