"""The eval forward cut into segments and replayed as CUDA graphs
(``mdfnet_tpu_torch/models/graphs.py``), and the host copies it removed
from the forward (``geometry.scale_intrinsics``, ``refined_hypotheses``).

On the CPU: the removed copies' replacements keep the bits, the segmented
eager forward is the unsegmented one bit for bit, the rule of when graphs
run, the module segments' replay inside ``module(...)``, and the key.
The tests marked ``cuda`` skip without a card; they capture and replay the
forward there. Nothing here imports JAX, so on a GPU machine:

    python -m pytest tests/test_torch_graphs.py -q -m cuda --noconftest
"""
import copy
import math
import types

import pytest
import torch
from torch import nn

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.config import ModelConfig
from mdfnet_tpu_torch.data import make_batch, make_plane_scene
from mdfnet_tpu_torch.models import graphs
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.ops import fitting
from mdfnet_tpu_torch.ops.regress import (confidence_regression,
                                          depth_regression)
from mdfnet_tpu_torch.ops.sample import resize_bilinear_2x, resize_nearest_2x
from mdfnet_tpu_torch.parallel import halo
from mdfnet_tpu_torch.utils import tracing

INPUTS = ("imgs", "extrinsics", "intrinsics", "depth_range")
CONFIGS = {
    "vector-fit-refine2": ModelConfig(),
    "variance-atv-refine1": ModelConfig(aggregate_impl="variance",
                                        hypo_impl="atv",
                                        refine_impl="refine1")}
SPECIAL = [0.0, -0.0, 1e-45, -1e-45, 1e-7, 3.5, -2.25, 1e30, -1e30,
           math.inf, -math.inf, math.nan]


# two scenes: a fronto-parallel plane and a nearer tilted one
SCENES = [dict(plane_depth=600.0), dict(plane_depth=520.0, tilt=0.3)]


def _args(device="cpu", height=64, width=96, nviews=3, scene=0, batch=1):
    scene = make_plane_scene(height=height, width=width, nviews=nviews,
                             **SCENES[scene])
    data = make_batch(scene, batch=batch)
    return [torch.from_numpy(data[k]).to(device) for k in INPUTS]


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


# ------------------------------------------------------------ the copies

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_scale_intrinsics_keeps_the_tensor_products_bits(dtype, stage):
    """Rows x and y times a Python power of two, row 3 as it is: the bits
    of the product with a [f, f, 1] tensor, special values included."""
    g = torch.Generator().manual_seed(stage)
    k = torch.randn(2, 5, 3, 3, generator=g, dtype=dtype) * 1e3
    k.view(-1)[:len(SPECIAL)] = torch.tensor(SPECIAL, dtype=dtype)
    factor = 1.0 / (2.0 ** (3 - stage))
    want = k * torch.tensor([factor, factor, 1.0], dtype=dtype).reshape(3, 1)
    assert _bits_equal(geometry.scale_intrinsics(k, stage), want)


def _refined_with_tensor_floor(depth, depth_range, prob, hypos, *, ndepths,
                               curve_class, prob_thresh):
    """``refined_hypotheses`` with its floor as a tensor of 1e-6, as the
    function had it before (one host-to-device copy a call)."""
    dmin, dmax = depth_range[:, 0].float(), depth_range[:, 1].float()
    s = resize_bilinear_2x(fitting._FITTERS[curve_class](depth, prob, hypos))
    depth = resize_bilinear_2x(depth.float())
    log_t = float(torch.log(torch.tensor(prob_thresh, dtype=torch.float32)))
    res = (torch.sqrt(-1.0 * s * log_t) if curve_class != "laplace"
           else torch.abs(s * log_t))
    res = torch.minimum(torch.maximum(res, res.new_tensor(1e-6)),
                        (dmax.max() - dmin.min()) / 2.0)
    res = torch.minimum(res, ((dmax - dmin) * 0.2)[:, None, None])
    steps = torch.arange(ndepths, dtype=torch.float32).reshape(
        1, ndepths, 1, 1)
    out = (depth - 0.5 * res)[:, None] + (res / (ndepths - 1))[:, None] \
        * steps
    return torch.minimum(torch.maximum(out, dmin[:, None, None, None]),
                         dmax[:, None, None, None])


@pytest.mark.parametrize("curve_class,thresh", [("gauss0", 0.95),
                                                ("gauss1", 0.95),
                                                ("laplace", 1e-5)])
def test_refined_hypotheses_keeps_the_tensor_floors_bits(curve_class,
                                                         thresh):
    """``clamp_min(1e-6)`` for ``maximum(res, new_tensor(1e-6))``: the same
    bits through the whole function, and on special values alone (NaN
    stays NaN)."""
    g = torch.Generator().manual_seed(7)
    b, d, h, w = 2, 8, 6, 10
    logits = torch.randn(b, d, h, w, generator=g) * 3.0
    logits[0, :, 0, 0] = 0.0                       # flat: the floor binds
    prob = torch.softmax(logits, dim=1)
    drange = torch.tensor([[425.0, 935.0], [300.0, 500.0]])
    hypos = drange[:, :1, None, None] + torch.rand(b, d, h, w, generator=g) \
        .sort(dim=1).values * (drange[:, 1:] - drange[:, :1])[..., None, None]
    depth = depth_regression(prob, hypos)
    kw = dict(ndepths=5, curve_class=curve_class, prob_thresh=thresh)
    got = fitting.refined_hypotheses(depth, drange, prob, hypos, **kw)
    want = _refined_with_tensor_floor(depth, drange, prob, hypos, **kw)
    assert _bits_equal(got, want)
    x = torch.tensor(SPECIAL + [1e-6, 9.9e-7], dtype=torch.float32)
    assert _bits_equal(x.clamp_min(1e-6), torch.maximum(x, x.new_tensor(1e-6)))


# ------------------------------------------------------------ eager

def _unsegmented(model, imgs, extrinsics, intrinsics, depth_range):
    """The eval forward as one body, as CoreNet ran it before it was cut
    into segments."""
    b, v = imgs.shape[:2]
    nstages = len(model.ndepths)
    with torch.no_grad():
        fs = model.Backbone(imgs.reshape((b * v,) + imgs.shape[2:])
                            .to(model.dtype))
        intrinsics, extrinsics = intrinsics.float(), extrinsics.float()
        depth = hypos = prob = None
        kw = {"diffs": True} if model.Backbone.emit_diffs else {}
        for stage in range(nstages):
            ref_proj, src_projs = geometry.projection_matrices(
                intrinsics, extrinsics, stage, num_stages=nstages + 1)
            hypos = model._hypotheses(stage, depth_range, depth, prob, hypos)
            feats = fs[stage].reshape((b, v) + fs[stage].shape[1:])
            cost = model.Homoaggre[stage](feats, ref_proj, src_projs, hypos,
                                          **kw)
            prob = model.Regular[stage](cost.to(model.dtype))
            depth = depth_regression(prob, hypos)
        depth = model._refine(imgs, depth, depth_range, False, False)
        confidence = resize_nearest_2x(confidence_regression(prob))
    return depth, confidence


@pytest.mark.parametrize("name", list(CONFIGS))
def test_segmented_eager_forward_is_the_unsegmented_one(name):
    """On the CPU the forward runs eager through the segments: the bits of
    the forward as one body, counted as eager for the reason ``cpu``, with
    no capture and no replay."""
    model = build_model(CONFIGS[name], seed=0, device="cpu")
    args = _args(batch=2)
    before = copy.deepcopy(tracing.GRAPHS)
    out = model(*args)
    out2 = model(*args)
    depth, confidence = _unsegmented(model, *args)
    for got in (out, out2):
        assert _bits_equal(got["depth"], depth)
        assert _bits_equal(got["confidence"], confidence)
        assert bool(got["coverage_ok"])
    assert tracing.GRAPHS["eager"]["cpu"] == before["eager"]["cpu"] + 2
    for k in ("captures", "replays", "pool_bytes"):
        assert tracing.GRAPHS[k] == before[k]
    assert model._graphs._entries == {}


def test_recorded_eager_forward_opens_no_graph_span():
    model = build_model(seed=0, device="cpu")
    with tracing.recording() as spans:
        model(*_args())
    assert not any(s.name.startswith("graph/") for s in spans)


@pytest.mark.parametrize("case,want", [
    (dict(train=True), "train"), (dict(train=True, cuda=False), "train"),
    (dict(cuda=False), "cpu"), (dict(cuda=False, plain=True), "cpu"),
    (dict(plain=True), "plain"), (dict(halo=True), "halo"),
    (dict(plain=True, halo=True), "plain"), ({}, None)])
def test_when_graphs_run(case, want):
    """Graphs only for the eval forward on CUDA tensors, not plain, outside
    spatial sharding; otherwise the reason it stays eager."""
    imgs = types.SimpleNamespace(is_cuda=case.get("cuda", True))
    token = halo._CTX.set(halo.SpatialCtx(None, 0, 2) if case.get("halo")
                          else None)
    try:
        assert graphs.eager_reason(imgs, case.get("plain", False),
                                   case.get("train", False)) == want
    finally:
        halo._CTX.reset(token)


def test_train_forward_counts_as_eager():
    model = build_model(seed=0, device="cpu").requires_grad_(True)
    before = tracing.GRAPHS["eager"]["train"]
    model(*_args(), train=True)
    assert tracing.GRAPHS["eager"]["train"] == before + 1


def _hook(where, model, fired):
    """A forward hook or pre-hook at ``where``: on a conv inside the first
    U-Net (below a segment), on that U-Net (a segment), or global."""
    def pre(m, _a):
        fired.append(m)

    def post(m, _a, _o):
        fired.append(m)
    inner, seg = model.Regular[0].conv01[0], model.Regular[0]
    return {"nested pre": lambda: inner.register_forward_pre_hook(pre),
            "nested": lambda: inner.register_forward_hook(post),
            "segment": lambda: seg.register_forward_hook(post),
            "global pre": lambda: nn.modules.module
            .register_module_forward_pre_hook(pre),
            "global": lambda: nn.modules.module
            .register_module_forward_hook(post)}[where]()


@pytest.mark.parametrize("where,eager", [
    ("nested pre", True), ("nested", True), ("global pre", True),
    ("global", True), ("segment", False)])
def test_hooks_the_replay_would_skip_run_the_forward_eager(where, eager):
    """A hook on a module below a segment, or a global one, would not fire
    under replay: the graphs' forward then runs eager (reason ``hooks``)
    and keeps no key, with the hook fired and the eager bits; a segment's
    own hook runs around the replay, so the call goes on as a first call.
    Without the hook the graphs engage again."""
    model = build_model(seed=0, device="cpu")
    args = _args()
    want = model(*args)
    eg, fired = model._graphs, []
    handle = _hook(where, model, fired)
    before = copy.deepcopy(tracing.GRAPHS)
    try:
        with torch.no_grad():
            got = eg.forward(model, *args)
        eg._weights(model)
        assert eg._hooked() == eager
    finally:
        handle.remove()
    assert fired
    for k in ("depth", "confidence"):
        assert _bits_equal(got[k], want[k]), k
    reason = "hooks" if eager else "first_call"
    assert tracing.GRAPHS["eager"][reason] == before["eager"][reason] + 1
    assert len(eg._entries) == (0 if eager else 1)
    assert not eg._hooked()


# ------------------------------------------------------------ module steps

class _Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(3.0))

    def forward(self, x, plain=False):
        return x * self.w


class _FakeGraph:
    """A stand-in for a CUDA graph on the CPU: its replay reruns the
    module's class forward into the step's output buffer."""

    def __init__(self, module, args):
        self.module, self.args, self.out, self.replays = module, args, None, 0

    def replay(self):
        self.replays += 1
        self.out.copy_(type(self.module).forward(self.module, *self.args))


def _step(x):
    module = _Scale()
    graph = _FakeGraph(module, (x,))
    graph.out = torch.empty_like(x)
    return module, graph, graphs._ModuleStep("scale", graph, module, (x,),
                                             {"plain": False}, graph.out)


def test_module_step_replays_inside_the_call_with_its_hooks():
    """The module's pre-hook sees the step's inputs, its hook the replayed
    output, the replay lies inside ``graph/<name>``, and the module's own
    forward is back afterwards (the class's, or one set on the instance)."""
    x = torch.arange(4.0)
    module, graph, step = _step(x)
    seen = []
    module.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    module.register_forward_hook(lambda m, a, o: seen.append(o.clone()))
    with tracing.recording() as spans:
        step()
    assert graph.replays == 1 and seen[0] is x
    assert torch.equal(seen[1], x * 3.0) and torch.equal(step.out, x * 3.0)
    assert [s.name for s in spans] == ["graph/scale"]
    assert "forward" not in module.__dict__
    own = module.forward
    module.forward = lambda *a, **k: None
    mine = module.__dict__["forward"]
    step()
    assert module.__dict__["forward"] is mine and graph.replays == 2
    module.forward = own


def test_module_step_refuses_hooks_that_replace_tensors():
    x = torch.arange(4.0)
    module, graph, step = _step(x)
    handle = module.register_forward_pre_hook(lambda m, a: (a[0] + 1,))
    with pytest.raises(RuntimeError, match="replaced its inputs"):
        step()
    handle.remove()
    handle = module.register_forward_hook(lambda m, a, o: o + 1)
    with pytest.raises(RuntimeError, match="replaced its output"):
        step()
    handle.remove()
    assert "forward" not in module.__dict__
    step()
    assert graph.replays == 2


def test_released_tensors_are_aliases_that_do_not_own():
    """``transient``: the step holds an alias over the same memory that
    keeps nothing allocated, so the step still passes it to the module."""
    x = torch.arange(6.0).reshape(2, 3)[:, 1:]
    module, graph, step = _step(x)
    step.release({id(x)})
    alias = step.args[0]
    assert alias is not x and alias.data_ptr() == x.data_ptr()
    assert alias.shape == x.shape and alias.stride() == x.stride()
    assert torch.equal(alias, x)
    x.mul_(2.0)                          # the alias sees what x holds
    assert torch.equal(alias, x)
    graph.args = step.args
    step()
    assert torch.equal(step.out, x * 3.0)


# ------------------------------------------------------------ the key

def test_key_follows_each_weights_storage_and_version():
    """A weight written in place (its version) or replaced (its storage),
    and a submodule replaced, each give another key; a forward does not."""
    model = build_model(seed=0, device="cpu")
    eg = model._graphs
    k0 = eg._weights(model)
    model(*_args())
    assert eg._weights(model) == k0
    model.load_state_dict(model.state_dict())
    k1 = eg._weights(model)
    assert k1 != k0 and len(k1) == len(k0)
    conv = model.Refine.conv0
    conv.weight = nn.Parameter(conv.weight.detach().clone())
    k2 = eg._weights(model)
    assert k2 not in (k0, k1)
    model.Regular[2] = copy.deepcopy(model.Regular[2])
    k3 = eg._weights(model)
    assert k3 not in (k0, k1, k2) and len(k3) == len(k0)


def test_keys_are_bounded_least_recent_first():
    eg = graphs.EvalGraphs()
    for i in range(graphs.MAX_KEYS + 3):
        eg._keep(("key", i), None)
    assert list(eg._entries) == [("key", i) for i in
                                 range(3, graphs.MAX_KEYS + 3)]


def test_a_model_with_graphs_copies_and_pickles():
    model = build_model(seed=0, device="cpu")
    model._graphs._keep(("key",), None)
    twin = copy.deepcopy(model)
    assert twin._graphs is not model._graphs and twin._graphs._entries == {}
    import pickle
    assert pickle.loads(pickle.dumps(model))._graphs._entries == {}


# ------------------------------------------------------------ on the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _fresh(config=None, dtype="bfloat16", seed=0):
    return build_model(config or ModelConfig(), compute_dtype=dtype,
                       seed=seed, device="cuda")


def _calls(model, args, n):
    outs = []
    for _ in range(n):
        out = model(*args)
        outs.append({k: v.clone() for k, v in out.items()})
    torch.cuda.synchronize()
    return outs


class _Stages:
    """The benchmark's hooks: each stage's hypotheses (the aggregate's
    fourth input) and probability volume (the U-Net's output)."""

    def __init__(self, model):
        n = len(model.ndepths)
        self.hypos, self.probs, self.calls = [None] * n, [None] * n, 0
        self.handles = []
        for s in range(n):
            self.handles.append(model.Homoaggre[s].register_forward_pre_hook(
                lambda _m, a, s=s: self.hypos.__setitem__(s, a[3])))
            self.handles.append(model.Regular[s].register_forward_hook(
                lambda _m, _a, o, s=s: self._prob(s, o)))

    def _prob(self, s, o):
        self.calls += 1
        self.probs[s] = o

    def depths(self):
        return [(p * h).sum(1).clone() for p, h in zip(self.probs,
                                                        self.hypos)]

    def close(self):
        for h in self.handles:
            h.remove()


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("vector-fit-refine2", "bfloat16"),
                                        ("variance-atv-refine1", "float32")])
def test_replays_are_the_eager_forward(card, name, dtype):
    """First call eager, second captured and replayed, third replayed: the
    same bits each time, one capture, two replays (in f32 the U-Nets take
    the cost volume as it is: no cast segment)."""
    model = _fresh(CONFIGS[name], dtype)
    args = _args(card, 128, 160, 3)
    before = copy.deepcopy(tracing.GRAPHS)
    eager, captured, replayed = _calls(model, args, 3)
    assert tracing.GRAPHS["eager"]["first_call"] == \
        before["eager"]["first_call"] + 1
    assert tracing.GRAPHS["captures"] == before["captures"] + 1
    assert tracing.GRAPHS["replays"] == before["replays"] + 2
    assert tracing.GRAPHS["pool_bytes"] > before["pool_bytes"]
    for out in (captured, replayed):
        for k in ("depth", "confidence"):
            assert _bits_equal(out[k], eager[k]), k
        assert bool(out["coverage_ok"])


@pytest.mark.cuda
def test_scenes_in_turn_get_their_own_answers_and_hooks(card):
    """Scenes A, B, A, B through one model's graphs: each map equals that
    scene's eager forward (a fresh model's first call), its hooks fired
    with its own stage tensors, and an earlier map's outputs are not
    touched by the next call."""
    scenes = [_args(card, 128, 160, 3, scene=s) for s in (0, 1)]
    model = _fresh()
    model(*scenes[0])                                    # eager: warm
    eager, eager_depths = [], []
    for args in scenes:
        twin = _fresh()
        stages = _Stages(twin)
        eager.append(twin(*args))
        eager_depths.append(stages.depths())
        stages.close()
    kept = []
    for turn in range(4):
        i = turn % 2
        stages = _Stages(model)
        out = model(*scenes[i])
        depths = stages.depths()
        stages.close()
        assert stages.calls == len(model.ndepths)
        for k in ("depth", "confidence"):
            assert _bits_equal(out[k], eager[i][k]), (turn, k)
        for got, want in zip(depths, eager_depths[i]):
            assert _bits_equal(got, want), turn
        kept.append((out, {k: out[k].clone() for k in ("depth",
                                                        "confidence")}))
    torch.cuda.synchronize()
    for out, copies in kept:
        for k, v in copies.items():
            assert _bits_equal(out[k], v)
    assert len(model._graphs._entries) == 1


@pytest.mark.cuda
def test_new_weights_and_shapes_capture_again_within_the_bound(card):
    """A replaced weight and a weight written in place are new keys (eager
    once, then captured) whose answers follow the new weights; another
    input shape gets graphs of its own; no more than MAX_KEYS are kept and
    the dropped ones' pool bytes leave the counter."""
    model = _fresh()
    args = _args(card, 128, 160, 3)
    _calls(model, args, 2)
    conv = model.Refine.conv0
    conv.weight = nn.Parameter(conv.weight.detach() * 0.5)
    captures = tracing.GRAPHS["captures"]
    first, second = _calls(model, args, 2)
    assert tracing.GRAPHS["captures"] == captures + 1
    twin = _fresh()
    twin.load_state_dict(model.state_dict())
    want = twin(*args)
    assert _bits_equal(second["depth"], first["depth"])
    assert _bits_equal(second["depth"], want["depth"])
    with torch.no_grad():
        model.Refine.conv0.weight.mul_(2.0)         # in place: its version
    _, again = _calls(model, args, 2)
    assert tracing.GRAPHS["captures"] == captures + 2
    twin.load_state_dict(model.state_dict())
    assert _bits_equal(again["depth"], twin(*args)["depth"])
    def held():
        return sum(e.pool_bytes for e in model._graphs._entries.values()
                   if e is not None)
    others = tracing.GRAPHS["pool_bytes"] - held()
    for width in (96, 128, 192, 224, 256):
        _calls(model, _args(card, 64, width, 3), 2)
        assert len(model._graphs._entries) <= graphs.MAX_KEYS
    assert len(model._graphs._entries) == graphs.MAX_KEYS
    assert all(e is not None for e in model._graphs._entries.values())
    assert tracing.GRAPHS["pool_bytes"] - held() == others


@pytest.mark.cuda
def test_a_hook_below_a_segment_runs_eager_then_replay_resumes(card):
    """On a model that replays, a pre-hook on a conv inside a U-Net makes
    the call eager: it fires with that map's input and the map has the
    replay's bits; once it is removed the next call replays, captured
    nothing anew."""
    model = _fresh()
    args = _args(card, 128, 160, 3)
    replayed = _calls(model, args, 3)[-1]
    seen = []
    inner = model.Regular[0].conv01[0]
    handle = inner.register_forward_pre_hook(
        lambda _m, a: seen.append(a[0].clone()))
    before = copy.deepcopy(tracing.GRAPHS)
    try:
        hooked = _calls(model, args, 1)[0]
    finally:
        handle.remove()
    assert tracing.GRAPHS["eager"]["hooks"] == before["eager"]["hooks"] + 1
    assert tracing.GRAPHS["replays"] == before["replays"]
    assert len(seen) == 1 and seen[0].is_cuda
    for k in ("depth", "confidence"):
        assert _bits_equal(hooked[k], replayed[k]), k
    again = _calls(model, args, 1)[0]
    assert tracing.GRAPHS["replays"] == before["replays"] + 1
    assert tracing.GRAPHS["captures"] == before["captures"]
    assert _bits_equal(again["depth"], replayed["depth"])


@pytest.mark.cuda
def test_train_plain_and_halo_stay_eager(card):
    model = _fresh()
    args = _args(card, 64, 96, 3)
    before = copy.deepcopy(tracing.GRAPHS)
    for _ in range(2):
        model(*args, plain=True)
    model.requires_grad_(True)
    for _ in range(2):
        model(*args, train=True)
    assert tracing.GRAPHS["eager"]["plain"] == before["eager"]["plain"] + 2
    assert tracing.GRAPHS["eager"]["train"] == before["eager"]["train"] + 2
    assert tracing.GRAPHS["captures"] == before["captures"]
    assert model._graphs._entries == {}
    token = halo._CTX.set(halo.SpatialCtx(None, 0, 2))
    try:
        assert graphs.eager_reason(args[0], False, False) == "halo"
    finally:
        halo._CTX.reset(token)


@pytest.mark.cuda
def test_no_blocking_call_inside_an_eval_forward(card, tmp_path):
    """Profiled, neither an eager forward nor a replayed one makes a call
    of ``tracing.WAITS`` inside its ``forward`` span; the replay's spans
    are ``graph/<segment>`` in run order, the module segments' inside the
    module's call."""
    from torch.profiler import ProfilerActivity, profile
    args = _args(card, 128, 160, 3)
    _fresh()(*args)                                   # builds the kernels
    model = _fresh()
    torch.cuda.synchronize()
    for i in range(2):                  # the eager call; two replays
        path = str(tmp_path / f"trace{i}.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(1 + i):
                model(*args)
            torch.cuda.synchronize()
        if i == 0:
            model(*args)                                 # the capture
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        read = tracing.read_trace(path)
        assert [w for w in read.waits if "forward" in w[4]] == [], i
    with tracing.recording() as spans:
        model(*args)
    names = [s.name for s in spans if s.name.startswith("graph/")]
    assert names[:4] == ["graph/backbone", "graph/hypotheses.0",
                         "graph/aggregate.0", "graph/cast.0"]
    assert names[-2:] == ["graph/refine", "graph/confidence"]
    assert len(names) == 1 + 5 * len(model.ndepths) + 2
