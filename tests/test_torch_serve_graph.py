"""The fast serving call replayed as one CUDA graph (``predict._ServeGraph``)
and decode's variances kept on the device.

On the CPU: ``decode_outputs`` copies nothing after its first call and
computes what it did with a fresh ``torch.tensor`` of the variances; predict
fns off the card run eager at every call; and the graph's rules (an eager
call, a capture, replays; a new key drops the graph) with ``torch.cuda``'s
graph replaced by one that runs the captured body again on the static input,
into the static outputs. On the card (marked ``cuda``, skipped without one):
the graph serves the eager path's bits, recaptures after a weight write or a
new batch shape, and a replay runs the serving kernels (counted in its
profile) while the kernel wrappers' ``launches`` count host launches only.

This file imports no JAX, so that its ``cuda`` cases run on the card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_serve_graph.py``.
"""

import contextlib
from pathlib import Path

import pytest
import torch
from torch.autograd.graph import increment_version
from torch.overrides import TorchFunctionMode

import tpurpn_torch as T
from tpurpn_torch import cache, predict, profiling
from tpurpn_torch.boxes import get_bboxes_from_deltas
from tpurpn_torch.kernels.ir_stage import fused_ir_stage
from tpurpn_torch.kernels.prefix import prefix_depthwise, prefix_pointwise
from tpurpn_torch.kernels.proposal import fused_proposals
from tpurpn_torch.predict import _ServeGraph, decode_outputs, make_predict_fn

REPO = Path(__file__).resolve().parents[1]
TRAINED = REPO / "trained" / "rpn_mobilenet_v2_trained.npz"
KEYS = ("roi_boxes", "roi_scores", "num_valid")
# the kernel wrappers of a fast serving call and their launches in one
SERVING_KERNELS = (prefix_pointwise, prefix_depthwise, fused_ir_stage, fused_proposals)
LAUNCHES = (13, 7, 7, 1)
# the kernels a replay runs on the card, by name
REPLAYED = {"prefix_pointwise_kernel": 13, "prefix_depthwise_kernel": 7, "ir_block_kernel": 6,
            "ir_expand_kernel": 1, "proposal_kernel": 1}


class _Copies(TorchFunctionMode):
    """Counts ``torch.tensor`` and ``Tensor.to`` calls."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.tensor, torch.Tensor.to):
            self.count += 1
        return func(*args, **(kwargs or {}))


def _head_outputs(hp, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = len(hp.anchor_ratios) * len(hp.anchor_scales)
    fm = hp.feature_map_shape
    reg = torch.randn((2, fm, fm, 4 * A), generator=g)
    cls = torch.randn((2, fm, fm, A), generator=g)
    return T.generate_anchors(hp, "cpu"), reg, cls


def test_decode_outputs_copies_nothing_after_its_first_call():
    hp = T.get_hyper_params("mobilenet_v2", img_size=64)
    anchors, reg, cls = _head_outputs(hp)
    predict._variances.cache_clear()
    counts, outs = [], []
    for _ in range(3):
        with _Copies() as copies:
            outs.append(decode_outputs(anchors, reg, cls, hp))
        counts.append(copies.count)
    assert counts[0] > 0 and counts[1:] == [0, 0], counts
    # the formula with a fresh tensor of the variances, as before
    deltas = reg.reshape(2, -1, 4) * torch.tensor(hp.variances, dtype=torch.float32)
    ref = (get_bboxes_from_deltas(anchors[None], deltas), torch.sigmoid(cls.reshape(2, -1)))
    for boxes, scores in outs:
        assert torch.equal(boxes, ref[0]) and torch.equal(scores, ref[1])


def test_decode_variances_made_under_inference_mode_serve_autograd():
    """The cached variances are a normal tensor: autograd can save them."""
    hp = T.get_hyper_params("mobilenet_v2", img_size=64)
    anchors, reg, cls = _head_outputs(hp, seed=1)
    predict._variances.cache_clear()
    with torch.inference_mode():
        decode_outputs(anchors, reg, cls, hp)
    reg.requires_grad_(True)
    boxes, _ = decode_outputs(anchors, reg, cls, hp)
    boxes.sum().backward()
    assert reg.grad is not None and torch.isfinite(reg.grad).all()


def _folded(img=64):
    hp = T.get_hyper_params("mobilenet_v2", img_size=img)
    model = T.init_model(T.get_model(hp), torch.Generator().manual_seed(0), device="cpu")
    return hp, T.fold_batch_norm(model)


@pytest.mark.parametrize("fast,from_uint8", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_predict_fn_off_the_card_runs_eager(fast, from_uint8):
    hp, model = _folded()
    g = torch.Generator().manual_seed(2)
    if from_uint8:
        x = torch.randint(0, 256, (2, 48, 64, 3), dtype=torch.uint8, generator=g)
    else:
        x = torch.rand((2, 64, 64, 3), generator=g).to(torch.bfloat16)
    fn = make_predict_fn(model, hp, fast=fast, from_uint8=from_uint8, device="cpu")
    outs = [fn(x) for _ in range(3)]
    assert (fn.eager_calls, fn.captures, fn.replays) == (3, 0, 0)
    for out in outs[1:]:
        assert all(torch.equal(out[k], outs[0][k]) for k in KEYS)


# --- the graph's rules, with a stand-in for torch.cuda's graph ----------------


class _FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: the body seen in its capture runs
    again at each replay, on the static input, into the static outputs, and
    without its Python side (the launch counts)."""

    capturing = None

    def replay(self):
        x, out, compute = self.captured
        for k, v in compute(x).items():
            out[k].copy_(v)


@contextlib.contextmanager
def _fake_capture(graph):
    _FakeGraph.capturing = graph
    try:
        yield
    finally:
        _FakeGraph.capturing = None


class _Counts:
    eager_calls = captures = replays = 0


def _tiny_model(inference=False):
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode(inference):
        model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4)).eval()
        with torch.no_grad():
            for t in (model[0].weight, model[0].bias, model[1].running_mean):
                t.copy_(torch.rand(t.shape, generator=g) - 0.5)
    return model


def _compute(model):
    def compute(x):
        y = model(x.to(model[0].weight.dtype).mean((1, 2)))
        return {"y": y, "best": y.argmax(1)}
    return compute


@pytest.fixture
def graph(monkeypatch):
    """A ``_ServeGraph`` on the CPU over a tiny model, with the stand-in
    graph; its body counts the fast serving call's launches on the host."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    for kernel in SERVING_KERNELS:
        monkeypatch.setattr(kernel, "launches", 0)

    def make(model):
        compute = _compute(model)

        def body(x):
            out = compute(x)
            for kernel, n in zip(SERVING_KERNELS, LAUNCHES):
                kernel.launches += n
            if _FakeGraph.capturing is not None:
                _FakeGraph.capturing.captured = (x, out, compute)
            return out

        return _ServeGraph(model, torch.device("cpu"), body, _Counts())
    return make


def _frames(seed, batch=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (batch, 6, 5, 3), dtype=torch.uint8, generator=g)


def _calls(sg):
    return sg.counts.eager_calls, sg.counts.captures, sg.counts.replays


def _same(got, ref):
    return all(torch.equal(got[k], ref[k]) for k in ref)


def test_an_eager_call_a_capture_then_replays(graph):
    model = _tiny_model()
    sg, compute = graph(model), _compute(model)
    kept = []
    with torch.no_grad():
        for i in range(6):
            out = sg(_frames(i))
            assert _same(out, compute(_frames(i)))
            kept.append((out, {k: v.clone() for k, v in out.items()}))
    assert _calls(sg) == (1, 1, 4)
    for out, copy in kept:  # not overwritten by the calls after it
        assert _same(out, copy)
        assert all(out[k] is not sg.out[k] for k in out)
    # host launches: the eager call's and the capture's, none at a replay
    assert [k.launches for k in SERVING_KERNELS] == [2 * n for n in LAUNCHES]


def _change(kind, model):
    """Apply a change of the key's weights (None for a change of the input)."""
    if kind == "in_place":
        model[0].weight.mul_(-1.5)
    elif kind == "behind_autograd":  # as a collective or a graph writes, then the bump
        model[0].weight.data.mul_(-1.5)
        increment_version(model[0].weight)
    elif kind == "replaced":
        model[0].weight = torch.nn.Parameter(model[0].weight * -1.5)
    elif kind == "replaced_buffer":
        model[1].running_mean = model[1].running_mean + 0.25
    elif kind == "replaced_module":
        linear = torch.nn.Linear(3, 4)
        linear.load_state_dict(model[0].state_dict())
        linear.weight.mul_(-1.5)
        model[0] = linear
    elif kind == "new_storage":
        model[0].weight.data = model[0].weight.data * -1.5
    elif kind == "buffer":
        model[1].running_mean.add_(0.25)
    elif kind == "cache_cleared":
        cache.clear()


INPUTS = {"batch_shape": lambda f: f[:2], "dtype": lambda f: f.float()}
CHANGES = ("in_place", "behind_autograd", "replaced", "replaced_buffer", "replaced_module",
           "new_storage", "buffer", "cache_cleared", *INPUTS)


@pytest.mark.parametrize("kind", CHANGES)
def test_a_new_key_runs_eager_then_captures_again(graph, kind):
    model = _tiny_model()
    sg, compute = graph(model), _compute(model)
    with torch.no_grad():
        for i in range(3):
            sg(_frames(i))
        assert _calls(sg) == (1, 1, 1)
        _change(kind, model)
        for i, n in enumerate(((2, 1, 1), (2, 2, 1), (2, 2, 2))):
            x = INPUTS.get(kind, lambda f: f)(_frames(3 + i))
            out = sg(x)
            assert _calls(sg) == n
            assert _same(out, compute(x))
        if kind not in INPUTS and kind != "cache_cleared":  # the new weights served
            assert not torch.equal(out["y"], _compute(_tiny_model())(x)["y"])


CONVERSIONS = {
    "double": lambda m: m.double(),
    "to": lambda m: m.to(torch.float64),
    "buffer_dict_write": lambda m: m[1]._buffers.__setitem__(
        "running_mean", m[1].running_mean + 0.25),
}


@pytest.mark.parametrize("kind", CONVERSIONS)
def test_buffers_that_module_apply_replaces_are_followed(graph, kind):
    """``Module._apply`` (``.double()``, ``.to()``) writes new buffers into
    the modules' dicts: the graph is captured again, and an in-place write
    to a new buffer later is seen too."""
    model = _tiny_model()
    sg, compute = graph(model), _compute(model)
    calls = iter([(1, 0, 0), (1, 1, 0), (1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2),
                  (3, 2, 2), (3, 3, 2), (3, 3, 3)])
    with torch.no_grad():
        for change in (None, CONVERSIONS[kind], lambda m: m[1].running_mean.add_(0.25)):
            if change is not None:
                change(model)
            for i in range(3):
                out = sg(_frames(i))
                assert _calls(sg) == next(calls)
                assert _same(out, compute(_frames(i)))
    assert any(t is model[1].running_mean for t in sg.tensors)


def test_an_assignment_to_another_module_keeps_the_graph(graph):
    model = _tiny_model()
    sg, compute = graph(model), _compute(model)
    with torch.no_grad():
        for i in range(4):
            if i == 2:
                _tiny_model()  # parameters and buffers assigned elsewhere
            assert _same(sg(_frames(i)), compute(_frames(i)))
    assert _calls(sg) == (1, 1, 2)


def test_inference_tensor_weights_run_eager_at_every_call(graph):
    model = _tiny_model(inference=True)
    sg, compute = graph(model), _compute(model)
    with torch.no_grad():
        for i in range(3):
            assert _same(sg(_frames(i)), compute(_frames(i)))
    assert _calls(sg) == (3, 0, 0)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the serving kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _served_model(card):
    from tpurpn_torch.io_utils import load_keras_h5_weights

    hp = T.get_hyper_params("mobilenet_v2")
    model, missing = load_keras_h5_weights(str(TRAINED), T.get_model(hp))
    assert not missing
    return hp, T.fold_batch_norm(T.model.to_device(model, card))


def _host_frames(seed, batch):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (batch, 375, 500, 3), dtype=torch.uint8, generator=g)


def _eager(model, hp, frames, card):
    """A fresh predict fn's first call: eager."""
    fn = make_predict_fn(model, hp, fast=True, from_uint8=True, device=card)
    out = fn(frames)
    assert (fn.eager_calls, fn.captures, fn.replays) == (1, 0, 0)
    return out


def _launches():
    return [k.launches for k in SERVING_KERNELS]


def _replayed_kernels(fn, frames, tries=3):
    """Kernels of ``REPLAYED`` that the card ran inside ``rpn.replay``'s
    device range in a traced call of ``fn`` (after a traced warm-up call,
    whose first launches the profiler can miss); traced again, up to
    ``tries`` times, while they differ from ``REPLAYED`` (the profiler can
    drop a launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traces.append(list(p.events()))) as prof, \
                profiling._on(annotate=True):
            for _ in range(2):
                fn(frames)
                torch.cuda.synchronize()
                prof.step()
        events = traces[-1] if traces else []
        ranges = [e.time_range for e in events
                  if e.name == "rpn.replay" and e.device_type == DeviceType.CUDA]
        found = dict.fromkeys(REPLAYED, 0)
        for e in events:
            if (e.device_type == DeviceType.CUDA and not e.is_user_annotation and len(ranges) == 1
                    and ranges[0].start <= e.time_range.start <= e.time_range.end
                    <= ranges[0].end):
                for name in found:
                    found[name] += name in e.name
        if found == REPLAYED:
            break
    return found


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 128])
def test_the_graph_serves_the_eager_bits_on_the_card(card, batch):
    hp, model = _served_model(card)
    fn = make_predict_fn(model, hp, fast=True, from_uint8=True, device=card)
    kept = []
    for i in range(6):
        frames = _host_frames(i, batch)
        before = _launches()
        out = fn(frames)
        torch.cuda.synchronize()
        # host launches: the eager call's and the capture's, none at a replay
        launched = [a - b for a, b in zip(_launches(), before)]
        assert launched == (list(LAUNCHES) if i < 2 else [0] * 4), i
        ref = _eager(model, hp, frames, card)
        assert _same(out, ref), i
        kept.append((out, ref))
    assert (fn.eager_calls, fn.captures, fn.replays) == (1, 1, 4)
    for out, ref in kept:  # not overwritten by the calls after it
        assert _same(out, ref)
    assert _replayed_kernels(fn, _host_frames(6, batch)) == REPLAYED


@pytest.mark.cuda
def test_a_weight_write_recaptures_on_the_card(card):
    hp, model = _served_model(card)
    fn = make_predict_fn(model, hp, fast=True, from_uint8=True, device=card)
    frames = _host_frames(0, 8)
    for _ in range(3):
        old = fn(frames)
    with torch.no_grad():
        model.rpn_cls.bias.add_(torch.linspace(-2.0, 2.0, model.rpn_cls.bias.numel(),
                                               device=card))
        model.backbone.get_submodule("block_8.block_8_project").weight.mul_(0.5)
    for n in ((2, 1, 1), (2, 2, 1), (2, 2, 2)):
        out = fn(frames)
        assert (fn.eager_calls, fn.captures, fn.replays) == n
        assert _same(out, _eager(model, hp, frames, card))
    assert not _same(out, old)


@pytest.mark.cuda
def test_a_new_batch_shape_runs_eager_then_recaptures_on_the_card(card):
    hp, model = _served_model(card)
    fn = make_predict_fn(model, hp, fast=True, from_uint8=True, device=card)
    calls = [(8, (1, 0, 0)), (8, (1, 1, 0)), (4, (2, 1, 0)), (4, (2, 2, 0)), (4, (2, 2, 1)),
             (8, (3, 2, 1))]
    for i, (batch, n) in enumerate(calls):
        frames = _host_frames(10 + i, batch)
        out = fn(frames)
        assert (fn.eager_calls, fn.captures, fn.replays) == n
        assert _same(out, _eager(model, hp, frames, card))


@pytest.mark.cuda
def test_frames_on_the_card_and_inference_mode_on_the_card(card):
    hp, model = _served_model(card)
    fn = make_predict_fn(model, hp, fast=True, from_uint8=True, device=card)
    frames = [_host_frames(20 + i, 8).to(card) for i in range(4)]
    with torch.inference_mode():
        fn(frames[0])
        fn(frames[1])  # captured inside inference mode
    out = fn(frames[2])
    with torch.inference_mode():
        out_im = fn(frames[3])
    assert (fn.eager_calls, fn.captures, fn.replays) == (1, 1, 2)
    assert _same(out, _eager(model, hp, frames[2], card))
    assert _same(out_im, _eager(model, hp, frames[3], card))
