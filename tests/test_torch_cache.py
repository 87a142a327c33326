"""The port's one rule for tensors derived from parameters
(``tpurpn_torch.cache``): a parameter's compute copy and the derived
tensors are made once per parameter version outside autograd, fresh after
every kind of update, freed with their parameter, and the same bits as the
per-use cast that autograd's path keeps.

Every model kind (VGG16, MobileNetV2 unfolded and folded, the s2d uint8
serving forward, a tiny ViTDet ``PyramidRPN``) serves bit for bit what its
grad-enabled forward computes, before and after an in-place optimizer step,
and a second serving call casts no parameter.

This file imports no JAX, so that its ``cuda`` case runs on the card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cache.py``.
"""

import gc
import weakref

import pytest
import torch
from torch.autograd.graph import increment_version
from torch.overrides import TorchFunctionMode

import tpurpn_torch as T
from tpurpn_torch import cache, inference
from tpurpn_torch.data import SyntheticVOC

BF16 = torch.bfloat16
VIT = dict(embed_dim=32, depth=4, num_heads=2, window_size=3, global_blocks=(1, 3),
           pyramid_channels=16)
KINDS = ("vgg16", "mobilenet_v2", "mobilenet_v2_folded", "fast_uint8", "pyramid")


def _conv():
    conv = torch.nn.Conv2d(8, 16, 3)
    return conv.to(memory_format=torch.channels_last)


def test_compute_copy_is_one_copy_per_version():
    p = _conv().weight
    with torch.no_grad():
        c = cache.compute_copy(p, BF16)
        assert cache.compute_copy(p, BF16) is c
        ref = p.to(BF16)
    assert torch.equal(c, ref) and c.dtype == BF16
    assert c.stride() == ref.stride() and c.is_contiguous(memory_format=torch.channels_last)
    assert not c.requires_grad
    assert cache.compute_copy(p, torch.float32) is p  # its own dtype: the parameter


@pytest.mark.parametrize("change", ["in_place", "replaced", "data_swap"])
def test_compute_copy_is_fresh_after_an_update(change):
    conv = _conv()
    with torch.no_grad():
        old = cache.compute_copy(conv.weight, BF16)
        if change == "in_place":
            conv.weight.mul_(2.0)
        elif change == "replaced":
            conv.weight = torch.nn.Parameter(conv.weight.detach() * 2.0)
        else:
            conv.weight.data = conv.weight.data * 2.0
        new = cache.compute_copy(conv.weight, BF16)
        assert new is not old
        assert torch.equal(new, conv.weight.to(BF16))
        assert cache.compute_copy(conv.weight, BF16) is new


def test_a_writer_behind_autograd_must_bump_the_version():
    p = _conv().weight
    with torch.no_grad():
        old = cache.compute_copy(p, BF16)
        p.data.copy_(p.data * 2.0)  # as a graph replay or a broadcast writes
        assert cache.compute_copy(p, BF16) is old  # not seen: the writer's duty
        increment_version(p)
        assert torch.equal(cache.compute_copy(p, BF16), p.to(BF16))


def test_compute_copy_made_under_inference_mode_is_a_normal_tensor():
    p = _conv().weight
    with torch.inference_mode():
        c = cache.compute_copy(p, BF16)
        assert not c.is_inference()
        assert cache.compute_copy(p, BF16) is c
        t = torch.ones(3)  # an inference tensor keeps no version: cast afresh
        assert cache.compute_copy(t, BF16) is not cache.compute_copy(t, BF16)


def test_entries_are_freed_with_their_parameter():
    conv = _conv()
    with torch.no_grad():
        copy = weakref.ref(cache.compute_copy(conv.weight, BF16))
        # a view of its own first source, which the entry must not keep alive
        view = weakref.ref(cache.cached((conv.weight, conv.bias), "first filter",
                                        lambda: conv.weight[0]))
    param = weakref.ref(conv.weight)
    assert copy() is not None and view() is not None
    del conv
    gc.collect()
    assert param() is None and copy() is None and view() is None


def test_under_grad_the_gradient_reaches_the_f32_parameter():
    p = _conv().weight
    with torch.no_grad():
        served = cache.compute_copy(p, BF16)
    c = cache.compute_copy(p, BF16)
    assert c is not served and c.requires_grad
    (c.float() * 3.0).sum().backward()
    assert p.grad.dtype == torch.float32 and torch.equal(p.grad, torch.full_like(p, 3.0))


def _model(kind):
    if kind == "pyramid":
        hp = T.get_hyper_params("vitdet_b", img_size=128, vit=VIT, pre_nms_topn=200,
                                test_nms_topn=100)
    else:
        hp = T.get_hyper_params("vgg16" if kind == "vgg16" else "mobilenet_v2", img_size=64)
    model = T.init_model(T.get_model(hp), torch.Generator().manual_seed(0), device="cpu")
    if kind in ("mobilenet_v2_folded", "fast_uint8"):
        model = T.fold_batch_norm(model)
    return model


def _inputs(kind):
    g = torch.Generator().manual_seed(1)
    if kind == "fast_uint8":
        return torch.randint(0, 256, (2, 48, 64, 3), dtype=torch.uint8, generator=g)
    side = 128 if kind == "pyramid" else 64
    return torch.rand((2, side, side, 3), generator=g)


def _serve(kind, model, x):
    """The forward as serving runs it: without autograd."""
    with torch.no_grad():
        if kind == "fast_uint8":
            return inference.fast_uint8_forward(model, x)
        return model(x)


def _grad_forward(kind, model, x):
    """The same forward with autograd recording: every parameter cast at its use."""
    with torch.enable_grad():
        if kind == "fast_uint8":
            feat = inference.s2d_uint8_stem(model, x)
            return inference._fused_stage_from(model, feat, skip_stem=True)
        return model(x)


@pytest.mark.parametrize("kind", KINDS)
def test_serving_forward_equals_the_grad_forward_before_and_after_a_step(kind):
    model, x = _model(kind), _inputs(kind)
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    for _ in range(2):
        ref = _grad_forward(kind, model, x)
        for _ in range(2):
            got = _serve(kind, model, x)
            assert all(torch.equal(a, b.detach()) for a, b in zip(got, ref))
        opt.zero_grad()
        sum(o.float().square().mean() for o in ref).backward()
        opt.step()  # in place: every compute copy is made again
        assert not all(torch.equal(a, b) for a, b in zip(_serve(kind, model, x), got))


class _ParameterCasts(TorchFunctionMode):
    """Counts ``Tensor.to`` calls on an ``nn.Parameter``."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.to and args and isinstance(args[0], torch.nn.Parameter):
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["pyramid", "fast_uint8"])
def test_a_second_serving_call_casts_no_parameter(kind):
    model, x = _model(kind), _inputs(kind)
    counts = []
    for _ in range(2):
        with _ParameterCasts() as casts:
            _serve(kind, model, x)
        counts.append(casts.count)
    assert counts[0] > 0 and counts[1] == 0, counts


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_serving_reads_the_weights_of_graph_replayed_steps(cuda, monkeypatch):
    """A second chunk of ``make_scan_train_steps`` only replays its CUDA graph;
    the serving forward after it reads the replayed updates."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    hp = T.get_hyper_params("vgg16", img_size=64, max_gt_boxes=8, total_pos_bboxes=16,
                            total_neg_bboxes=16)
    state = T.create_train_state(hp, torch.Generator().manual_seed(0), device=cuda)
    data = [torch.from_numpy(a).to(cuda) for a in next(
        SyntheticVOC(num_samples=8, raw_h=72, raw_w=96, seed=3).batches(8))]
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2)).to(cuda)
    run = T.make_scan_train_steps(hp, batch_size=4, num_steps=3)
    gen = torch.Generator(device=cuda).manual_seed(1)
    state, _ = run(state, gen, *data)  # an eager step, the capture, two replays
    before = _serve("vgg16", state.model, images)
    state, _ = run(state, gen, *data)  # three replays
    assert (run.graph.captures, run.graph.replays) == (1, 5)
    fresh = T.get_model(hp)
    fresh.load_state_dict(state.model.state_dict())
    fresh = T.model.to_device(fresh, cuda)
    got, ref = _serve("vgg16", state.model, images), _serve("vgg16", fresh, images)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, before):
        assert torch.equal(a, b)
        assert not torch.equal(a, c)
