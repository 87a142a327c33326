"""The serving prefix's kernels (``tpurpn_torch/kernels/prefix.py``): their
plain versions against ``F.conv2d`` + bias + ReLU6 (+ residual), the plain
prefix walk against the folded module's forward, the wrappers' refusals,
the fast serving path's route through them, and (marked ``cuda``, skipped
without a card) each kernel against its plain version on the card. (A
tensor off the CPU going to the kernels' build is one case of
tests/test_torch_kernels.py's dispatch test.)

Tolerances: a plain 1x1 conv sums its f32 products in another order than
``F.conv2d``, so after the one bf16 rounding they differ by at most one bf16
ulp (rtol 2^-7 of max(1, |ref|max)); the depthwise likewise. The prefix
walk rounds once a conv where the module's forward rounds the cuDNN
output, the bias add and the clamp each to bf16: the repository's bf16
tolerance (rel 0.02 of max(1, |ref|max)), as for the IR stage.

This file imports no JAX, so that its ``cuda`` cases run on the card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_prefix.py``.
"""

import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import tpurpn_torch
from tpurpn_torch import inference, profiling
from tpurpn_torch.kernels import prefix
from tpurpn_torch.kernels.prefix import (DEPTHWISE_SPECS, POINTWISE_SPECS, Depthwise,
                                         Pointwise, pack_prefix, pointwise_pack,
                                         prefix_blocks, prefix_depthwise,
                                         prefix_depthwise_plain, prefix_pointwise,
                                         prefix_pointwise_plain)

REPO = Path(__file__).resolve().parents[1]
TRAINED = REPO / "trained" / "rpn_mobilenet_v2_trained.npz"
ULP = 2.0 ** -7  # one bf16 ulp, relative


def _close(got, ref, rel):
    got, ref = got.float(), ref.float()
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=rel, atol=rel * scale)


def _bf16(shape, gen, lo=-1.0, hi=1.0, device="cpu"):
    x = torch.rand(shape, generator=gen) * (hi - lo) + lo
    return x.to(torch.bfloat16).to(device)


def _pointwise(spec, gen, device="cpu"):
    c_in, c_out, relu6, residual = spec
    w = (torch.randn((c_in, c_out), generator=gen) / c_in ** 0.5).to(torch.bfloat16)
    b = torch.randn((c_out,), generator=gen) * 0.5
    return Pointwise(w.to(device), b.to(device), pointwise_pack(w).to(device), relu6, residual)


def _depthwise(spec, gen, device="cpu"):
    c, stride = spec
    taps = (torch.randn((9, c), generator=gen) * 0.4).to(torch.bfloat16).float()
    return Depthwise(taps.to(device), (torch.randn((c,), generator=gen) * 0.5).to(device), stride)


def _tf_same(size, stride):
    """TF SAME: ceil(size / stride) outputs, the odd pixel of padding after."""
    total = max((-(-size // stride) - 1) * stride + 3 - size, 0)
    return total // 2, total - total // 2


def _conv_ref_pointwise(x, pw, residual):
    y = F.conv2d(x.float().permute(0, 3, 1, 2), pw.w.float().t()[:, :, None, None], pw.b)
    y = y.permute(0, 2, 3, 1)
    if pw.relu6:
        y = F.relu6(y)
    if residual is not None:
        return (y.to(torch.bfloat16).float() + residual.float()).to(torch.bfloat16)
    return y.to(torch.bfloat16)


def _conv_ref_depthwise(x, dw):
    c, s = dw.taps.shape[1], dw.stride
    (t, b), (l, r) = _tf_same(x.shape[1], s), _tf_same(x.shape[2], s)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (l, r, t, b))
    w = dw.taps.t().reshape(c, 1, 3, 3)
    y = F.conv2d(xp, w, dw.b, stride=s, groups=c)
    return F.relu6(y).permute(0, 2, 3, 1).to(torch.bfloat16)


# the prefix's 1x1 convs at their 500 px serving sizes (one image; the
# 250^2 maps at 64^2 rows, whose tiling does not depend on the image)
POINTWISE_SIZES = {(32, 16): 64, (16, 96): 64, (96, 24): 125, (24, 144): 125,
                   (144, 24): 125, (144, 32): 63, (32, 192): 63, (192, 32): 63, (192, 64): 32}


@pytest.mark.parametrize("spec", POINTWISE_SPECS, ids=lambda s: f"{s[0]}to{s[1]}")
def test_pointwise_plain_matches_conv2d(spec):
    gen = torch.Generator().manual_seed(spec[0] * 1000 + spec[1])
    pw = _pointwise(spec, gen)
    S = POINTWISE_SIZES[spec[:2]]
    x = _bf16((1, S, S + 1, spec[0]), gen, 0.0, 3.0)
    res = _bf16((1, S, S + 1, spec[1]), gen) if spec[3] else None
    launches = prefix_pointwise.launches
    got = prefix_pointwise(x, pw, res)  # the CPU runs the plain version
    assert prefix_pointwise.launches == launches
    assert got.shape == (1, S, S + 1, spec[1]) and got.dtype == torch.bfloat16
    _close(got, _conv_ref_pointwise(x, pw, res), ULP)
    if spec[2]:
        assert float(got.float().min()) >= 0.0 and float(got.float().max()) <= 6.0


# (channels, stride, H, W): every spec at its 500 px serving size, and the
# stride-2 sizes odd and even: 250 -> 125, 125 -> 63, 63 -> 32, 320 -> 160
# (640 px), and a small map odd one way and even the other
DEPTHWISE_CASES = [(32, 1, 250, 250), (96, 2, 250, 250), (144, 1, 125, 125),
                   (144, 2, 125, 125), (192, 1, 63, 63), (192, 2, 63, 63),
                   (96, 2, 320, 320), (192, 2, 7, 8), (144, 2, 10, 9)]


@pytest.mark.parametrize("case", DEPTHWISE_CASES, ids=lambda c: "c{}_s{}_{}x{}".format(*c))
def test_depthwise_plain_matches_conv2d(case):
    c, s, H, W = case
    gen = torch.Generator().manual_seed(c * 100 + H)
    dw = _depthwise((c, s), gen)
    x = _bf16((1, H, W, c), gen, 0.0, 6.0)
    launches = prefix_depthwise.launches
    got = prefix_depthwise(x, dw)
    assert prefix_depthwise.launches == launches
    assert got.shape == (1, -(-H // s), -(-W // s), c) and got.dtype == torch.bfloat16
    _close(got, _conv_ref_depthwise(x, dw), ULP)


@pytest.mark.parametrize("c", [144, 192])
def test_depthwise_padding_is_tf_same_at_stride_2(c):
    """At stride 2 an even map is padded (0, 1) and an odd one (1, 1): on
    an even map the symmetric (1, 1) padding of ``nn.Conv2d(padding=1)``
    gives another result."""
    gen = torch.Generator().manual_seed(7)
    dw = _depthwise((c, 2), gen)
    w = dw.taps.t().reshape(c, 1, 3, 3)
    for H, pad in ((10, (0, 1)), (9, (1, 1))):
        assert _tf_same(H, 2) == pad
        x = _bf16((1, H, H, c), gen, 0.0, 6.0)
        got = prefix_depthwise_plain(x, dw)
        sym = F.conv2d(x.float().permute(0, 3, 1, 2), w, dw.b, stride=2, padding=1, groups=c)
        sym = F.relu6(sym).permute(0, 2, 3, 1).to(torch.bfloat16)
        assert got.shape == sym.shape
        if pad == (1, 1):
            _close(got, sym, ULP)
        else:
            assert (got.float() - sym.float()).abs().max() > 0.1


def _model(img, trained, seed=0):
    hp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=img)
    model = tpurpn_torch.get_model(hp)
    if trained:
        from tpurpn_torch.io_utils import load_keras_h5_weights

        model, missing = load_keras_h5_weights(str(TRAINED), model)
        assert not missing
    else:
        tpurpn_torch.init_model(model, torch.Generator().manual_seed(seed), device="cpu")
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():  # BatchNorm statistics away from the identity
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                    m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return hp, tpurpn_torch.fold_batch_norm(model)


def _conv1(bb, images):
    with torch.no_grad():
        x = images.to(bb.dtype).permute(0, 3, 1, 2)
        return inference.relu6(bb.Conv1(x)).permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("trained,img", [(True, 128), (False, 128), (False, 200)],
                         ids=["trained_128", "random_128", "random_200"])
def test_plain_prefix_matches_the_module(trained, img):
    """The plain walk of expanded_conv .. block_6 against the folded
    module's ``bb(x, stop_after_block=6, skip_stem=True)``: 200 px takes the
    stride-2 maps 100 -> 50 -> 25 -> 13 (odd at the last)."""
    _, model = _model(img, trained)
    bb = model.backbone
    images = torch.rand((2, img, img, 3), generator=torch.Generator().manual_seed(3))
    feat1 = _conv1(bb, images)
    with torch.no_grad():
        ref = bb(feat1, stop_after_block=6, skip_stem=True)
        got = prefix_blocks(feat1, pack_prefix(bb, inference._PREFIX_BLOCKS))
    S = -(-img // 16)
    assert got.shape == ref.shape == (2, S, S, 64) and got.dtype == torch.bfloat16
    _close(got, ref, 0.02)


def test_prefix_pack_covers_every_spec_once():
    _, model = _model(128, False)
    blocks = pack_prefix(model.backbone, inference._PREFIX_BLOCKS)
    pws = [pw for ex, _, pj in blocks for pw in (ex, pj) if pw is not None]
    assert len(pws) == 13 and len(blocks) == 7
    assert set(pw.spec for pw in pws) == set(POINTWISE_SPECS)
    assert set(dw.spec for _, dw, _ in blocks) == set(DEPTHWISE_SPECS)
    for pw in pws:  # the pack is the swizzled image of w, pad channels zero
        k_in = -(-pw.w.shape[0] // 32) * 32
        assert pw.pack.shape == (k_in * pw.w.shape[1],) and pw.pack.dtype == torch.bfloat16
        assert torch.equal(pw.pack.sort().values,
                           F.pad(pw.w.t(), (0, k_in - pw.w.shape[0])).reshape(-1).sort().values)


def test_prefix_weights_are_cached_until_a_parameter_changes():
    _, model = _model(128, False)
    bb = model.backbone
    a = prefix.prefix_weights_cached(bb, inference._PREFIX_BLOCKS)
    assert prefix.prefix_weights_cached(bb, inference._PREFIX_BLOCKS) is a
    with torch.no_grad():
        bb.block_3.block_3_project.bias.add_(1.0)
    b = prefix.prefix_weights_cached(bb, inference._PREFIX_BLOCKS)
    assert b is not a
    assert torch.equal(b[3][2].b, bb.block_3.block_3_project.bias.float())


def test_fast_serving_runs_the_prefix_on_the_kernels(monkeypatch):
    """A fast serving call (uint8 frames through the s2d stem, and float
    images through Conv1) runs 13 prefix_pointwise and 7 prefix_depthwise
    calls, one launch each on the card, all inside ``rpn.prefix``, and no
    forward of a prefix block's module."""
    hp, model = _model(128, False)
    bb = model.backbone
    calls = []

    def spy(fn, name):
        def counted(*a, **k):
            calls.append((name, time.time_ns()))
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(prefix, "prefix_pointwise", spy(prefix.prefix_pointwise, "pw"))
    monkeypatch.setattr(prefix, "prefix_depthwise", spy(prefix.prefix_depthwise, "dw"))

    def refuse(*a, **k):
        raise AssertionError("the fast path ran a prefix block's module forward")

    for name in inference._PREFIX_BLOCKS:
        monkeypatch.setattr(bb.get_submodule(name), "forward", refuse)
    predict = tpurpn_torch.make_predict_fn(model, hp, fast=True, from_uint8=True, device="cpu")
    frames = torch.randint(0, 256, (2, 96, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5))
    images = torch.rand((2, 128, 128, 3), generator=torch.Generator().manual_seed(6))
    for run in (lambda: predict(frames),
                lambda: inference.fast_mobilenet_forward(model, images.to(torch.bfloat16))):
        calls.clear()
        with profiling.recording() as spans:
            run()
        (p0, p1), = [(s[2], s[3]) for s in spans if s[0] == "rpn.prefix"]
        assert [n for n, _ in calls].count("pw") == 13
        assert [n for n, _ in calls].count("dw") == 7
        assert all(p0 <= t <= p1 for _, t in calls)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    gen = torch.Generator().manual_seed(0)
    pw = _pointwise((96, 24, False, False), gen)
    dw = _depthwise((96, 2), gen)
    x = _bf16((1, 8, 8, 96), gen)
    bad = [
        lambda: prefix_pointwise(x.float(), pw),  # dtype
        lambda: prefix_pointwise(x.permute(0, 2, 1, 3), pw),  # layout
        lambda: prefix_pointwise(x[..., :64], pw),  # channels
        lambda: prefix_pointwise(x, pw, _bf16((1, 8, 8, 24), gen)),  # a residual it takes not
        lambda: prefix_pointwise(x, pw._replace(relu6=True)),  # a spec outside the table
        lambda: prefix_pointwise(_bf16((1, 8, 8, 48), gen), _pointwise((48, 24, False, False),
                                                                        gen)),
        lambda: prefix_pointwise(_bf16((1, 8, 8, 144), gen),
                                 _pointwise((144, 24, False, True), gen)),  # residual missing
        lambda: prefix_pointwise(_bf16((1, 8, 8, 144), gen),
                                 _pointwise((144, 24, False, True), gen),
                                 _bf16((1, 8, 9, 24), gen)),  # residual of other pixels
        lambda: prefix_depthwise(x.float(), dw),
        lambda: prefix_depthwise(x.permute(0, 2, 1, 3), dw),
        lambda: prefix_depthwise(x, dw._replace(stride=1)),  # (96, 1) is not a spec
        lambda: prefix_depthwise(_bf16((1, 8, 8, 64), gen), _depthwise((64, 1), gen)),
        lambda: prefix_depthwise(x[:0], dw),  # no pixels
        lambda: prefix_depthwise(x, dw._replace(taps=dw.taps.to(torch.bfloat16))),
        # operands on another device than x's (x off the CPU: the kernel's route)
        lambda: prefix_pointwise(x.to("meta"), pw._replace(pack=pw.pack.to("meta"))),
        lambda: prefix_depthwise(x.to("meta"), dw._replace(taps=dw.taps.to("meta"))),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"case {i} was taken")


# --- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the prefix kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", POINTWISE_SPECS, ids=lambda s: f"{s[0]}to{s[1]}")
def test_pointwise_kernel_matches_plain_on_the_card(card, spec):
    """Within one bf16 ulp: the tensor cores sum the K products in another
    f32 order than the plain version's matmul; the rounding is the same.
    Rows: a ragged last tile (B * H * W not a multiple of 128)."""
    gen = torch.Generator().manual_seed(spec[1])
    pw = _pointwise(spec, gen, card)
    S = POINTWISE_SIZES[spec[:2]]
    for B in (3, 1):
        x = _bf16((B, S, S, spec[0]), gen, 0.0, 3.0, card)
        res = _bf16((B, S, S, spec[1]), gen, -1.0, 1.0, card) if spec[3] else None
        launches = prefix_pointwise.launches
        got = prefix_pointwise(x, pw, res)
        torch.cuda.synchronize()
        assert prefix_pointwise.launches == launches + 1
        _close(got, prefix_pointwise_plain(x, pw, res), ULP)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEPTHWISE_CASES, ids=lambda c: "c{}_s{}_{}x{}".format(*c))
def test_depthwise_kernel_matches_plain_on_the_card(card, case):
    """Bit for bit: the products of bf16 values are exact in f32 and both
    sum the taps in the same order."""
    c, s, H, W = case
    gen = torch.Generator().manual_seed(c + H)
    dw = _depthwise((c, s), gen, card)
    x = _bf16((3, H, W, c), gen, 0.0, 6.0, card)
    launches = prefix_depthwise.launches
    got = prefix_depthwise(x, dw)
    torch.cuda.synchronize()
    assert prefix_depthwise.launches == launches + 1
    assert torch.equal(got, prefix_depthwise_plain(x, dw))


@pytest.mark.cuda
def test_prefix_kernels_match_an_f32_forward_on_the_card(card):
    """The 20 launches over 4 images of 500 px, trained weights, against
    the folded module run in f32 (cuDNN without TF32) on the same bf16
    Conv1 activations: the bf16 tolerance. (The module's own bf16 forward
    rounds the cuDNN output, the bias add and the clamp each to bf16; after
    20 convs it and the kernels drifted apart by 2.08 % of the largest
    output at one element in 262,144 on the card, so both are held to the
    f32 forward, not to each other.)"""
    import copy

    torch.backends.cudnn.allow_tf32 = False
    _, model = _model(500, True)
    bb = model.to(card).backbone
    bb32 = copy.deepcopy(bb)
    bb32.dtype = torch.float32
    feat1 = _conv1(bb, torch.rand((4, 500, 500, 3), device=card,
                                  generator=torch.Generator(card).manual_seed(0)))
    with torch.no_grad():
        ref = bb32(feat1.float(), stop_after_block=6, skip_stem=True)
        got = prefix_blocks(feat1, pack_prefix(bb, inference._PREFIX_BLOCKS))
    assert got.shape == (4, 32, 32, 64) and got.dtype == torch.bfloat16
    _close(got, ref, 0.02)
