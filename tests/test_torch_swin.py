"""Swin-B's RPN in the port (``backbones/swin.py``, ``model.PyramidRPN`` with
``mvit.FPN``, the level path) against the plain reference
``portbench/reference/swin.py``, at a small size on the CPU: widths 32-256
(heads 1, 2, 4, 8 of 32), two blocks a stage (one unshifted, one shifted),
window 7, on a 256 x 320 canvas, whose stage grids 64 x 80, 32 x 40, 16 x 20
and 8 x 10 all pad to whole windows (70 x 84 ... 14 x 14). Weights are the
reference's draw (every tensor non-zero, the bias tables at std 1).

Tolerances: in f32 the port computes the reference's equations with other
kernels (one gather for pad, roll and window cut, a chunked core, einsum
and matmul orders), so f32 rounding apart: 1e-5 of the values' scale. In
bf16 the forward's outputs are held at 0.05 of the largest magnitude, as
ViTDet's and MViTv2's (some eight bf16 roundings a block over eight blocks
of residual sums), and nine in ten proposals within 0.02 of one the f32
path serves. Index maps, bias gathers, masks, anchors and the selection on
one candidate array are exact. A port without the shift mask differs from
the reference by more than 0.05 of the largest output: the comparison
sees it.

Marked ``cuda`` (the card only; this file imports no JAX):
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_swin.py``.
"""

import json
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import tpurpn_torch as T
from tpurpn_torch import predict as P
from tpurpn_torch import profiling
from tpurpn_torch.anchors import generate_level_anchors, level_sizes
from tpurpn_torch.backbones import swin
from tpurpn_torch.kernels import proposal

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import swin as R  # noqa: E402

CFG = dict(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8], window_size=7,
           mlp_ratio=4.0, patch_size=4, ln_eps=1e-5, fpn_channels=16, head_convs=1,
           min_size_test=256, max_size_test=320, size_divisibility=32,
           anchor_sizes=[32, 64, 128, 256, 512], anchor_ratios=[0.5, 1.0, 2.0],
           strides=[4, 8, 16, 32, 64], pre_nms_topk=200, post_nms_topk=100, nms_thresh=0.7,
           box_weights=[1.0, 1.0, 1.0, 1.0], scale_clamp=math.log(1000.0 / 16),
           pixel_mean=[123.675, 116.28, 103.53], pixel_std=[58.395, 57.12, 57.375],
           init=dict(patch_weight="fan_in", patch_bias=0.02, linear_weight=0.05,
                     linear_bias=0.02, norm_weight=0.1, norm_bias=0.05, rel_pos_bias=1.0,
                     fpn_weight="fan_in", fpn_bias=0.02, head_conv_weight="fan_in",
                     head_conv_bias=0.02, objectness_weight=0.3, objectness_bias=0.1,
                     deltas_weight=0.1, deltas_bias=0.02))
CANVAS = (256, 320)
GRIDS = [(64, 80), (32, 40), (16, 20), (8, 10)]
PUBLISHED_GRIDS = [(200, 272), (100, 136), (50, 68), (25, 34)]


def hyper_params(dtype="float32", **kw):
    net = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), fpn_channels=16)
    return T.get_hyper_params("swin_b", swin=net, canvas_rule=(256, 320, 32), pre_nms_topn=200,
                              test_nms_topn=100, compute_dtype=dtype, **kw)


@pytest.fixture(scope="module")
def params():
    return R.draw_params(CFG, 11)


def model(params, dtype="float32"):
    m = T.get_model(hyper_params(dtype))
    m.load_state_dict(params)
    return m.eval()


def frames(n=2, h=200, w=240, seed=1):
    """RGB frames that resize to 256 x 307 on the 256 x 320 canvas."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, generator=g)


def close(got, ref, rel):
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=rel * scale)


def padded(hw, m=7):
    return tuple(-(-x // m) * m for x in hw)


# --- the bias, the mask and the window order ------------------------------------


def test_relative_bias_is_swins_gather():
    """The port's (h, 49, 49) bias is the table gathered by Swin's
    ``relative_position_index``, bit for bit, in f32 and bf16."""
    g = torch.Generator().manual_seed(3)
    table = torch.randn((169, 16), generator=g)
    want = R.relative_position_bias(table, 7)
    assert want.shape == (16, 49, 49)
    assert torch.equal(swin.relative_bias(table, 7, torch.float32), want)
    assert torch.equal(swin.relative_bias(table, 7, torch.bfloat16), want.to(torch.bfloat16))
    assert int(swin.relative_index(7).max()) == 168 and int(swin.relative_index(7)[0, 0]) == 84


@pytest.mark.parametrize("hw", GRIDS + PUBLISHED_GRIDS, ids=str)
def test_shift_mask_regions(hw):
    """The port's mask is Swin's ``attn_mask``, bit for bit; and its meaning:
    two tokens of a window attend to each other exactly where (y - 3) // 7
    and (x - 3) // 7 of their unrolled coordinates agree. On the published
    grids only the last row and column of windows are masked (67 of
    Swin-B's 1,131 windows at stride 4, 8 of 20 at stride 32)."""
    hp, wp = padded(hw)
    got = swin.shift_mask(hp, wp, 7, 3, torch.device("cpu"))
    assert torch.equal(got, R.shift_mask(hp, wp, 7, 3))
    src = swin.window_order(*hw, 7, 3, torch.device("cpu")).reshape(-1, 49)
    y, x = src // wp, src % wp
    group = ((y - 3) // 7) * 1000 + (x - 3) // 7
    same = group[:, :, None] == group[:, None, :]
    assert torch.equal(got == 0, same)
    assert set(got.unique().tolist()) <= {0.0, -100.0}
    masked = (got != 0).flatten(1).any(1)
    nh, nw = hp // 7, wp // 7
    assert int(masked.sum()) == nh + nw - 1
    assert masked.reshape(nh, nw)[:-1, :-1].sum() == 0


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("hw", GRIDS + [(5, 9), (203, 273)], ids=str)
def test_window_order_is_pad_roll_partition(hw, shift):
    """One gather in ``window_order`` is the reference's zero pad, roll and
    window partition; ``grid_order`` gathers the merged, rolled back and
    cropped grid back from it."""
    g = torch.Generator().manual_seed(hw[0])
    x = torch.randn((2, *hw, 3), generator=g)
    hp, wp = padded(hw)
    xp = torch.nn.functional.pad(x, (0, 0, 0, wp - hw[1], 0, hp - hw[0]))
    if shift:
        xp = torch.roll(xp, (-shift, -shift), (1, 2))
    want, _ = R.window_partition(xp, 7)
    cpu = torch.device("cpu")
    flat = torch.nn.functional.pad(x, (0, 0, 0, wp - hw[1], 0, hp - hw[0])).reshape(2, -1, 3)
    got = flat.index_select(1, swin.window_order(*hw, 7, shift, cpu))
    assert torch.equal(got.reshape(want.shape), want)
    back = got.index_select(1, swin.grid_order(*hw, 7, shift, cpu)).reshape(x.shape)
    assert torch.equal(back, x)


# --- the core and the blocks ------------------------------------------------------


def reference_core(x, w, b, table, heads, shift, masked, pad="bias"):
    """The reference's way on (B, H, W, C) tokens: zero pad, roll, window
    cut, the qkv Linear (w, b) on the windows (a pad token's q, k and v are
    b), the core with the table's bias and, where ``masked``, the shift
    mask, then merge, roll back and crop. The faults: ``pad="zeros"`` zero-
    fills the pad tokens' q, k and v; ``pad="masked"`` masks the pad keys."""
    n_img, hh, ww, c = x.shape
    hp, wp = padded((hh, ww))
    xp = torch.nn.functional.pad(x, (0, 0, 0, wp - ww, 0, hp - hh))
    real = torch.nn.functional.pad(torch.ones((n_img, hh, ww, 1)), (0, 0, 0, wp - ww, 0, hp - hh))
    if shift:
        xp, real = (torch.roll(t, (-shift, -shift), (1, 2)) for t in (xp, real))
    win, _ = R.window_partition(xp, 7)
    n, d = win.shape[0], c // heads
    real = R.window_partition(real, 7)[0].reshape(n, 49)
    qkv = torch.nn.functional.linear(win.reshape(n, 49, c), w, b)
    if pad == "zeros":
        qkv = qkv * real[:, :, None]
    q, k, v = qkv.reshape(n, 49, 3, heads, d).permute(2, 0, 3, 1, 4)
    scores = (q * d ** -0.5) @ k.transpose(-2, -1) + R.relative_position_bias(table, 7)
    if masked:
        scores = scores + R.shift_mask(hp, wp, 7, shift).repeat(n_img, 1, 1)[:, None]
    if pad == "masked":
        scores = scores.masked_fill(real[:, None, None, :] == 0, float("-inf"))
    out = (scores.softmax(-1) @ v).transpose(1, 2).reshape(n, 7, 7, c)
    y = R.window_unpartition(out, 7, (hp, wp), (hp, wp))
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y[:, :hh, :ww]


def window_order_path(x, w, b, table, heads, shift, masked):
    """The port's layout before the core addressed the grid itself: the
    tokens zero-padded and gathered into window order (``window_order``),
    the qkv Linear on the windows, the f32 core, one gather back
    (``grid_order``)."""
    n_img, hh, ww, c = x.shape
    hp, wp = padded((hh, ww))
    cpu = torch.device("cpu")
    xp = torch.nn.functional.pad(x, (0, 0, 0, wp - ww, 0, hp - hh)).reshape(n_img, -1, c)
    win = xp.index_select(1, swin.window_order(hh, ww, 7, shift, cpu))
    qkv = torch.nn.functional.linear(win, w, b).reshape(-1, 49, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    mask = swin.shift_mask(hp, wp, 7, shift, cpu) if masked else None
    out = swin._plain_core(q, k, v, swin.relative_bias(table, 7, torch.float32), mask)
    out = out.transpose(1, 2).reshape(n_img, -1, c)
    return out.index_select(1, swin.grid_order(hh, ww, 7, shift, cpu)).reshape(x.shape)


def core_problem(hw, heads, seed, n_img=2):
    """Tokens, a qkv Linear with a non-zero bias (std 1) and a table at std
    1 for a core of ``heads`` heads of 32 on an ``hw`` grid."""
    g = torch.Generator().manual_seed(seed)
    c = 32 * heads
    x = torch.randn((n_img, *hw, c), generator=g)
    w = torch.randn((3 * c, c), generator=g) * c ** -0.5
    b = torch.randn((3 * c,), generator=g)
    table = torch.randn((169, heads), generator=g)
    return x, w, b, table


@pytest.mark.parametrize("shifted", [False, True])
def test_core_against_the_reference(shifted):
    """The port's core (its CPU path) on the qkv product of a 14 x 21 grid
    (6 windows, no pad) of four images, 4 heads, against the reference's
    roll, window cut, Linear and core; f32 rounding apart. The bias, the
    roll and the mask are live terms."""
    x, w, b, table = core_problem((14, 21), 4, 5, n_img=4)
    qkv = torch.nn.functional.linear(x, w, b)
    shift = 3 if shifted else 0
    got = swin.window_attention_core(qkv, b, table, 4, 7, shift, shifted)
    assert got.shape == x.shape
    close(got, reference_core(x, w, b, table, 4, shift, shifted), 1e-5)
    other = swin.window_attention_core(qkv, b, torch.zeros_like(table), 4, 7, shift, shifted)
    assert (other - got).abs().max() > 1e-2
    if shifted:
        bare = swin.window_attention_core(qkv, b, table, 4, 7, shift, False)
        assert (bare - got).abs().max() > 1e-2
        still = swin.window_attention_core(qkv, b, table, 4, 7, 0, False)
        assert (still - bare).abs().max() > 1e-2


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("hw", [(9, 11), (13, 19)], ids=str)
def test_core_on_ragged_grids(hw, shift):
    """On grids that pad to whole windows (9 x 11 to 14 x 14, 13 x 19 to 14
    x 21), with a non-zero qkv bias, the core on the grid's qkv product is
    the window-order path's and the reference's (pad tokens' k and v the
    bias, keys like any other), f32 rounding apart."""
    x, w, b, table = core_problem(hw, 2, hw[0] + shift)
    qkv = torch.nn.functional.linear(x, w, b)
    masked = shift > 0
    got = swin.window_attention_core(qkv, b, table, 2, 7, shift, masked)
    close(got, window_order_path(x, w, b, table, 2, shift, masked), 1e-5)
    close(got, reference_core(x, w, b, table, 2, shift, masked), 1e-5)


@pytest.mark.parametrize("fault", ["zeros", "masked"])
def test_pad_keys_other_than_the_bias_fail(fault):
    """A core whose pad keys are zero-filled or masked misses the
    reference's output on a ragged grid by far more than f32 rounding: the
    comparisons above see the pad keys."""
    x, w, b, table = core_problem((9, 11), 2, 9)
    want = reference_core(x, w, b, table, 2, 3, True)
    qkv = torch.nn.functional.linear(x, w, b)
    close(swin.window_attention_core(qkv, b, table, 2, 7, 3, True), want, 1e-5)
    bad = reference_core(x, w, b, table, 2, 3, True, pad=fault)
    assert (bad - want).abs().max() > 1e-2
    if fault == "zeros":  # the plain version fed a zero bias zero-fills its pad keys
        zero_filled = swin.window_attention_core(qkv, torch.zeros_like(b), table, 2, 7, 3, True)
        close(zero_filled, bad, 1e-5)


def block_module(params, stage, j):
    m = model(params)
    return m.backbone.layers[stage].blocks[j]


@pytest.mark.parametrize("stage", [0, 3])
@pytest.mark.parametrize("j", [0, 1], ids=["unshifted", "shifted"])
def test_block_against_the_reference(params, stage, j):
    """One block of the port against the reference's ``SwinTransformerBlock``
    on its stage's grid (stage 1: 64 x 80 in 12 x 10 windows; stage 4: 8 x
    10 in 2 x 2), f32."""
    blk = block_module(params, stage, j)
    assert blk.shift == 3 * j
    c = 32 << stage
    g = torch.Generator().manual_seed(stage + j)
    x = torch.randn((2, *GRIDS[stage], c), generator=g)
    with torch.no_grad():
        got = blk(x)
    want = R.block(params, f"backbone.layers.{stage}.blocks.{j}.", x, CFG["num_heads"][stage], 7,
                   3 * j, CFG)
    close(got, want, 1e-5)


@pytest.mark.parametrize("hw", [(8, 10), (7, 9)], ids=str)
def test_patch_merging_against_the_reference(params, hw):
    """Patch merging on an even and an odd grid (padded to even), f32."""
    merge = model(params).backbone.layers[1].downsample
    x = torch.randn((2, *hw, 64), generator=torch.Generator().manual_seed(hw[1]))
    with torch.no_grad():
        got = merge(x)
    assert got.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 128)
    close(got, R.patch_merging(params, "backbone.layers.1.downsample.", x, 1e-5), 1e-5)


# --- the model ---------------------------------------------------------------------


def test_backbone_and_fpn_against_the_reference(params):
    m = model(params)
    x, hw, cv = R.preprocess(frames(), CFG)
    assert (hw, cv) == ((256, 307), CANVAS)
    with torch.no_grad():
        feats = m.backbone(x.permute(0, 2, 3, 1))
        levels = m.pyramid(feats)
    ref = R.swin(params, x, CFG)
    assert [tuple(t.shape[1:]) for t in feats] == [(32 << i, *g) for i, g in enumerate(GRIDS)]
    for got, want in zip(feats, ref):
        close(got, want, 1e-5)
    assert [tuple(t.shape[2:]) for t in levels] == GRIDS + [(4, 5)]
    for got, want in zip(levels, R.fpn(params, ref)):
        close(got, want, 1e-5)


def test_dropping_the_mask_fails_the_comparison(params):
    """The port with its shifted blocks rolled but unmasked (the benchmark's
    fault (b)) misses the reference's outputs by more than the bf16
    tolerance of 0.05 of the largest."""
    m = model(params)
    for attn in m.modules():
        if isinstance(attn, swin.WindowAttention):
            attn.forward = types.MethodType(lambda self, x, grid, f=attn.forward: f(x, None), attn)
    x, _, _ = R.preprocess(frames(), CFG)
    with torch.no_grad():
        feats = m.backbone(x.permute(0, 2, 3, 1))
    with pytest.raises(AssertionError):
        close(feats[-1], R.swin(params, x, CFG)[-1], 0.05)


def test_published_levels_windows_and_anchors():
    """Swin-B's configuration, stage grids, windows and 217,413 anchors on
    COCO's 480 x 640 frame, as arithmetic; the anchors the reference's,
    bit for bit."""
    hp = T.get_hyper_params("swin_b")
    net = hp.swin
    assert (net.embed_dim, net.depths, net.num_heads, net.window_size) == (
        128, (2, 2, 18, 2), (4, 8, 16, 32), 7)
    assert (net.patch_size, net.mlp_ratio, net.ln_eps) == (4, 4.0, 1e-5)
    assert hp.canvas_of(480, 640) == ((800, 1067), (800, 1088)) and hp.canvas is None
    canvas = (800, 1088)
    assert hp.level_shapes(canvas) == tuple(PUBLISHED_GRIDS) + ((13, 17),)
    assert sum(level_sizes(hp, canvas)) == 217413
    assert [padded(g) for g in PUBLISHED_GRIDS] == [(203, 273), (105, 140), (56, 70), (28, 35)]
    assert [math.prod(padded(g)) // 49 for g in PUBLISHED_GRIDS] == [1131, 300, 80, 20]
    ref_cfg = dict(CFG, embed_dim=128, depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32])
    anc, lev = R.anchors(ref_cfg, canvas)
    assert torch.equal(generate_level_anchors(hp, canvas=canvas), anc)
    assert torch.equal(torch.bincount(lev), torch.tensor(level_sizes(hp, canvas)))
    m = T.get_model(hp)
    assert m.backbone.out_channels == [128, 256, 512, 1024]
    assert [32 * h for h in net.num_heads] == m.backbone.out_channels  # d = 32
    n = sum(p.numel() for k, p in m.named_parameters() if k.startswith("backbone."))
    assert 86.7e6 < n < 86.8e6
    assert set(m.state_dict()) == set(R.param_shapes(ref_cfg | {"fpn_channels": 256}))
    with pytest.raises(ValueError, match="num_heads"):
        T.get_hyper_params("swin_b", swin=dict(num_heads=(4, 8, 16)))


def test_predict_fn_against_the_reference(params):
    """f32: the served proposals are the reference's selection, f32 rounding
    apart; bf16: the candidates at bf16 tolerance and nine in ten proposals
    within 0.02 of one the f32 path serves."""
    f = frames()
    boxes, logits, hw, cv = R.candidates(params, f, CFG)
    ref = R.select(boxes, logits, hw, cv, CFG)
    out = T.make_predict_fn(model(params), hyper_params(), from_uint8=True, device="cpu")(f)
    np.testing.assert_array_equal(out["num_valid"].numpy(), ref["num_valid"])
    np.testing.assert_allclose(out["roi_boxes"].numpy(), ref["roi_boxes"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["roi_scores"].numpy(), ref["roi_scores"], atol=1e-5, rtol=0)

    m16 = model(params, "bfloat16")
    x, _, _ = R.preprocess(f, CFG)
    with torch.no_grad():
        d16, l16 = m16(x.permute(0, 2, 3, 1))
    d32, l32 = R.rpn_head(params, R.fpn(params, R.swin(params, x, CFG)), CFG)
    close(d16, d32, 0.05)
    close(l16, l32, 0.05)
    assert (l16 - l32).abs().max() > 1e-4  # it did compute in bf16
    out16 = T.make_predict_fn(m16, hyper_params("bfloat16"), from_uint8=True, device="cpu")(f)
    d = (out16["roi_boxes"][:, :, None] - out["roi_boxes"][:, None]).abs().amax(-1)
    assert float((d.amin(-1) < 0.02).float().mean()) > 0.9


def test_selection_on_one_candidate_array(params):
    """The served selection (``select_levels``) and the reference's walk on
    one array of f32 candidates, bit for bit, clipped to the resized 256 x
    307 image."""
    boxes, logits, hw, cv = R.candidates(params, frames(), CFG)
    hp = hyper_params()
    levels = torch.cat([torch.full((min(200, n),), i, dtype=torch.int32)
                        for i, n in enumerate(level_sizes(hp, cv))])
    got = P.select_levels(boxes, logits, hp, hw, levels, 100, cv)
    ref = R.select(boxes, logits, hw, cv, CFG)
    for k in ("roi_boxes", "roi_scores", "num_valid"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    clip_x = float(torch.tensor(307 / 320))  # in f32, as the boxes
    assert float(got["roi_boxes"][..., 3].max()) <= clip_x < float(boxes[..., 3].max())


def test_span_tree_and_counters(params):
    fn = T.make_predict_fn(model(params, "bfloat16"), hyper_params("bfloat16"), from_uint8=True,
                           device="cpu")
    calls = dict(swin.window_attention_core.calls)
    with profiling.recording() as spans:
        fn(frames())
    names = [s[0] for s in spans]
    kids = lambda j: [s[0] for s in spans if s[1] == j]  # noqa: E731
    assert names[0] == "rpn.predict" and spans[0][1] is None
    assert kids(0) == ["rpn.upload", "rpn.stem", "rpn.backbone", "rpn.pyramid", "rpn.head",
                       "rpn.decode", "rpn.select"]
    # each block's core, whole; on the CPU the plain version's pad and
    # gathers inside it (the card's kernel has none)
    cores = [j for j, s in enumerate(spans) if s[1] == names.index("rpn.backbone")]
    assert [names[j] for j in cores] == [f"rpn.attn.{kind}" for kind in ("window", "shifted") * 4]
    assert all(kids(j) == ["rpn.attn.layout", "rpn.attn.layout"] for j in cores)
    assert swin.window_attention_core.calls["window"] - calls["window"] == 4
    assert swin.window_attention_core.calls["shifted"] - calls["shifted"] == 4
    # the published model: 12 window and 12 shifted cores a forward
    blocks = [b for b in T.get_model(T.get_hyper_params("swin_b")).modules()
              if isinstance(b, swin.SwinBlock)]
    assert [b.shift for b in blocks].count(0) == 12 == [b.shift for b in blocks].count(3)


def test_init_model_draws_swins_initialization():
    hp = hyper_params()
    m = T.init_model(T.get_model(hp), torch.Generator().manual_seed(0), device="cpu")
    blk = m.backbone.layers[2].blocks[1]
    table = blk.attn.relative_position_bias_table.detach()
    assert table.shape == (169, 4) and table.any() and 0.01 < float(table.std()) < 0.03
    assert not blk.attn.qkv.bias.any()
    assert torch.equal(blk.norm1.weight, torch.ones(128))
    assert m.backbone.layers[0].downsample.reduction.bias is None
    with torch.no_grad():
        assert 0.015 < float(blk.attn.qkv.weight.std()) < 0.025
        assert 0.005 < float(m.objectness.weight.std()) < 0.015
    out = T.make_predict_fn(m, hp, from_uint8=True, device="cpu")(frames())
    assert out["roi_boxes"].shape == (2, 100, 4) and (out["num_valid"] > 0).all()


def test_training_and_fast_serving_refuse_it(params):
    hp = hyper_params()
    with pytest.raises(ValueError, match="feature pyramid"):
        T.make_train_step(hp)
    with pytest.raises(ValueError, match="fast=True"):
        T.make_predict_fn(model(params), hp, fast=True, device="cpu")


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("shifted", [False, True])
def test_core_on_the_card_matches_the_cpu(cuda, stage, shifted):
    """The card's core (one ``swin_attention_kernel`` launch) against the
    CPU's plain version (the equations in f32) on the same bf16 qkv product
    at Swin-B's stage grids, unpadded (they pad by 3 x 1, 5 x 4, 6 x 2 and
    3 x 1 tokens), and heads (two images; a qkv bias at std 1, the pad
    keys; the tables at std 1). Tolerance: the card rounds P to bf16 for P
    V (at most 2^-9 of a probability, so of the largest |v|) and its output
    to bf16, as the plain version rounds its own (2^-9 of the value each):
    each output within 2^-8 of itself plus 2^-8 of the largest |v|, and
    the mean error under 0.5 % of the mean magnitude. Without the bias the
    error is of the outputs' own size."""
    card_against_cpu(cuda, PUBLISHED_GRIDS[stage], 4 << stage, shifted, stage + 10 * shifted)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [3, 6])
def test_core_on_the_card_with_a_partial_head_group(cuda, heads):
    """Swin-T's and -S's heads of 32 (3, 6, 12, 24): the kernel's last group
    of four heads is partial, and the channels past the last head are the
    next tensor's (k's after q's); held as above on Swin-T's stride-32 grid
    (25 x 34 at 800 x 1088), shifted."""
    card_against_cpu(cuda, (25, 34), heads, True, heads)


def card_against_cpu(cuda, hw, heads, shifted, seed):
    from tpurpn_torch.kernels.swin_attention import swin_attention

    c = 32 * heads
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((2, *hw, 3 * c), generator=g).to(torch.bfloat16)
    bias = torch.randn((3 * c,), generator=g).to(torch.bfloat16)
    table = torch.randn((169, heads), generator=g)
    shift = 3 if shifted else 0
    want = swin.window_attention_core(qkv, bias, table, heads, 7, shift, shifted).float()
    dev = [t.to(cuda) for t in (qkv, bias, table)]
    n0 = swin_attention.launches
    with torch.no_grad():
        got = swin.window_attention_core(*dev, heads, 7, shift, shifted)
        bare = swin.window_attention_core(dev[0], dev[1], torch.zeros_like(dev[2]), heads, 7,
                                          shift, shifted)
    assert swin_attention.launches - n0 == 2
    assert got.shape == qkv.shape[:3] + (c,) and got.dtype == torch.bfloat16
    vmax = max(float(qkv[..., 2 * c:].abs().max()), float(bias[2 * c:].abs().max()))
    err = (got.float().cpu() - want).abs()
    assert bool((err <= 2 ** -8 * (want.abs() + vmax)).all()), float(err.max())
    assert float(err.mean()) < 0.005 * float(want.abs().mean())
    assert float((bare.float().cpu() - want).abs().mean()) > 0.1 * float(want.abs().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d64", "window8", "float32", "autograd", "heads64"])
def test_kernel_refuses_on_the_card(cuda, case):
    """A CUDA call the kernel does not take raises ValueError, with no
    fallback: heads of 64, a window of 8, f32, a call autograd would
    differentiate, more than 32 heads."""
    from tpurpn_torch.kernels.swin_attention import swin_attention

    heads, d, window, dtype = 4, 32, 7, torch.bfloat16
    if case == "d64":
        d = 64
    elif case == "window8":
        window = 8
    elif case == "float32":
        dtype = torch.float32
    elif case == "heads64":
        heads = 64
    qkv = torch.randn((1, 14, 14, 3 * heads * d), device=cuda).to(dtype)
    bias = torch.zeros((3 * heads * d,), device=cuda, dtype=dtype)
    table = torch.zeros(((2 * window - 1) ** 2, heads), device=cuda)
    if case == "autograd":
        table.requires_grad_(True)
    n0 = swin_attention.launches
    with pytest.raises(ValueError):
        swin_attention(qkv, bias, table, heads, window, 3, True)
    assert swin_attention.launches == n0


@pytest.mark.cuda
def test_swin_serves_on_the_card(cuda):
    """The published Swin-B (portbench's configuration: widths, depth and the
    weights' draw) on a 256 x 320 canvas through make_predict_fn on the
    card: 12 window and 12 shifted cores a forward, each one
    ``swin_attention_kernel`` launch, and one proposal kernel launch a
    batch, proposals the reference's within two of its counts and nine in
    ten within 0.02 of one it keeps."""
    from tpurpn_torch.kernels.swin_attention import swin_attention

    cfg = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                      / "swin_b-800-serve.json").read_text())
    cfg.update(min_size_test=256, max_size_test=320, pre_nms_topk=200, post_nms_topk=100)
    hp = T.get_hyper_params("swin_b", canvas_rule=(256, 320, 32), pre_nms_topn=200,
                            test_nms_topn=100, compute_dtype="bfloat16")
    params = R.draw_params(cfg, cfg["init"]["seed"])
    m = T.get_model(hp)
    m.load_state_dict(params)
    fn = T.make_predict_fn(T.model.to_device(m.eval(), cuda), hp, from_uint8=True, device=cuda)
    calls, p0 = dict(swin.window_attention_core.calls), proposal.fused_proposals.launches
    k0 = swin_attention.launches
    out = fn(frames())
    torch.cuda.synchronize()
    assert swin_attention.launches - k0 == 24
    assert swin.window_attention_core.calls["window"] - calls["window"] == 12
    assert swin.window_attention_core.calls["shifted"] - calls["shifted"] == 12
    assert proposal.fused_proposals.launches - p0 == 1
    boxes, logits, hw, cv = R.candidates({k: v.to(cuda) for k, v in params.items()},
                                         frames().to(cuda), cfg)
    ref = R.select(boxes, logits, hw, cv, cfg)
    assert np.abs(out["num_valid"].cpu().numpy() - ref["num_valid"]).max() <= 2
    d = (out["roi_boxes"].cpu()[:, :, None] - torch.from_numpy(ref["roi_boxes"])[:, None])
    assert float((d.abs().amax(-1).amin(-1) < 0.02).float().mean()) > 0.9
