"""MViTv2-B's RPN in the port (``backbones/mvit.py``, ``model.PyramidRPN``,
the level path on a rectangular canvas) against the plain reference
``portbench/reference/mvit.py``, at tiny widths on the CPU: 11 blocks of
heads 16 wide (stages of 16, 32, 64 and 128 channels, ending at blocks 1,
4, 7 and 10: MViTv2-B's pattern with stage 4 cut to three blocks), query
windows of 16, key stride 4, tables at a 64-px pre-training size, on a 96
x 160 canvas (a stride-4 grid of 24 x 40). It has every kind of block in
MViTv2-B's table: windows whose query and key grids are at ratios 4, 2, 1
(pooled queries and not) and 1/2 (pooled queries), and global cores at
ratios 4, 2 and 1 with interpolated, non-square tables. Weights are the
reference's draw (every tensor non-zero).

Tolerances: the port in f32 computes the reference's equations with other
kernels (the pooling as one depthwise conv over every head, einsum
orders, a chunked core), so f32 rounding apart: 1e-5 of the values'
scale. In bf16 the forward's outputs are held at 0.05 of the largest
magnitude, as ViTDet's (some eight bf16 roundings a block over ten blocks
of residual sums), and nine in ten proposals within 0.02 of one the f32
path serves (a bf16 logit swaps neighbours of the selection). Anchors,
tables and selection on the same candidates are exact.

Marked ``cuda`` (the card only; this file imports no JAX):
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mvit.py``.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tpurpn_torch as T
from tpurpn_torch import predict as P
from tpurpn_torch import profiling
from tpurpn_torch.anchors import generate_level_anchors, level_sizes
from tpurpn_torch.backbones import mvit
from tpurpn_torch.kernels import proposal

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import mvit as R  # noqa: E402
from portbench.reference import vitdet as RV  # noqa: E402

CFG = dict(embed_dim=16, depth=11, num_heads=1, last_block_indexes=[1, 4, 7, 10], mlp_ratio=4.0,
           patch_kernel=7, patch_stride=4, patch_padding=3, pool_kernel=3, adaptive_kv_stride=4,
           adaptive_window_size=16, residual_pooling=True, pretrain_img_size=64, ln_eps=1e-6,
           fpn_channels=16, head_convs=1, min_size_test=96, max_size_test=160,
           size_divisibility=32, anchor_sizes=[32, 64, 128, 256, 512],
           anchor_ratios=[0.5, 1.0, 2.0], strides=[4, 8, 16, 32, 64], pre_nms_topk=200,
           post_nms_topk=100, nms_thresh=0.7, box_weights=[1.0, 1.0, 1.0, 1.0],
           scale_clamp=math.log(1000.0 / 16), pixel_mean=[123.675, 116.28, 103.53],
           pixel_std=[58.395, 57.12, 57.375],
           init=dict(patch_weight="fan_in", patch_bias=0.02, linear_weight=0.05, linear_bias=0.02,
                     norm_weight=0.1, norm_bias=0.05, pool_weight="fan_in", rel_pos=0.3,
                     fpn_weight="fan_in", fpn_bias=0.02, head_conv_weight="fan_in",
                     head_conv_bias=0.02, objectness_weight=0.3, objectness_bias=0.1,
                     deltas_weight=0.1, deltas_bias=0.02))
CANVAS = (96, 160)


def hyper_params(dtype="float32", **kw):
    cfg = dict(embed_dim=16, depth=11, last_block_indexes=(1, 4, 7, 10), adaptive_window_size=16,
               pretrain_img_size=64, fpn_channels=16)
    return T.get_hyper_params("mvitv2_b", mvit=cfg, canvas_rule=(96, 160, 32), pre_nms_topn=200,
                              test_nms_topn=100, compute_dtype=dtype, **kw)


@pytest.fixture(scope="module")
def params():
    return R.draw_params(CFG, 11)


def model(params, dtype="float32"):
    m = T.get_model(hyper_params(dtype))
    m.load_state_dict(params)
    return m.eval()


def frames(n=2, h=60, w=96, seed=1):
    """RGB frames that resize to 96 x 154 on the 96 x 160 canvas."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, generator=g)


def close(got, ref, rel):
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=rel * scale)


def core_grids(cfg, canvas):
    """Each block's attention core on ``canvas``, from ``cfg.blocks()`` and
    the pools' ceilings: its kind, the query and key grids it attends over
    (a window's, or the whole grids), the cores an image, the heads."""
    def pool(hw, s):
        return tuple(-(-x // s) for x in hw)

    hw = tuple((c + 2 * cfg.patch_padding - cfg.patch_kernel) // cfg.patch_stride + 1
               for c in canvas)
    out = []
    for s in cfg.blocks():
        q_hw, kv_hw = pool(hw, s["stride_q"]), pool(hw, s["stride_kv"])
        if s["window"]:
            qw, kw = s["window"] // s["stride_q"], s["window"] // s["stride_kv"]
            n = -(-q_hw[0] // qw) * -(-q_hw[1] // qw)
            out.append(dict(kind="window", q=(qw, qw), kv=(kw, kw), cores=n, heads=s["heads"]))
        else:
            out.append(dict(kind="global", q=q_hw, kv=kv_hw, cores=1, heads=s["heads"]))
        hw = q_hw
    return out


# --- the pooled core ----------------------------------------------------------


CORES = {  # (q grid, kv grid, table rows): the ratios and kinds MViTv2-B has
    "window-ratio4": ((16, 16), (4, 4), 31),
    "window-ratio2": ((8, 8), (4, 4), 15),
    "window-ratio1": ((4, 4), (4, 4), 7),
    "window-ratio-half": ((4, 4), (8, 8), 15),
    "global-ratio4-interp": ((12, 20), (3, 5), 15),
    "global-ratio2-interp": ((6, 10), (3, 5), 7),
    "global-ratio1-interp": ((3, 5), (3, 5), 3),
    "global-half-interp": ((3, 5), (6, 10), 7),
}


@pytest.mark.parametrize("name", list(CORES))
def test_pooled_core_against_the_reference(name):
    """The port's core (its CPU path) against the reference's equations, with
    the reference's ``get_rel_pos`` tables, f32 rounding apart; both
    relative terms live."""
    q_hw, kv_hw, rows = CORES[name]
    g = torch.Generator().manual_seed(len(name))
    n, h, d = 3, 2, 16
    q = torch.randn((n, h, q_hw[0] * q_hw[1], d), generator=g)
    k = torch.randn((n, h, kv_hw[0] * kv_hw[1], d), generator=g)
    v = torch.randn((n, h, kv_hw[0] * kv_hw[1], d), generator=g)
    rel_h, rel_w = (torch.randn((rows, d), generator=g) for _ in range(2))
    got = mvit.pooled_attention_core(q, k, v, rel_h, rel_w, q_hw, kv_hw, "global")
    want = R.core(q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1),
                  R.get_rel_pos(q_hw[0], kv_hw[0], rel_h), R.get_rel_pos(q_hw[1], kv_hw[1], rel_w),
                  q_hw, kv_hw).unflatten(0, (n, h))
    assert got.shape == q.shape
    close(got, want, 1e-5)
    for i in range(2):
        tabs = [rel_h, rel_w]
        tabs[i] = torch.zeros_like(tabs[i])
        other = mvit.pooled_attention_core(q, k, v, *tabs, q_hw, kv_hw, "global")
        assert (other - got).abs().max() > 1e-3


@pytest.mark.parametrize("q_size,k_size,rows", [(56, 14, 111), (28, 28, 55), (28, 14, 55),
                                                (14, 28, 55), (7, 14, 27), (100, 25, 55),
                                                (136, 34, 55), (50, 25, 27), (68, 34, 27),
                                                (25, 25, 13), (34, 34, 13), (13, 5, 7)])
def test_rel_pos_table_is_get_rel_pos(q_size, k_size, rows):
    """The port's gathered (and, where the rows differ, interpolated) table is
    detectron2's ``get_rel_pos``, bit for bit, at MViTv2-B's grids."""
    t = torch.randn((rows, 8), generator=torch.Generator().manual_seed(rows))
    got = mvit.rel_pos_table(t, q_size, k_size, torch.float32)
    assert torch.equal(got, R.get_rel_pos(q_size, k_size, t))


# --- the model ------------------------------------------------------------------


def test_backbone_and_fpn_against_the_reference(params):
    m = model(params)
    x, hw, cv = R.preprocess(frames(), CFG)
    assert (hw, cv) == ((96, 154), CANVAS)
    with torch.no_grad():
        feats = m.backbone(x.permute(0, 2, 3, 1))
        levels = m.pyramid(feats)
    ref = R.mvit(params, x, CFG)
    for got, want in zip(feats, ref):
        close(got, want, 1e-5)
    assert [tuple(t.shape[2:]) for t in levels] == [(24, 40), (12, 20), (6, 10), (3, 5), (2, 3)]
    for got, want in zip(levels, R.fpn(params, ref)):
        close(got, want, 1e-5)
    # residual pooling is a live term
    with torch.no_grad():
        m.backbone.blocks[4].attn.residual_pooling = False
        assert (m.backbone(x.permute(0, 2, 3, 1))[-1] - feats[-1]).abs().max() > 1e-3


def test_every_kind_of_block_is_in_the_small_model():
    """(kind, query side / key side, queries pooled) of MViTv2-B's table's
    rows, each in the small model."""
    grids = core_grids(hyper_params().mvit, CANVAS)
    kinds = {(c["kind"], c["q"][0] / c["kv"][0], s["stride_q"] > 1)
             for c, s in zip(grids, hyper_params().mvit.blocks())}
    assert kinds == {("window", 4, False), ("window", 1, True), ("window", 2, False),
                     ("global", 4, False), ("window", 0.5, True), ("window", 1, False),
                     ("global", 2, False), ("global", 1, False)}


def test_published_blocks_levels_and_anchors():
    """MViTv2-B's block table, level shapes and 217,413 anchors on COCO's 480
    x 640 frame, as arithmetic; the anchors the reference's, bit for bit."""
    hp = T.get_hyper_params("mvitv2_b")
    assert hp.canvas_of(480, 640) == ((800, 1067), (800, 1088)) and hp.canvas is None
    canvas = (800, 1088)
    assert hp.level_shapes(canvas) == ((200, 272), (100, 136), (50, 68), (25, 34), (13, 17))
    assert sum(level_sizes(hp, canvas)) == 217413 == 72471 * 3
    table = [  # (q grid, kv grid, heads, kind, q / kv window, table rows)
        *[((200, 272), (50, 68), 1, "window", (56, 14), 111)] * 2,
        ((100, 136), (100, 136), 2, "window", (28, 28), 55),
        ((100, 136), (50, 68), 2, "window", (28, 14), 55),
        ((100, 136), (25, 34), 2, "global", None, 55),
        ((50, 68), (100, 136), 4, "window", (14, 28), 55),
        *[((50, 68), (50, 68), 4, "window", (14, 14), 27)] * 14,
        ((50, 68), (25, 34), 4, "global", None, 27),
        ((25, 34), (50, 68), 8, "window", (7, 14), 27),
        ((25, 34), (25, 34), 8, "window", (7, 7), 13),
        ((25, 34), (25, 34), 8, "global", None, 13),
    ]
    cores = core_grids(hp.mvit, canvas)
    settings = hp.mvit.blocks()
    assert len(cores) == len(table) == 24
    for i, (c, s, (q, kv, heads, kind, win, rows)) in enumerate(zip(cores, settings, table)):
        assert (c["kind"], c["heads"], s["table"]) == (kind, heads, rows), i
        if kind == "window":
            assert (c["q"][0], c["kv"][0], c["cores"]) == (*win, 20), i
        else:
            assert (c["q"], c["kv"]) == (q, kv), i
    assert [c["kind"] for c in cores].count("global") == 3
    assert [s["dim_out"] // s["heads"] for s in settings] == [96] * 24
    ref_cfg = dict(CFG, embed_dim=96, depth=24, last_block_indexes=[1, 4, 20, 23],
                   adaptive_window_size=56, pretrain_img_size=224)
    assert [b["rel_dim"] for b in R.blocks(ref_cfg)] == [s["table"] for s in settings]
    anc, lev = R.anchors(ref_cfg, canvas)
    assert torch.equal(generate_level_anchors(hp, canvas=canvas), anc)
    assert torch.equal(torch.bincount(lev), torch.tensor(level_sizes(hp, canvas)))
    with pytest.raises(ValueError, match="canvas"):
        hp.level_shapes()


def test_rectangular_anchors_and_stem():
    hp = hyper_params()
    anc = generate_level_anchors(hp, canvas=CANVAS)
    ref, _ = R.anchors(CFG, CANVAS)
    assert torch.equal(anc, ref) and anc.shape[0] == 3 * (960 + 240 + 60 + 15 + 6)
    # P2's first location: size 32, ratio 1 centred on (0, 0), y over 96, x over 160
    torch.testing.assert_close(anc[1], torch.tensor([-16 / 96, -16 / 160, 16 / 96, 16 / 160]))
    mean, std = torch.tensor(hp.pixel_mean), torch.tensor(hp.pixel_std)
    for shape in [(60, 96), (96, 60), (40, 200)]:
        f = frames(1, *shape)
        got, hw = P.level_stem(f, hp, mean, std)
        x, ref_hw, cv = R.preprocess(f, CFG)
        assert hw == ref_hw and got.shape[1:3] == cv and cv[0] % 32 == 0 == cv[1] % 32
        close(got, x.permute(0, 2, 3, 1), 1e-6)
        assert not got[:, hw[0]:].any() and not got[:, :, hw[1]:].any()


def test_predict_fn_against_the_reference(params):
    """f32: the served proposals are the reference's (f32 rounding apart);
    bf16: the candidates at bf16 tolerance and nine in ten proposals within
    0.02 of one the f32 path serves."""
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
    d32, l32 = R.rpn_head(params, R.fpn(params, R.mvit(params, x, CFG)), CFG)
    close(d16, d32, 0.05)
    close(l16, l32, 0.05)
    assert (l16 - l32).abs().max() > 1e-4  # it did compute in bf16
    out16 = T.make_predict_fn(m16, hyper_params("bfloat16"), from_uint8=True, device="cpu")(f)
    d = (out16["roi_boxes"][:, :, None] - out["roi_boxes"][:, None]).abs().amax(-1)
    assert float((d.amin(-1) < 0.02).float().mean()) > 0.9


def test_selection_on_the_canvas_bit_for_bit(params):
    """The level-wise selection on a rectangular canvas: the reference's walk
    on the same f32 candidates, and the clip to the resized 96 x 154 image
    in x (154 / 160) and none in y."""
    boxes, logits, hw, cv = R.candidates(params, frames(), CFG)
    hp = hyper_params()
    levels = torch.cat([torch.full((min(200, n),), i, dtype=torch.int32)
                        for i, n in enumerate(level_sizes(hp, cv))])
    got = P.select_levels(boxes, logits, hp, hw, levels, 100, cv)
    ref = R.select(boxes, logits, hw, cv, CFG)
    for k in ("roi_boxes", "roi_scores", "num_valid"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert float(got["roi_boxes"][..., 3].max()) <= 154 / 160 < float(boxes[..., 3].max())


def test_span_tree_and_counters(params):
    fn = T.make_predict_fn(model(params, "bfloat16"), hyper_params("bfloat16"), from_uint8=True,
                           device="cpu")
    calls = dict(mvit.pooled_attention_core.calls)
    with profiling.recording() as spans:
        fn(frames())
    names = [s[0] for s in spans]
    kids = lambda j: [s[0] for s in spans if s[1] == j]  # noqa: E731
    assert names[0] == "rpn.predict" and spans[0][1] is None
    assert kids(0) == ["rpn.upload", "rpn.stem", "rpn.backbone", "rpn.pyramid", "rpn.head",
                       "rpn.decode", "rpn.select"]
    kinds = [c["kind"] for c in core_grids(hyper_params().mvit, CANVAS)]
    inner = [n for kind in kinds for n in ("rpn.attn.pool", f"rpn.attn.{kind}")]
    assert kids(names.index("rpn.backbone")) == inner
    assert mvit.pooled_attention_core.calls["window"] - calls["window"] == 8
    assert mvit.pooled_attention_core.calls["global"] - calls["global"] == 3
    # the published model: 21 window and 3 global cores a forward
    kinds = [c["kind"] for c in core_grids(T.get_hyper_params("mvitv2_b").mvit, (800, 1088))]
    assert kinds.count("window") == 21 and kinds.count("global") == 3


def test_init_model_draws_detectron2s_initialization():
    hp = hyper_params()
    m = T.init_model(T.get_model(hp), torch.Generator().manual_seed(0), device="cpu")
    attn = m.backbone.blocks[2].attn
    assert not attn.rel_pos_h.any() and not attn.qkv.bias.any()
    assert torch.equal(m.backbone.blocks[2].norm1.weight, torch.ones(16))
    with torch.no_grad():
        assert 0.015 < float(attn.qkv.weight.std()) < 0.025
        assert float(attn.pool_q.weight.abs().max()) <= 1 / 3 and attn.pool_q.bias is None
        w = m.pyramid.fpn_output3.weight  # kaiming uniform, a = 1: bound sqrt(3 / fan_in)
        assert float(w.abs().max()) <= math.sqrt(3 / (16 * 9)) and not m.pyramid.fpn_output3.bias.any()
        assert 0.005 < float(m.objectness.weight.std()) < 0.015
    out = T.make_predict_fn(m, hp, from_uint8=True, device="cpu")(frames())
    assert out["roi_boxes"].shape == (2, 100, 4) and (out["num_valid"] > 0).all()


def test_training_and_fast_serving_refuse_it(params):
    hp = hyper_params()
    with pytest.raises(ValueError, match="feature pyramid"):
        T.make_train_step(hp)
    with pytest.raises(ValueError, match="fast=True"):
        T.make_predict_fn(model(params), hp, fast=True, device="cpu")
    with pytest.raises(ValueError, match="last_block_indexes"):
        T.get_hyper_params("mvitv2_b", mvit=dict(last_block_indexes=(1, 4, 20)))


# --- ViTDet's outputs through the generalised level path -----------------------


def old_vitdet_path(model, hp, images, mean, std):
    """ViTDet's serving as the level path computed it on its one square
    canvas before the canvas was a pair: the square stem, anchors divided by
    ``img_size``, levels of s * s locations, the clip by ``img_size``."""
    S, dev = hp.img_size, images.device
    _, H, W, _ = images.shape
    nh, nw = P.resized_shape(H, W, S)
    x = F.interpolate(images.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=nh < H or nw < W)
    x = ((x.permute(0, 2, 3, 1) - mean) / std).to(getattr(torch, hp.compute_dtype))
    rpn_reg, logits = model(F.pad(x, (0, 0, 0, S - nw, 0, S - nh)))
    fm, out = hp.feature_map_shape, []
    sides = (4 * fm, 2 * fm, fm, fm // 2, (fm // 2 + 1) // 2)
    for size, stride, s in zip(hp.anchor_scales, hp.level_strides, sides):
        ratios = torch.tensor(hp.anchor_ratios, dtype=torch.float64)
        w = torch.sqrt(size * size / ratios)
        h = ratios * w
        base = torch.stack([-w / 2, -h / 2, w / 2, h / 2], -1).float()
        shift = torch.arange(0, s * stride, step=stride, dtype=torch.float32)
        sy, sx = torch.meshgrid(shift, shift, indexing="ij")
        sx, sy = sx.reshape(-1), sy.reshape(-1)
        a = (torch.stack([sx, sy, sx, sy], -1)[:, None, :] + base[None]).reshape(-1, 4)
        out.append(a[:, [1, 0, 3, 2]] / hp.img_size)
    boxes = T.boxes.apply_deltas(torch.cat(out).to(dev)[None], rpn_reg, hp.box_weights,
                                 hp.scale_clamp)
    sizes = [s * s * 3 for s in sides]
    idx, start = [], 0
    for n in sizes:
        idx.append(proposal.top_candidates(logits[:, start:start + n], min(hp.pre_nms_topn, n))
                   + start)
        start += n
    idx = torch.cat(idx, 1)
    levels = torch.cat([torch.full((min(hp.pre_nms_topn, n),), lv, dtype=torch.int32)
                        for lv, n in enumerate(sizes)]).to(dev)
    cand = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    score = torch.gather(logits, 1, idx)
    h, w = nh / hp.img_size, nw / hp.img_size
    cand = torch.stack([cand[..., 0].clamp(0.0, h), cand[..., 1].clamp(0.0, w),
                        cand[..., 2].clamp(0.0, h), cand[..., 3].clamp(0.0, w)], -1)
    ok = ((cand[..., 2] > cand[..., 0]) & (cand[..., 3] > cand[..., 1])
          & torch.isfinite(cand).all(-1) & torch.isfinite(score))
    score = torch.where(ok, score, float("-inf"))
    sel = proposal.fused_proposals(cand, score, idx.shape[1], hp.nms_iou_threshold,
                                   hp.test_nms_topn, levels=levels)
    valid = torch.arange(hp.test_nms_topn, device=dev) < sel["num_valid"][:, None]
    sel["roi_scores"] = torch.where(valid, torch.sigmoid(sel["roi_scores"]), 0.0)
    return sel


def vitdet_served_bits(hp, params, frames_u8, dev):
    m = T.get_model(hp)
    m.load_state_dict(params)
    m = T.model.to_device(m, dev)
    got = T.make_predict_fn(m, hp, from_uint8=True, device=dev)(frames_u8)
    mean = torch.tensor(hp.pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(hp.pixel_std, dtype=torch.float32, device=dev)
    with torch.no_grad():
        want = old_vitdet_path(m, hp, frames_u8.to(dev), mean, std)
    for k in ("roi_boxes", "roi_scores", "num_valid"):
        assert torch.equal(got[k].cpu(), want[k].cpu()), k
    return got


VITDET_CFG = dict(img_size=128, embed_dim=32, depth=4, num_heads=2, mlp_ratio=4.0, patch_size=16,
                  window_size=3, global_blocks=[1, 3], pretrain_img_size=224, pyramid_channels=16,
                  head_convs=2, anchor_ratios=[0.5, 1.0, 2.0],
                  init=dict(vit_weight=0.05, vit_bias=0.02, norm_weight=0.1, norm_bias=0.05,
                            rel_pos=0.3, pos_embed=0.02, pyramid_weight="fan_in",
                            pyramid_bias=0.02, head_conv_weight="fan_in", head_conv_bias=0.02,
                            objectness_weight=0.3, objectness_bias=0.1, deltas_weight=0.1,
                            deltas_bias=0.02))


def test_vitdet_serves_the_square_canvas_bit_for_bit():
    """ViTDet's served proposals through the generalised level path are those
    of the square-only formulas, bit for bit, on the same frames and
    weights (a tiny ViTDet at 128 px on the CPU)."""
    hp = T.get_hyper_params("vitdet_b", img_size=128, vit=dict(
        embed_dim=32, depth=4, num_heads=2, window_size=3, global_blocks=(1, 3),
        pyramid_channels=16), pre_nms_topn=200, test_nms_topn=100, compute_dtype="bfloat16")
    out = vitdet_served_bits(hp, RV.draw_params(VITDET_CFG, 11), frames(2, 96, 128), "cpu")
    assert (out["num_valid"] > 50).all()


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


PUBLISHED_CORES = {  # block: (n cores, heads, q grid, kv grid, table rows)
    "block0-window": (40, 1, (56, 56), (14, 14), 111),
    "block4-global": (2, 2, (100, 136), (25, 34), 55),
    "block5-window": (40, 4, (14, 14), (28, 28), 55),
    "block20-global": (2, 4, (50, 68), (25, 34), 27),
    "block23-global": (2, 8, (25, 34), (25, 34), 13),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PUBLISHED_CORES))
def test_pooled_core_on_the_card_matches_the_cpu(cuda, name):
    """The card's core (the bf16 bias and SDPA) against the CPU's plain
    equations in f32 on the same bf16 q, k, v, at MViTv2-B's shapes (two
    images). Tolerance: the card rounds q . R_h, q . R_w and their sum to
    bf16 (a logit moves by up to 2^-8 of bias terms of several units, about
    0.03), P to bf16 for P V and its output to bf16; so each output within
    2^-5 of the largest and the mean error under 2 % of the mean magnitude
    (the card read at most 1.6 % and 0.9 %). Without the relative terms the
    error is of the outputs' own size."""
    n, h, q_hw, kv_hw, rows = PUBLISHED_CORES[name]
    g = torch.Generator().manual_seed(n + rows)
    tq, tk, d = q_hw[0] * q_hw[1], kv_hw[0] * kv_hw[1], 96
    q, k, v = (torch.randn((n, t, h, d), generator=g).to(torch.bfloat16).transpose(1, 2)
               for t in (tq, tk, tk))
    rel_h, rel_w = (torch.randn((rows, d), generator=g) * 0.15 for _ in range(2))
    want = mvit.pooled_attention_core(q, k, v, rel_h, rel_w, q_hw, kv_hw, "global").float()
    with torch.no_grad():
        got = mvit.pooled_attention_core(q.to(cuda), k.to(cuda), v.to(cuda), rel_h.to(cuda),
                                         rel_w.to(cuda), q_hw, kv_hw, "global")
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    err = (got.float().cpu() - want).abs()
    assert float(err.max()) <= 2 ** -5 * float(want.abs().max())
    assert float(err.mean()) < 0.02 * float(want.abs().mean())
    zero = torch.zeros_like(rel_h, device=cuda)
    with torch.no_grad():
        bare = mvit.pooled_attention_core(q.to(cuda), k.to(cuda), v.to(cuda), zero, zero, q_hw,
                                          kv_hw, "global")
    assert float((bare.float().cpu() - want).abs().mean()) > 0.1 * float(want.abs().mean())


@pytest.mark.cuda
def test_mvit_serves_on_the_card(cuda, params):
    """The tiny model through make_predict_fn on the card: one proposal
    kernel launch a batch, proposals the reference's within two of its
    counts and nine in ten within 0.02 of one it keeps."""
    hp = hyper_params("bfloat16")
    m = T.get_model(hp)
    m.load_state_dict(params)
    fn = T.make_predict_fn(T.model.to_device(m, cuda), hp, from_uint8=True, device=cuda)
    n0 = proposal.fused_proposals.launches
    out = fn(frames())
    torch.cuda.synchronize()
    assert proposal.fused_proposals.launches - n0 == 1
    boxes, logits, hw, cv = R.candidates({k: v.to(cuda) for k, v in params.items()},
                                         frames().to(cuda), CFG)
    ref = R.select(boxes, logits, hw, cv, CFG)
    assert np.abs(out["num_valid"].cpu().numpy() - ref["num_valid"]).max() <= 2
    d = (out["roi_boxes"].cpu()[:, :, None] - torch.from_numpy(ref["roi_boxes"])[:, None])
    assert float((d.abs().amax(-1).amin(-1) < 0.02).float().mean()) > 0.9


@pytest.mark.cuda
def test_vitdet_serves_the_published_canvas_bit_for_bit(cuda):
    """ViTDet-B at its published size on the card, 16 uint8 480 x 640
    frames: the generalised level path serves the square-only formulas'
    proposals bit for bit."""
    import json

    cfg = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                      / "vitdet_b-1024-serve.json").read_text())
    hp = T.get_hyper_params("vitdet_b")
    out = vitdet_served_bits(hp, RV.draw_params(cfg, cfg["init"]["seed"]),
                             frames(16, 480, 640, seed=7), cuda)
    assert int(out["num_valid"].min()) > 500
