"""ViTDet-B's RPN in the port (``backbones/vit.py``, ``model.PyramidRPN``,
``anchors.generate_level_anchors``, ``predict``'s level path) against the
plain reference ``portbench/reference/vitdet.py``, at tiny widths on the CPU:
embed 32, 2 heads, 4 blocks with globals at 1 and 3, a 128-px canvas (8 x 8
tokens) and window 3, so the grid pads to 9 x 9. Weights are the
reference's draw (every tensor non-zero).

Tolerances: the port in f32 computes the reference's equations with other
kernels (SDPA against a materialised softmax, one patch matmul against a
strided conv, einsum orders), so f32 rounding apart: 1e-5 of the values'
scale. In bf16 the forward's outputs are held at 0.05 of the largest
magnitude (eight bf16 roundings a block, twelve blocks' worth of residual
sums at full size: PERF.md records the card's readings). Selection is held
bit for bit on the same f32 candidates, as the card's kernel is.

Marked ``cuda`` (the card only; this file imports no JAX):
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_vitdet.py``.
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
from tpurpn_torch.anchors import level_sizes
from tpurpn_torch.backbones import vit
from tpurpn_torch.kernels import proposal

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import vitdet as R  # noqa: E402

CFG = dict(img_size=128, embed_dim=32, depth=4, num_heads=2, mlp_ratio=4.0, patch_size=16,
           window_size=3, global_blocks=[1, 3], pretrain_img_size=224, pyramid_channels=16,
           head_convs=2, anchor_sizes=[32, 64, 128, 256, 512], anchor_ratios=[0.5, 1.0, 2.0],
           strides=[4, 8, 16, 32, 64], pre_nms_topk=200, post_nms_topk=100, nms_thresh=0.7,
           box_weights=[1.0, 1.0, 1.0, 1.0], scale_clamp=math.log(1000.0 / 16),
           pixel_mean=[123.675, 116.28, 103.53], pixel_std=[58.395, 57.12, 57.375],
           init=dict(vit_weight=0.05, vit_bias=0.02, norm_weight=0.1, norm_bias=0.05,
                     rel_pos=0.3, pos_embed=0.02, pyramid_weight="fan_in", pyramid_bias=0.02,
                     head_conv_weight="fan_in", head_conv_bias=0.02, objectness_weight=0.3,
                     objectness_bias=0.1, deltas_weight=0.1, deltas_bias=0.02))


def hyper_params(dtype="float32", **kw):
    vit_cfg = dict(embed_dim=32, depth=4, num_heads=2, window_size=3, global_blocks=(1, 3),
                   pyramid_channels=16)
    return T.get_hyper_params("vitdet_b", img_size=128, vit=vit_cfg, pre_nms_topn=200,
                              test_nms_topn=100, compute_dtype=dtype, **kw)


@pytest.fixture(scope="module")
def params():
    return R.draw_params(CFG, 11)


def model(params, dtype="float32"):
    m = T.get_model(hyper_params(dtype))
    m.load_state_dict(params)
    return m.eval()


def frames(n=2, h=96, w=128, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, generator=g)


def close(got, ref, rel):
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=rel * scale)


@pytest.mark.parametrize("block", [0, 1], ids=["window", "global"])
def test_blocks_against_the_reference(params, block):
    """Block 0 attends in 3 x 3 windows over the 8 x 8 grid padded to 9 x 9
    (pad tokens as unmasked keys); block 1 over all 64 tokens; both with
    the relative-position terms."""
    m = model(params)
    x = torch.randn((2, 8, 8, 32), generator=torch.Generator().manual_seed(3))
    b = f"backbone.blocks.{block}."
    y = R.layer_norm(x, params[b + "norm1.weight"], params[b + "norm1.bias"], 1e-6)
    if block == 0:
        assert m.backbone.blocks[0].window == 3 and m.backbone.blocks[1].window == 0
        w, pad_hw = R.window_partition(y, 3)
        assert pad_hw == (9, 9)
        y = R.window_unpartition(R.attention(params, b + "attn.", w, 2), 3, pad_hw, (8, 8))
    else:
        y = R.attention(params, b + "attn.", y, 2)
    x1 = x + y
    z = R.layer_norm(x1, params[b + "norm2.weight"], params[b + "norm2.bias"], 1e-6)
    want = x1 + R.linear(F.gelu(R.linear(z, params[b + "mlp.fc1.weight"],
                                         params[b + "mlp.fc1.bias"])),
                         params[b + "mlp.fc2.weight"], params[b + "mlp.fc2.bias"])
    with torch.no_grad():
        got = m.backbone.blocks[block](x)
    close(got, want, 1e-5)
    # the relative positions are a live term: without them the block differs
    with torch.no_grad():
        m.backbone.blocks[block].attn.rel_pos_h.zero_()
        assert (m.backbone.blocks[block](x) - got).abs().max() > 1e-3


def test_vit_and_pyramid_against_the_reference(params):
    m = model(params)
    x, _ = R.preprocess(frames(), CFG)
    with torch.no_grad():
        feat = m.backbone(x.permute(0, 2, 3, 1))
        levels = m.pyramid(feat)
    want = R.vit(params, x, CFG)
    close(feat, want, 1e-5)
    ref_levels = R.pyramid(params, want)
    assert [tuple(t.shape) for t in levels] == [(2, 16, s, s) for s in (32, 16, 8, 4, 2)]
    for got, ref in zip(levels, ref_levels):
        close(got, ref, 1e-5)


def test_anchors_level_order_and_decode_clamp():
    hp = hyper_params()
    anc = T.generate_anchors(hp)
    ref, lev = R.anchors(CFG)
    assert torch.equal(anc, ref)
    assert level_sizes(hp) == (3072, 768, 192, 48, 12) and anc.shape[0] == hp.total_anchors
    assert torch.equal(torch.bincount(lev), torch.tensor(level_sizes(hp)))
    # P2's first location: ratios 0.5, 1, 2 of size 32 centred on (0, 0)
    torch.testing.assert_close(anc[:3] * 128, torch.tensor(
        [[-8 * 2 ** 0.5, -16 * 2 ** 0.5, 8 * 2 ** 0.5, 16 * 2 ** 0.5], [-16.0, -16, 16, 16],
         [-16 * 2 ** 0.5, -8 * 2 ** 0.5, 16 * 2 ** 0.5, 8 * 2 ** 0.5]]))
    assert torch.equal(anc[3, [0, 2]], anc[0, [0, 2]]) and float(anc[3, 1] - anc[0, 1]) == 4 / 128
    d = torch.randn((2, anc.shape[0], 4), generator=torch.Generator().manual_seed(2))
    d[0, :5, 2:] = 10.0  # far past the clamp
    got = T.boxes.apply_deltas(anc[None], d, hp.box_weights, hp.scale_clamp)
    assert torch.equal(got, R.apply_deltas(d, anc[None], CFG))
    w = anc[:5, 3] - anc[:5, 1]
    torch.testing.assert_close(got[0, :5, 3] - got[0, :5, 1], w * 1000 / 16, rtol=1e-5, atol=0)


def candidates(seed=4, B=2):
    """Decoded boxes and logits of every anchor, with a cross-level pair above
    0.7 IoU at the top of P2 and P3 and an empty box after clipping."""
    hp = hyper_params()
    g = torch.Generator().manual_seed(seed)
    anc = T.generate_anchors(hp)
    d = torch.randn((B, anc.shape[0], 4), generator=g) * 0.3
    boxes = R.apply_deltas(d, anc[None], CFG)
    logits = torch.randn((B, anc.shape[0]), generator=g) * 2
    n2 = level_sizes(hp)[0]
    box = torch.tensor([0.2, 0.2, 0.5, 0.5])
    boxes[:, 5], boxes[:, n2 + 7] = box, box + torch.tensor([0.0, 0.0, 0.01, 0.0])
    logits[:, 5], logits[:, n2 + 7] = 9.0, 8.0
    boxes[:, 9] = torch.tensor([0.9, 0.2, 0.95, 0.3])  # below the 96-px image: empty
    logits[:, 9] = 10.0
    return hp, boxes, logits


def test_level_selection_bit_for_bit_against_the_reference():
    hp, boxes, logits = candidates()
    levels = torch.cat([torch.full((min(200, n),), i, dtype=torch.int32)
                        for i, n in enumerate(level_sizes(hp))])
    n0 = P.select_levels.candidates
    got = P.select_levels(boxes, logits, hp, (96, 128), levels, 100)
    assert P.select_levels.candidates - n0 == 2 * levels.numel() <= 2 * 4768
    ref = R.select(boxes, logits, (96, 128), CFG)
    for k in ("roi_boxes", "roi_scores", "num_valid"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    # the cross-level pair: both kept, first and second; the clipped-empty box not
    pair = torch.stack([boxes[0, 5], boxes[0, level_sizes(hp)[0] + 7]])
    assert float(R.iou(pair, pair)[0, 1]) > 0.7
    assert torch.equal(got["roi_boxes"][:, :2], pair.expand(2, 2, 4))
    assert not (got["roi_boxes"][:, :, 0] >= 0.75).any()
    # across levels (no ids) the pair's second box goes
    flat = proposal.fused_proposals(*_clipped(hp, boxes, logits), levels.numel(), 0.7, 100)
    assert not torch.equal(flat["roi_boxes"][:, 1], pair[1].expand(2, 4))


def _clipped(hp, boxes, logits):
    idx, start = [], 0
    for n in level_sizes(hp):
        idx.append(proposal.top_candidates(logits[:, start:start + n], min(200, n)) + start)
        start += n
    idx = torch.cat(idx, 1)
    c = R.clip(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), (96, 128), 128)
    s = torch.gather(logits, 1, idx)
    ok = (c[..., 2] > c[..., 0]) & (c[..., 3] > c[..., 1])
    return c, torch.where(ok, s, float("-inf"))


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (1024, 1024), (300, 1200), (96, 128)])
def test_stem_resize_normalise_pad(hw):
    hp = hyper_params()
    want_shape = R.resized_shape(hw[0], hw[1], 1024)
    assert P.resized_shape(hw[0], hw[1], 1024) == want_shape
    if hw == (480, 640):
        assert want_shape == (768, 1024)
    f = frames(1, hw[0] // 8, hw[1] // 8)
    mean = torch.tensor(hp.pixel_mean)
    std = torch.tensor(hp.pixel_std)
    got, shape = P.level_stem(f, hp, mean, std)
    x, ref_shape = R.preprocess(f, CFG)
    assert shape == ref_shape and got.shape == (1, 128, 128, 3)
    close(got, x.permute(0, 2, 3, 1), 1e-6)
    assert not got[:, shape[0]:].any() and not got[:, :, shape[1]:].any()


def test_predict_fn_against_the_reference(params):
    """f32: the served proposals are the reference's (f32 rounding apart);
    bf16: the forward at bf16 tolerance, and nine in ten proposals within
    0.02 of one the f32 path serves (a bf16 logit can swap two neighbours of
    the selection, and the top-k's last places)."""
    f = frames()
    boxes, logits, hw = R.candidates(params, f, CFG)
    ref = R.select(boxes, logits, hw, CFG)
    out = T.make_predict_fn(model(params), hyper_params(), from_uint8=True, device="cpu")(f)
    np.testing.assert_array_equal(out["num_valid"].numpy(), ref["num_valid"])
    np.testing.assert_allclose(out["roi_boxes"].numpy(), ref["roi_boxes"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["roi_scores"].numpy(), ref["roi_scores"], atol=1e-5, rtol=0)

    m16 = model(params, "bfloat16")
    x, _ = R.preprocess(f, CFG)
    with torch.no_grad():
        d16, l16 = m16(x.permute(0, 2, 3, 1))
    d32, l32 = R.rpn_head(params, R.pyramid(params, R.vit(params, x, CFG)), CFG)
    close(d16, d32, 0.05)
    close(l16, l32, 0.05)
    assert (l16 - l32).abs().max() > 1e-4  # it did compute in bf16
    out16 = T.make_predict_fn(m16, hyper_params("bfloat16"), from_uint8=True, device="cpu")(f)
    assert torch.equal(out16["num_valid"], out["num_valid"])
    d = (out16["roi_boxes"][:, :, None] - out["roi_boxes"][:, None]).abs().amax(-1)
    assert float((d.amin(-1) < 0.02).float().mean()) > 0.9


def test_span_tree_and_counters(params):
    fn = T.make_predict_fn(model(params, "bfloat16"), hyper_params("bfloat16"), from_uint8=True,
                           device="cpu")
    calls = dict(vit.attention_core.calls)
    n0 = P.select_levels.candidates
    with profiling.recording() as spans:
        fn(frames())
    names = [s[0] for s in spans]
    kids = lambda j: [s[0] for s in spans if s[1] == j]  # noqa: E731
    assert names[0] == "rpn.predict" and spans[0][1] is None
    assert kids(0) == ["rpn.upload", "rpn.stem", "rpn.backbone", "rpn.pyramid", "rpn.head",
                       "rpn.decode", "rpn.select"]
    assert kids(names.index("rpn.backbone")) == ["rpn.attn.window", "rpn.attn.global"] * 2
    assert vit.attention_core.calls["window"] - calls["window"] == 2
    assert vit.attention_core.calls["global"] - calls["global"] == 2
    assert P.select_levels.candidates - n0 == 2 * (200 + 200 + 192 + 48 + 12)
    # at the published sizes: 8 window and 4 global cores, 4,768 candidates an image
    hp = T.get_hyper_params("vitdet_b")
    windows = [b.window for b in vit.ViT(hp.vit, hp.img_size).blocks]
    assert windows.count(14) == 8 and windows.count(0) == 4
    assert sum(min(hp.pre_nms_topn, n) for n in level_sizes(hp)) == 4768
    assert hp.total_anchors == 261888


def test_init_model_draws_detectron2s_initialization():
    hp = hyper_params()
    m = T.init_model(T.get_model(hp), torch.Generator().manual_seed(0), device="cpu")
    blk = m.backbone.blocks[0]
    assert not blk.attn.rel_pos_h.any() and not blk.attn.qkv.bias.any()
    assert torch.equal(blk.norm1.weight, torch.ones(32))
    with torch.no_grad():
        assert 0.015 < float(blk.mlp.fc1.weight.std()) < 0.025
        assert 0.005 < float(m.objectness.weight.std()) < 0.015 and not m.deltas.bias.any()
    out = T.make_predict_fn(m, hp, from_uint8=True, device="cpu")(frames())
    assert out["roi_boxes"].shape == (2, 100, 4) and (out["num_valid"] > 0).all()


def test_training_and_fast_serving_refuse_a_pyramid(params):
    hp = hyper_params()
    with pytest.raises(ValueError, match="feature pyramid"):
        T.make_train_step(hp)
    with pytest.raises(ValueError, match="fast=True"):
        T.make_predict_fn(model(params), hp, fast=True, device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        T.make_predict_fn(model(params), hp, from_uint8=True, device="cpu")(frames().float())


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_level_kernel_matches_plain_at_published_size(cuda):
    """The level-wise selection on 261,888 candidates an image, B = 16: its
    4,768 candidates through proposal_kernel_levels (one launch), bit for
    bit the plain version's; the whole select_levels on the card the CPU's
    (boxes and counts exact, the sigmoid to an ulp)."""
    hp = T.get_hyper_params("vitdet_b")
    g = torch.Generator().manual_seed(5)
    anc = T.generate_anchors(hp)
    d = torch.randn((16, anc.shape[0], 4), generator=g) * 0.4
    boxes = T.boxes.apply_deltas(anc[None], d, hp.box_weights, hp.scale_clamp)
    logits = torch.randn((16, anc.shape[0]), generator=g) * 2.2
    levels = torch.cat([torch.full((min(1000, n),), i, dtype=torch.int32)
                        for i, n in enumerate(level_sizes(hp))])
    idx, start = [], 0
    for n in level_sizes(hp):
        idx.append(proposal.top_candidates(logits[:, start:start + n], min(1000, n)) + start)
        start += n
    idx = torch.cat(idx, 1)
    cand = R.clip(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), (768, 1024), 1024)
    score = torch.gather(logits, 1, idx)
    score = torch.where((cand[..., 2] > cand[..., 0]) & (cand[..., 3] > cand[..., 1]), score,
                        float("-inf"))
    want = proposal.fused_proposals(cand, score, 4768, 0.7, 1000, levels=levels)
    n0 = proposal.fused_proposals.launches
    got = proposal.fused_proposals(cand.to(cuda), score.to(cuda), 4768, 0.7, 1000,
                                   levels=levels.to(cuda))
    torch.cuda.synchronize()
    assert proposal.fused_proposals.launches - n0 == 1
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    assert int(want["num_valid"].min()) > 500
    flat = proposal.fused_proposals(cand.to(cuda), score.to(cuda), 4768, 0.7, 1000)
    assert not torch.equal(flat["roi_boxes"].cpu(), want["roi_boxes"])  # levels matter here
    out = P.select_levels(boxes.to(cuda), logits.to(cuda), hp, (768, 1024), levels.to(cuda), 1000)
    ref = P.select_levels(boxes, logits, hp, (768, 1024), levels, 1000)
    assert torch.equal(out["roi_boxes"].cpu(), ref["roi_boxes"])
    assert torch.equal(out["num_valid"].cpu(), ref["num_valid"])
    torch.testing.assert_close(out["roi_scores"].cpu(), ref["roi_scores"], rtol=2 ** -22, atol=0)


@pytest.mark.cuda
def test_single_level_kernel_unchanged(cuda):
    """The single-level entry at MobileNetV2's serving shapes (9,216 anchors,
    top 6,000, 300 kept) against its plain version, bit for bit."""
    g = torch.Generator().manual_seed(6)
    ctr = torch.rand((32, 9216, 2), generator=g)
    hw = torch.rand((32, 9216, 2), generator=g) * 0.3 + 0.02
    boxes = torch.cat([ctr - hw / 2, ctr + hw / 2], -1)
    scores = torch.rand((32, 9216), generator=g)
    want = proposal.fused_proposals(boxes, scores, 6000, 0.7, 300)
    got = proposal.fused_proposals(boxes.to(cuda), scores.to(cuda), 6000, 0.7, 300)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_vitdet_serves_on_the_card(cuda):
    """The tiny model through make_predict_fn on the card: one proposal
    kernel launch a batch, proposals the CPU's at bf16 tolerance."""
    p = R.draw_params(CFG, 11)
    hp = hyper_params("bfloat16")
    m = T.get_model(hp)
    m.load_state_dict(p)
    fn = T.make_predict_fn(T.model.to_device(m, cuda), hp, from_uint8=True, device=cuda)
    n0 = proposal.fused_proposals.launches
    out = fn(frames())
    torch.cuda.synchronize()
    assert proposal.fused_proposals.launches - n0 == 1
    boxes, logits, hw = R.candidates({k: v.to(cuda) for k, v in p.items()}, frames().to(cuda), CFG)
    ref = R.select(boxes, logits, hw, CFG)
    assert np.abs(out["num_valid"].cpu().numpy() - ref["num_valid"]).max() <= 2
