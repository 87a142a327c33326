"""Serving path of the PyTorch port held against ``tpurpn``: preprocessing,
decode + proposal selection, and ``make_predict_fn`` end to end (CPU).

Tolerances:
* resize in f32: 1e-6 (both are separable bilinear / antialiased-triangle
  filters with half-pixel centers; sums differ in order only);
* bf16 upsample: bit-equal (the VOC 375x500 -> 500 frame shape);
* bf16 downsample: the port filters in f32 and rounds once (torch has no
  bf16 antialiased kernel on the CPU), ``jax.image.resize`` filters in bf16:
  within 2 bf16 ulps of [0, 1] values (2 * 2**-8);
* decode: 1e-6 (``exp`` differs by ulps between XLA and torch); the
  selection on top of it must agree in ``num_valid`` and to 1e-6 in boxes
  and scores;
* forward: the bf16 tolerance of tests/test_torch_model.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpurpn
from tpurpn.anchors import generate_anchors as j_generate_anchors
from tpurpn.data import preprocess_batch as j_preprocess_batch
from tpurpn.predict import decode_outputs as j_decode_outputs
from tpurpn.predict import generate_proposals as j_generate_proposals
import tpurpn_torch
from tpurpn_torch.data import preprocess_batch
from tpurpn_torch.inference import fast_mobilenet_forward
from tpurpn_torch.kernels.proposal import fused_proposals
from tpurpn_torch.predict import decode_outputs, generate_proposals, make_predict_fn

from test_torch_model import close, flax_forward, flax_mobilenet, images, port


def _raw(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize(
    "shape,size,dtype,atol",
    [
        ((2, 375, 500, 3), 500, "float32", 1e-6),   # the bench's upsample
        ((2, 375, 500, 3), 500, "bfloat16", 0.0),
        ((2, 300, 260, 3), 128, "float32", 1e-6),   # antialiased downsample
        ((2, 300, 260, 3), 128, "bfloat16", 2 * 2.0**-8),
        ((2, 100, 140, 3), 120, "float32", 1e-6),   # mixed: up in H, down in W
    ],
)
def test_preprocess_resize_matches_tpurpn(rng, shape, size, dtype, atol):
    raw = _raw(rng, shape)
    boxes = np.zeros((shape[0], 1, 4), np.float32)
    ref, _ = j_preprocess_batch(jnp.asarray(raw), jnp.asarray(boxes), size,
                                dtype=getattr(jnp, dtype))
    got, _ = preprocess_batch(torch.from_numpy(raw), torch.from_numpy(boxes), size,
                              dtype=getattr(torch, dtype))
    assert got.shape == (shape[0], size, size, 3) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=0)


def test_preprocess_flip_matches_tpurpn_given_the_same_mask(rng):
    raw = _raw(rng, (6, 60, 80, 3))
    boxes = np.zeros((6, 3, 4), np.float32)
    boxes[:, :2, :2] = rng.uniform(0, 0.5, (6, 2, 2))
    boxes[:, :2, 2:] = boxes[:, :2, :2] + 0.3  # row 2 stays zero padding
    key = jax.random.key(5)
    flip = np.array(jax.random.bernoulli(key, 0.5, (6,)))  # a writable copy
    assert flip.any() and not flip.all()
    ref_x, ref_b = j_preprocess_batch(jnp.asarray(raw), jnp.asarray(boxes), 64,
                                      augment=True, key=key)
    got_x, got_b = preprocess_batch(torch.from_numpy(raw), torch.from_numpy(boxes), 64,
                                    augment=True, flip=torch.from_numpy(flip))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))
    assert not got_b[:, 2].any()


def test_preprocess_flip_from_a_generator_is_seeded(rng):
    raw = torch.from_numpy(_raw(rng, (8, 20, 20, 3)))
    boxes = torch.zeros((8, 1, 4))
    a, _ = preprocess_batch(raw, boxes, 20, augment=True,
                            generator=torch.Generator().manual_seed(1))
    b, _ = preprocess_batch(raw, boxes, 20, augment=True,
                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        preprocess_batch(raw, boxes, 20, augment=True)


def test_proposals_from_the_same_head_outputs_match_tpurpn(rng):
    hp = tpurpn.get_hyper_params("mobilenet_v2")  # 9,216 anchors, top-6000 -> 300
    thp = tpurpn_torch.get_hyper_params("mobilenet_v2")
    fm, A = hp.feature_map_shape, hp.anchor_count
    reg = (rng.standard_normal((2, fm, fm, 4 * A)) * 0.5).astype(np.float32)
    cls = rng.standard_normal((2, fm, fm, A)).astype(np.float32)
    ref_boxes, ref_scores = j_decode_outputs(j_generate_anchors(hp), jnp.asarray(reg),
                                             jnp.asarray(cls), hp)
    ref = j_generate_proposals(ref_boxes, ref_scores, hp)
    anchors = tpurpn_torch.generate_anchors(thp, device="cpu")
    boxes, scores = decode_outputs(anchors, torch.from_numpy(reg), torch.from_numpy(cls), thp)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(ref_boxes), atol=1e-6, rtol=0)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=1e-6, rtol=0)
    got = fused_proposals(boxes, scores, pre=6000, iou_threshold=0.7, max_output=300)
    np.testing.assert_array_equal(got["num_valid"].numpy(), np.asarray(ref["num_valid"]))
    np.testing.assert_allclose(got["roi_boxes"].numpy(), np.asarray(ref["roi_boxes"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["roi_scores"].numpy(), np.asarray(ref["roi_scores"]),
                               atol=1e-6, rtol=0)


def _check_proposals(out, topn):
    nv = out["num_valid"]
    assert out["roi_boxes"].shape == (2, topn, 4) and out["roi_scores"].shape == (2, topn)
    assert torch.isfinite(out["roi_boxes"]).all() and ((nv >= 0) & (nv <= topn)).all()
    for b in range(2):  # zero past num_valid
        assert not out["roi_boxes"][b, int(nv[b]):].any()


def test_make_predict_fn_fast_matches_tpurpn_forward():
    img = 128
    hp, _, _, fmodel, fvars = flax_mobilenet(img)
    thp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=img)
    model = port(img, folded=True)
    x = images(img)
    ref_reg, ref_cls = flax_forward(fmodel, fvars, x)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    reg, cls = fast_mobilenet_forward(model, xt)
    close(reg.numpy(), ref_reg)
    close(cls.numpy(), ref_cls)

    out = make_predict_fn(model, thp, fast=True, device="cpu")(xt)
    _check_proposals(out, thp.test_nms_topn)
    anchors = tpurpn_torch.generate_anchors(thp, device="cpu")
    expect = generate_proposals(*decode_outputs(anchors, reg, cls, thp), thp)
    for k in expect:
        torch.testing.assert_close(out[k], expect[k], rtol=0, atol=0)


def test_make_predict_fn_from_uint8(rng):
    img = 128
    thp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=img)
    model = port(img, folded=True)
    raw = torch.from_numpy(_raw(rng, (2, 96, 120, 3)))
    out = make_predict_fn(model, thp, fast=True, from_uint8=True, device="cpu")(raw)
    # frames no larger than img_size take the s2d stem: its heads, selected
    from tpurpn_torch.inference import fast_uint8_forward
    from tpurpn_torch.kernels.proposal import fused_proposals
    from tpurpn_torch.predict import decode_outputs

    boxes, scores = decode_outputs(tpurpn_torch.generate_anchors(thp, "cpu"),
                                   *fast_uint8_forward(model, raw), thp)
    expect = fused_proposals(boxes, scores, min(thp.pre_nms_topn, thp.total_anchors),
                             thp.nms_iou_threshold, thp.test_nms_topn)
    for k in expect:
        torch.testing.assert_close(out[k], expect[k], rtol=0, atol=0)
    # larger frames take preprocess_batch and the fast forward
    big = torch.from_numpy(_raw(rng, (2, 150, 120, 3)))
    out = make_predict_fn(model, thp, fast=True, from_uint8=True, device="cpu")(big)
    x, _ = preprocess_batch(big, torch.zeros((2, 1, 4)), img, dtype=torch.bfloat16)
    expect = make_predict_fn(model, thp, fast=True, device="cpu")(x)
    for k in expect:
        torch.testing.assert_close(out[k], expect[k], rtol=0, atol=0)
    plain = make_predict_fn(model, thp, topn=50, from_uint8=True, device="cpu")(raw)
    _check_proposals(plain, 50)
    with pytest.raises(TypeError):
        make_predict_fn(model, thp, from_uint8=True, device="cpu")(x)
    with pytest.raises(ValueError):
        make_predict_fn(port(img, folded=False), thp, fast=True, device="cpu")
