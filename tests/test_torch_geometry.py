"""Geometry of the PyTorch port held against ``tpurpn``: anchors, delta
encode/decode, IoU and NMS, on identical numpy inputs.

Anchors and NMS selection must be bit-exact (the port keeps the arithmetic
op for op). Delta encode/decode and IoU are held to 1e-6: ``exp``/``log``
round differently by an ulp or so between XLA's and torch's CPU kernels.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import tpurpn
from tpurpn import boxes as jboxes
import tpurpn_torch
from tpurpn_torch import boxes as tboxes


def _random_boxes(rng, shape, lo=0.0, hi=0.6, min_size=0.02, max_size=0.4):
    b = np.zeros(shape + (4,), np.float32)
    b[..., :2] = rng.uniform(lo, hi, shape + (2,))
    b[..., 2:] = b[..., :2] + rng.uniform(min_size, max_size, shape + (2,))
    return b


@pytest.mark.parametrize("backbone,count", [("vgg16", 8649), ("mobilenet_v2", 9216)])
def test_anchors_bit_exact(backbone, count):
    ref = np.asarray(tpurpn.generate_anchors(tpurpn.get_hyper_params(backbone)))
    hp = tpurpn_torch.get_hyper_params(backbone)
    got = tpurpn_torch.generate_anchors(hp, device="cpu").numpy()
    assert got.shape == (count, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tpurpn_torch.generate_base_anchors(hp, device="cpu").numpy(),
        np.asarray(tpurpn.generate_base_anchors(tpurpn.get_hyper_params(backbone))),
    )


def test_hyper_params_match():
    for backbone in ("vgg16", "mobilenet_v2"):
        for img in (128, 136, 500):
            a = tpurpn.get_hyper_params(backbone, img_size=img)
            b = tpurpn_torch.get_hyper_params(backbone, img_size=img)
            assert a.__dict__ == b.__dict__


def test_delta_encode_decode_parity(rng):
    anchors = _random_boxes(rng, (3, 500))
    gt = _random_boxes(rng, (3, 500))
    gt[:, :20] = 0.0  # zero-size padding rows encode to zero deltas
    anchors[:, :5, 2] = anchors[:, :5, 0]  # zero-height anchors: clamped
    ref = np.asarray(jboxes.get_deltas_from_bboxes(jnp.asarray(anchors), jnp.asarray(gt)))
    got = tboxes.get_deltas_from_bboxes(torch.from_numpy(anchors), torch.from_numpy(gt))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)

    deltas = (rng.standard_normal((3, 500, 4)) * 0.3).astype(np.float32)
    ref = np.asarray(jboxes.get_bboxes_from_deltas(jnp.asarray(anchors), jnp.asarray(deltas)))
    got = tboxes.get_bboxes_from_deltas(torch.from_numpy(anchors), torch.from_numpy(deltas))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_iou_map_and_box_utils_parity(rng):
    a = _random_boxes(rng, (2, 300))
    b = _random_boxes(rng, (2, 40))
    ref = np.asarray(jboxes.generate_iou_map(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.generate_iou_map(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2, 300, 40)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)

    px = a * 400.0
    np.testing.assert_allclose(
        tboxes.normalize_bboxes(torch.from_numpy(px), 375, 500).numpy(),
        np.asarray(jboxes.normalize_bboxes(jnp.asarray(px), 375, 500)), atol=1e-6,
    )
    np.testing.assert_allclose(
        tboxes.denormalize_bboxes(torch.from_numpy(a), 375, 500).numpy(),
        np.asarray(jboxes.denormalize_bboxes(jnp.asarray(a), 375, 500)), atol=1e-6,
    )
    wide = (a - 0.3) * 3.0
    np.testing.assert_array_equal(
        tboxes.clip_bboxes(torch.from_numpy(wide)).numpy(),
        np.asarray(jboxes.clip_bboxes(jnp.asarray(wide))),
    )


def _nms_cases(rng):
    # random; heavy duplication; many equal scores; some invalid rows
    b1 = _random_boxes(rng, (2, 512))
    v1 = np.ones((2, 512), bool)
    b2 = np.tile(np.array([0.2, 0.2, 0.5, 0.5], np.float32), (2, 256, 1))
    b2 += rng.uniform(0, 0.03, b2.shape).astype(np.float32)
    v2 = np.ones((2, 256), bool)
    b3 = _random_boxes(rng, (3, 384), hi=0.3, max_size=0.6)
    v3 = rng.uniform(size=(3, 384)) > 0.2
    return [(b1, v1, 40), (b2, v2, 300), (b3, v3, 100)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_nms_keep_twin_exact(case):
    boxes, valid, max_out = _nms_cases(np.random.default_rng(case))[case]
    ref = np.asarray(jboxes._nms_keep_sorted_batched(
        jnp.asarray(boxes), jnp.asarray(valid), 0.7, 128, max_out))
    got = tboxes._nms_keep_sorted_batched(
        torch.from_numpy(boxes), torch.from_numpy(valid), 0.7, 128, max_out)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize(
    "n,max_out,score_threshold",
    [(700, 50, float("-inf")), (300, 400, float("-inf")), (1000, 200, 0.3)],
)
def test_batched_non_max_suppression_exact(rng, n, max_out, score_threshold):
    boxes = _random_boxes(rng, (2, n))
    scores = (rng.integers(0, 50, (2, n)) / 50.0).astype(np.float32)  # ties
    ref_idx, ref_nv = jboxes.batched_non_max_suppression(
        jnp.asarray(boxes), jnp.asarray(scores), max_out,
        iou_threshold=0.7, score_threshold=score_threshold,
    )
    idx, nv = tboxes.batched_non_max_suppression(
        torch.from_numpy(boxes), torch.from_numpy(scores), max_out,
        iou_threshold=0.7, score_threshold=score_threshold,
    )
    assert idx.dtype == torch.int32 and nv.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(ref_nv))


def test_non_max_suppression_single_image_exact(rng):
    boxes = _random_boxes(rng, (900,))
    scores = rng.uniform(size=(900,)).astype(np.float32)
    ref_idx, ref_nv = jboxes.non_max_suppression(
        jnp.asarray(boxes), jnp.asarray(scores), 120, iou_threshold=0.5)
    idx, nv = tboxes.non_max_suppression(
        torch.from_numpy(boxes), torch.from_numpy(scores), 120, iou_threshold=0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert int(nv) == int(ref_nv)
