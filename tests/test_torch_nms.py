"""The NMS keep mask of the port held against ``tpurpn``'s Pallas kernel.

``tpurpn.kernels.nms_pallas.nms_pallas_keep(interpret=True)`` and the port's
``kernels.nms.nms_keep`` (its plain version on CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card) get the same score-sorted f32
boxes and must agree bit for bit, the kept count included, which overshoots
``max_output`` inside the last block decided. ``batched_non_max_suppression``
selects as ``tpurpn``'s on every ``use_kernel`` setting.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import tpurpn.boxes as j_boxes
from tpurpn.kernels.nms_pallas import nms_pallas_keep
from tpurpn_torch import boxes
from tpurpn_torch.kernels import nms


def sorted_boxes(rng, B, N):
    b = np.zeros((B, N, 4), np.float32)
    b[..., :2] = rng.uniform(0, 0.7, (B, N, 2))
    b[..., 2:] = b[..., :2] + rng.uniform(0.05, 0.3, (B, N, 2))
    s = rng.uniform(0, 1, (B, N)).astype(np.float32)
    order = np.argsort(-s, axis=-1, kind="stable")
    return np.take_along_axis(b, order[..., None], 1), np.take_along_axis(s, order, 1)


def assert_keep_matches_pallas(bs, valid, thr, maxout, block=128):
    ref_keep, ref_cnt = nms_pallas_keep(jnp.asarray(bs), jnp.asarray(valid), thr, maxout,
                                        block=block, interpret=True)
    launches = nms.nms_keep.launches
    keep, cnt = nms.nms_keep(torch.from_numpy(bs), torch.from_numpy(valid), thr, maxout,
                             block=block)  # CPU -> plain version
    assert nms.nms_keep.launches == launches
    assert keep.dtype == torch.bool and cnt.dtype == torch.int32
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    return keep, cnt


@pytest.mark.parametrize("B,N,maxout,thr", [(2, 256, 50, 0.7), (4, 640, 100, 0.5)])
def test_keep_matches_pallas_kernel(rng, B, N, maxout, thr):
    bs, _ = sorted_boxes(rng, B, N)
    assert_keep_matches_pallas(bs, np.ones((B, N), bool), thr, maxout)


def test_keep_overshoots_max_output_within_the_last_block(rng):
    bs, _ = sorted_boxes(rng, 2, 512)
    _, cnt = assert_keep_matches_pallas(bs, np.ones((2, 512), bool), 0.7, 10)
    assert (cnt > 10).all()  # the first 128-box block is decided whole


def test_keep_heavy_overlap_stops_early(rng):
    base = np.array([0.2, 0.2, 0.6, 0.6], np.float32)
    b = np.tile(base, (1, 512, 1)) + rng.normal(0, 0.001, (1, 512, 4)).astype(np.float32)
    assert_keep_matches_pallas(b, np.ones((1, 512), bool), 0.7, 10)


def test_keep_respects_validity_and_all_invalid_rows(rng):
    bs, _ = sorted_boxes(rng, 3, 256)
    valid = np.broadcast_to(np.arange(256) < 100, (3, 256)).copy()
    valid[2] = False
    keep, cnt = assert_keep_matches_pallas(bs, valid, 0.7, 300)
    assert not keep[:, 100:].any() and not keep[2].any() and int(cnt[2]) == 0


def test_keep_n_not_a_multiple_of_block(rng):
    bs, _ = sorted_boxes(rng, 2, 300)
    assert_keep_matches_pallas(bs, np.ones((2, 300), bool), 0.6, 200)


def test_keep_block_384(rng):
    bs, _ = sorted_boxes(rng, 2, 768)
    assert_keep_matches_pallas(bs, np.ones((2, 768), bool), 0.7, 80, block=384)


def test_keep_ties_and_duplicates():
    box = np.array([0.1, 0.1, 0.4, 0.4], np.float32)
    bs = np.tile(box, (2, 300, 1))
    bs[0, 150] = [0.5, 0.5, 0.9, 0.9]
    bs[1, ::3] = [0.5, 0.5, 0.9, 0.9]
    keep, _ = assert_keep_matches_pallas(bs, np.ones((2, 300), bool), 0.7, 300)
    assert keep.sum(-1).tolist() == [2, 2]


@pytest.mark.parametrize("presorted", [False, True])
def test_batched_nms_matches_tpurpn_on_every_route(rng, presorted):
    bs, ss = sorted_boxes(rng, 3, 700)
    if not presorted:
        perm = rng.permutation(700)
        bs, ss = bs[:, perm], ss[:, perm]
    ref_idx, ref_nv = j_boxes.batched_non_max_suppression(
        jnp.asarray(bs), jnp.asarray(ss), 120, 0.6, presorted=presorted)
    for use_kernel in (None, True, False):
        idx, nv = boxes.batched_non_max_suppression(
            torch.from_numpy(bs), torch.from_numpy(ss), 120, 0.6, presorted=presorted,
            use_kernel=use_kernel)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(nv.numpy(), np.asarray(ref_nv))
