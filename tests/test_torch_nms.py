"""The NMS keep mask of the port held against ``tpurpn``'s Pallas kernel.

``tpurpn.kernels.nms_pallas.nms_pallas_keep(interpret=True)`` and the port's
``kernels.nms.nms_keep`` (its plain version on CPU tensors; ``chip_smoke.py``
holds the CUDA kernel against it on the card) get the same score-sorted f32
boxes and must agree bit for bit, the kept count included, which overshoots
``max_output`` inside the last block decided. ``batched_non_max_suppression``
selects as ``tpurpn``'s on every ``use_kernel`` setting. A PyTorch model of
the CUDA kernel's rounds (``csrc/nms.cu``) is held against both.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import tpurpn.boxes as j_boxes
from tpurpn.kernels.nms_pallas import nms_pallas_keep
from tpurpn_torch import boxes
from tpurpn_torch.boxes import generate_iou_map
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


def disjoint_boxes(B, N):
    """Boxes on a grid, none overlapping another: every valid box is kept."""
    i = np.arange(N)
    yx = np.stack([i // 128, i % 128], -1).astype(np.float32) / 128
    return np.tile(np.concatenate([yx, yx + 0.5 / 128], -1)[None], (B, 1, 1))


def _nms_rounds(bs, valid, thr, max_output, block, chunk=32):
    """csrc/nms.cu's rounds, one image at a time: blocks of `block` boxes,
    each decided in rounds of `chunk` candidates, each candidate tested
    against the boxes kept before its round, the round resolved by the
    fixpoint of chunk_walk with room `chunk` (the stop rule acts only at
    block ends); an image stops after the block in which its count reaches
    max_output."""
    B, n, _ = bs.shape
    thr = torch.tensor(thr, dtype=torch.float32)
    keep = torch.zeros((B, n), dtype=torch.bool)
    counts = []
    for img in range(B):
        kept = []
        for start in range(0, n, block):
            if len(kept) >= max_output:
                break
            for c0 in range(start, min(start + block, n), chunk):
                idx = torch.arange(c0, min(c0 + chunk, start + block, n))
                cb = bs[img, idx]
                alive = valid[img, idx].clone()
                if kept:
                    alive &= ~(generate_iou_map(cb, bs[img, torch.tensor(kept)]) > thr).any(1)
                rows = (generate_iou_map(cb, cb) > thr) & torch.ones(
                    len(idx), len(idx), dtype=torch.bool).tril(-1)  # row i, bit j < i
                k = alive.clone()
                while True:  # the unique fixpoint: bit i depends on bits below i
                    nxt = alive & ~(rows & k[None]).any(1)
                    if torch.equal(nxt, k):
                        break
                    k = nxt
                keep[img, idx] = k
                kept += idx[k].tolist()  # room `chunk`: every keep of the round stays
        counts.append(len(kept))
    return keep, torch.tensor(counts, dtype=torch.int32)


def _rounds_case(name, rng):
    """(boxes, valid, thr, max_output, block) of one case."""
    if name in ("random", "block_32", "block_256", "block_384", "n_not_a_multiple_of_block",
                "n_below_32"):
        B, N, maxout, thr, block = {
            "random": (2, 256, 50, 0.7, 128), "block_32": (2, 300, 40, 0.7, 32),
            "block_256": (2, 600, 60, 0.6, 256), "block_384": (2, 768, 80, 0.7, 384),
            "n_not_a_multiple_of_block": (2, 300, 200, 0.6, 128),
            "n_below_32": (3, 20, 300, 0.5, 128)}[name]
        bs, _ = sorted_boxes(rng, B, N)
        return bs, np.ones((B, N), bool), thr, maxout, block
    if name == "overshoot_of_the_last_block":
        bs, _ = sorted_boxes(rng, 2, 512)
        return bs, np.ones((2, 512), bool), 0.7, 10, 128
    if name == "heavy_overlap":
        base = np.array([0.2, 0.2, 0.6, 0.6], np.float32)
        bs = np.tile(base, (2, 512, 1)) + rng.normal(0, 0.001, (2, 512, 4)).astype(np.float32)
        return bs, np.ones((2, 512), bool), 0.7, 10, 128
    if name == "all_invalid_rows":
        bs, _ = sorted_boxes(rng, 3, 256)
        valid = np.broadcast_to(np.arange(256) < 100, (3, 256)).copy()
        valid[2] = False
        return bs, valid, 0.7, 300, 128
    if name == "ties_and_duplicates":
        bs = np.tile(np.array([0.1, 0.1, 0.4, 0.4], np.float32), (2, 300, 1))
        bs[0, 150] = [0.5, 0.5, 0.9, 0.9]
        bs[1, ::3] = [0.5, 0.5, 0.9, 0.9]
        return bs, np.ones((2, 300), bool), 0.7, 300, 128
    if name == "stop_at_a_block_end":  # the count reaches 256 at the end of block 2
        return disjoint_boxes(2, 512), np.ones((2, 512), bool), 0.7, 256, 128
    assert name == "max_output_inside_a_chunk"  # keep 300 in block 3, chunk 2
    return disjoint_boxes(2, 512), np.ones((2, 512), bool), 0.7, 300, 128


@pytest.mark.parametrize("name", [
    "random", "overshoot_of_the_last_block", "heavy_overlap", "all_invalid_rows",
    "n_not_a_multiple_of_block", "n_below_32", "block_32", "block_256", "block_384",
    "ties_and_duplicates", "stop_at_a_block_end", "max_output_inside_a_chunk"])
def test_nms_rounds_match_plain_and_tpurpn(rng, name):
    bs, valid, thr, maxout, block = _rounds_case(name, rng)
    keep, cnt = _nms_rounds(torch.from_numpy(bs), torch.from_numpy(valid), thr, maxout, block)
    plain_keep, plain_cnt = nms.nms_keep_plain(torch.from_numpy(bs), torch.from_numpy(valid),
                                               thr, maxout, block)
    assert torch.equal(keep, plain_keep) and torch.equal(cnt, plain_cnt)
    if block % 128 == 0:  # the Pallas kernel's blocks are whole lane rows
        ref_keep, ref_cnt = nms_pallas_keep(jnp.asarray(bs), jnp.asarray(valid), thr, maxout,
                                            block=block, interpret=True)
    else:  # its jnp twin takes any block
        n_pad = -(-bs.shape[1] // block) * block
        pad = ((0, 0), (0, n_pad - bs.shape[1]))
        ref_keep = j_boxes._nms_keep_sorted_batched(
            jnp.asarray(np.pad(bs, pad + ((0, 0),))), jnp.asarray(np.pad(valid, pad)), thr,
            block, maxout)[:, :bs.shape[1]]
        ref_cnt = ref_keep.sum(-1)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    if name == "overshoot_of_the_last_block":
        assert (cnt > 10).all()
    if name == "stop_at_a_block_end":
        assert cnt.tolist() == [256, 256] and not keep[:, 256:].any()
    if name == "max_output_inside_a_chunk":  # the rest of block 3 is decided
        assert cnt.tolist() == [384, 384] and not keep[:, 384:].any()
