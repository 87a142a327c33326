"""RPN target assignment of the port held against ``tpurpn``.

Seeded numpy GT boxes and ``tpurpn.target.target_rand_bits``' words go
through ``tpurpn`` (its jnp path, and its Pallas kernels in interpret mode)
and through the port's plain path, which the target kernel's wrappers run on
CPU tensors (``chip_smoke.py`` holds the CUDA kernel against it on the
card). Against the jnp path, labels and matching agree bit for bit; deltas
at rel 1e-6 (rows 2-3 go through log, whose rounding may differ by an ulp).

A numpy model of the CUDA kernel's radix select (``csrc/targets.cu``) finds
the same threshold as the binary search of ``tpurpn``'s kernel and selects
what both packages' ``select_by_keys`` select.

``tpurpn``'s interpreted Pallas kernel computes some IoUs one ulp away from
its own jnp twin (XLA rounds the fused kernel differently), which can flip
a best-anchor tie; tests/test_target_pallas.py picks data without such a
flip, and so do the comparisons with the kernel here (seed 1, guarded), with
the merged IoU at atol 1e-6 as there.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpurpn
import tpurpn.target as j_target
from tpurpn.kernels import target_pallas
import tpurpn_torch
from tpurpn_torch import target
from tpurpn_torch.boxes import generate_iou_map
from tpurpn_torch.kernels import targets as k_targets

DELTA_RTOL = 1e-6


def hp_pair(img=160):
    return (tpurpn.get_hyper_params("vgg16", img_size=img),
            tpurpn_torch.get_hyper_params("vgg16", img_size=img))


def random_gt(rng, B, M, n_valid):
    boxes = np.zeros((B, M, 4), np.float32)
    for b in range(B):
        for i in range(n_valid):
            y, x = rng.uniform(0, 0.6, 2)
            h, w = rng.uniform(0.1, 0.35, 2)
            boxes[b, i] = (y, x, min(y + h, 1), min(x + w, 1))
    labels = np.full((B, M), -1, np.int32)
    labels[:, :n_valid] = 1
    return boxes, labels


def words(key, B, N):
    return np.array(j_target.target_rand_bits(jax.random.key(key), B, N))


def port_targets(hp, gt, labels, bits):
    anchors = tpurpn_torch.generate_anchors(hp)
    return k_targets.fused_rpn_targets(  # CPU -> plain version
        anchors, torch.from_numpy(gt), torch.from_numpy(labels), torch.from_numpy(bits), hp)


def assert_targets_equal(got, ref_deltas, ref_labels):
    deltas, labels = got
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels).reshape(labels.shape))
    np.testing.assert_allclose(deltas.numpy(), np.asarray(ref_deltas).reshape(deltas.shape),
                               rtol=DELTA_RTOL, atol=0)


@pytest.mark.parametrize("B,M,n_valid", [(2, 8, 3), (3, 64, 20)])
def test_targets_match_tpurpn_jnp_path(rng, B, M, n_valid):
    jhp, thp = hp_pair()
    gt, labels = random_gt(rng, B, M, n_valid)
    key = jax.random.key(7)
    ref_d, ref_l = j_target.calculate_rpn_actual_outputs(
        tpurpn.generate_anchors(jhp), jnp.asarray(gt), jnp.asarray(labels), jhp, key,
        use_pallas=False)
    bits = np.array(j_target.target_rand_bits(key, B, jhp.total_anchors))
    launches = k_targets.fused_rpn_targets.launches
    got_d, got_l = target.calculate_rpn_actual_outputs(
        tpurpn_torch.generate_anchors(thp), torch.from_numpy(gt), torch.from_numpy(labels),
        thp, rand_bits=torch.from_numpy(bits))
    assert k_targets.fused_rpn_targets.launches == launches
    assert got_d.shape == ref_d.shape and got_l.shape == ref_l.shape
    assert_targets_equal((got_d, got_l), ref_d, ref_l)
    lab = got_l.numpy().reshape(B, -1)
    assert ((lab == 1).sum(-1) <= thp.total_pos_bboxes).all()
    assert ((lab != -1).sum(-1) == thp.total_pos_bboxes + thp.total_neg_bboxes).all()


def kernel_agreeing_gt(jhp, B, M, n_valid):
    """GT boxes on which tpurpn's interpreted kernel matches as its twin does."""
    gt, labels = random_gt(np.random.default_rng(1), B, M, n_valid)
    anchors = tpurpn.generate_anchors(jhp)
    twin = j_target.iou_matching(anchors, jnp.asarray(gt))
    kern = target_pallas.fused_iou_matching(anchors, jnp.asarray(gt), interpret=True)
    for t, k in zip(twin[1:], kern[1:]):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(k))
    np.testing.assert_allclose(np.asarray(twin[0]), np.asarray(kern[0]), atol=1e-6)
    return gt, labels, kern


@pytest.mark.parametrize("B,M,n_valid", [(2, 8, 3), (3, 64, 20)])
def test_targets_match_pallas_kernel_interpreted(B, M, n_valid):
    jhp, thp = hp_pair()
    gt, labels, _ = kernel_agreeing_gt(jhp, B, M, n_valid)
    bits = words(3, B, jhp.total_anchors)
    ref_d, ref_l = target_pallas.fused_rpn_targets(
        tpurpn.generate_anchors(jhp), jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(bits),
        jhp, interpret=True)
    assert_targets_equal(port_targets(thp, gt, labels, bits), ref_d, ref_l)


def test_targets_empty_gt():
    jhp, thp = hp_pair()
    gt = np.zeros((2, 8, 4), np.float32)
    labels = np.full((2, 8), -1, np.int32)
    bits = words(1, 2, jhp.total_anchors)
    ref_d, ref_l = target_pallas.fused_rpn_targets(
        tpurpn.generate_anchors(jhp), jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(bits),
        jhp, interpret=True)
    deltas, lab = port_targets(thp, gt, labels, bits)
    assert_targets_equal((deltas, lab), ref_d, ref_l)
    assert not (lab == 1).any() and not deltas.any()
    assert ((lab == 0).sum(-1) == thp.total_pos_bboxes + thp.total_neg_bboxes).all()


def test_negative_words_shift_logically(rng):
    """torch's >> on int32 is arithmetic; the keys of words with the top bit
    set must still be tpurpn's (lax.shift_right_logical)."""
    jhp, thp = hp_pair()
    N = jhp.total_anchors
    gt, labels, _ = kernel_agreeing_gt(jhp, 2, 8, 3)
    raw = rng.integers(0, 2**31, size=(2, 2, N), dtype=np.int64)
    bits = (raw | (1 << 31)).astype(np.uint32).view(np.int32)  # all negative
    assert (bits < 0).all()
    keys = target.selection_keys(torch.from_numpy(bits[:, 0]), N)
    np.testing.assert_array_equal(
        keys.numpy(), np.asarray(j_target.selection_keys(jnp.asarray(bits[:, 0]), N)))
    assert (keys >= 0).all() and (keys < 2**28).all()
    ref_d, ref_l = target_pallas.fused_rpn_targets(
        tpurpn.generate_anchors(jhp), jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(bits),
        jhp, interpret=True)
    assert_targets_equal(port_targets(thp, gt, labels, bits), ref_d, ref_l)


@pytest.mark.parametrize("k_max", [None, 40])
def test_select_by_keys_matches_tpurpn(rng, k_max):
    B, N = 3, 900
    cand = rng.uniform(size=(B, N)) < 0.3
    w = words(5, B, N)[:, 0]
    k_eff = np.array([0.0, 17.0, 40.0], np.float32)
    ref = j_target.select_by_keys(jnp.asarray(cand), jnp.asarray(w), jnp.asarray(k_eff),
                                  k_max=k_max)
    got = target.select_by_keys(torch.from_numpy(cand), torch.from_numpy(w),
                                torch.from_numpy(k_eff), k_max=k_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.sum(-1).tolist() == [0, 17, 40]


def test_select_by_keys_with_a_budget_of_zero(rng):
    """k_max = 0 (no positive budget) selects nothing, as tpurpn does."""
    cand = rng.uniform(size=(2, 300)) < 0.5
    w = words(6, 2, 300)[:, 0]
    k_eff = np.zeros(2, np.float32)
    ref = j_target.select_by_keys(jnp.asarray(cand), jnp.asarray(w), jnp.asarray(k_eff), k_max=0)
    got = target.select_by_keys(torch.from_numpy(cand), torch.from_numpy(w),
                                torch.from_numpy(k_eff), k_max=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.any()


@pytest.mark.parametrize("B,M,n_valid", [(2, 8, 3), (3, 64, 20)])
def test_iou_matching_matches_tpurpn(B, M, n_valid):
    jhp, thp = hp_pair()
    gt, _, kern = kernel_agreeing_gt(jhp, B, M, n_valid)
    twin = j_target.iou_matching(tpurpn.generate_anchors(jhp), jnp.asarray(gt))
    got = k_targets.fused_iou_matching(tpurpn_torch.generate_anchors(thp),
                                       torch.from_numpy(gt))  # CPU -> plain version
    assert got[1].dtype == got[2].dtype == torch.int32
    for g, r in zip(got, twin):  # the jnp twin: bit for bit
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(kern[0]), atol=1e-6)
    for g, k in zip(got[1:], kern[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(k))


def test_iou_matching_ties_pick_the_first(rng):
    jhp, thp = hp_pair()
    box = [0.25, 0.25, 0.55, 0.6]
    gt = np.array([[box, box, box], [[0.0] * 4] * 3], np.float32)
    ref = j_target.iou_matching(tpurpn.generate_anchors(jhp), jnp.asarray(gt))
    got = target.iou_matching(tpurpn_torch.generate_anchors(thp), torch.from_numpy(gt))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[1] == 0).all() and (got[2][1] == 0).all()


def test_rand_bits_and_generator_draws_are_seeded(rng):
    _, thp = hp_pair()
    gt, labels = random_gt(rng, 2, 8, 3)
    anchors = tpurpn_torch.generate_anchors(thp)
    args = (anchors, torch.from_numpy(gt), torch.from_numpy(labels), thp)
    a = target.calculate_rpn_actual_outputs(*args, torch.Generator().manual_seed(1))
    b = target.calculate_rpn_actual_outputs(*args, torch.Generator().manual_seed(1))
    c = target.calculate_rpn_actual_outputs(*args, torch.Generator().manual_seed(2))
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    bits = target.target_rand_bits(torch.Generator().manual_seed(1), 2, thp.total_anchors)
    assert bits.shape == (2, 2, thp.total_anchors) and bits.dtype == torch.int32
    assert (bits < 0).any() and (bits > 0).any()
    d = target.calculate_rpn_actual_outputs(*args, rand_bits=bits, use_kernel=False)
    assert torch.equal(a[1], d[1])
    with pytest.raises(ValueError, match="rand_bits"):
        target.calculate_rpn_actual_outputs(*args)


@pytest.mark.parametrize("k_max", [None, 12])
def test_random_select_mask_keeps_a_subset(rng, k_max):
    mask = torch.from_numpy(rng.uniform(size=(3, 200)) < 0.4)
    limit = torch.tensor([0, 5, 12])
    sel = target.random_select_mask(mask, limit, torch.Generator().manual_seed(0), k_max=k_max)
    assert not (sel & ~mask).any()
    assert sel.sum(-1).tolist() == torch.minimum(limit, mask.sum(-1)).tolist()


KEY_SENTINEL = 1 << 29


def _radix_select(keys, budget):
    """csrc/targets.cu's radix_select on one key row: 4 passes of 7 bits,
    each a 128-bin histogram of the digit among the keys under the prefix
    found so far (the sentinel's top digit is never 0, so pass 0 counts the
    real keys only), then the digit where the running count reaches the rank
    sought. Returns (threshold, k) with k = min(budget, real keys)."""
    if budget <= 0:
        return -1, 0
    keys = keys.astype(np.int64)
    prefix, rank, k = 0, budget, None
    for p in range(4):
        shift = 28 - 7 * (p + 1)
        under = keys[(keys >> (shift + 7)) == prefix]
        bins = np.bincount((under >> shift) & 127, minlength=128)
        if p == 0:
            k = rank = min(rank, int(bins.sum()))
            if k == 0:
                return -1, 0
        incl = np.cumsum(bins)
        d = int(np.searchsorted(incl, rank))  # the first digit whose count reaches rank
        rank -= int(incl[d] - bins[d])
        prefix = (prefix << 7) | d
    return prefix, k


def _binary_search_threshold(keys, k):
    """tpurpn's _kth_smallest_threshold: the smallest T with count(keys <= T) >= k."""
    if k <= 0:
        return -1
    lo, hi = 0, 1 << 28
    for _ in range(29):
        mid = (lo + hi) >> 1
        if (keys <= mid).sum() >= k:
            hi = mid
        else:
            lo = mid + 1
    return hi


@pytest.mark.parametrize("name,N,density,budget", [
    ("k0", 8649, 0.5, 0), ("k1", 8649, 0.5, 1), ("k_available", 8649, 0.01, None),
    ("k_above_available", 8649, 0.005, 128), ("forced_positive", 8649, 0.0, 128),
    ("no_candidate", 8649, 0.0, 64), ("N22500_lane_bits_15", 22500, 0.3, 256)])
def test_radix_select_matches_select_by_keys(rng, name, N, density, budget):
    B = 2
    words_np = rng.integers(-(2**31), 2**31, size=(B, N), dtype=np.int64).astype(np.int32)
    cand = rng.uniform(size=(B, N)) < density
    if name == "forced_positive":  # one candidate below any threshold, forced in
        cand[:, rng.integers(N)] = True
    keys = target.selection_keys(torch.from_numpy(words_np), N).numpy()
    np.testing.assert_array_equal(
        keys, np.asarray(j_target.selection_keys(jnp.asarray(words_np), N)))
    keys = np.where(cand, keys, KEY_SENTINEL)
    avail = cand.sum(-1)
    k_eff = np.minimum(avail if budget is None else budget, avail).astype(np.float32)
    port = target.select_by_keys(torch.from_numpy(cand), torch.from_numpy(words_np),
                                 torch.from_numpy(k_eff), k_max=None).numpy()
    ref = np.asarray(j_target.select_by_keys(jnp.asarray(cand), jnp.asarray(words_np),
                                             jnp.asarray(k_eff)))
    for b in range(B):
        thr, k = _radix_select(keys[b], avail[b] if budget is None else budget)
        assert k == int(k_eff[b])
        assert thr == _binary_search_threshold(keys[b], k)
        assert thr == (np.sort(keys[b])[k - 1] if k else -1)  # select_by_keys' threshold
        np.testing.assert_array_equal(keys[b] <= thr, port[b])
        np.testing.assert_array_equal(keys[b] <= thr, ref[b])
        assert (keys[b] <= thr).sum() == k  # unique keys: exactly k selected
    if name == "k_above_available":
        assert (avail < budget).all()
    if name in ("no_candidate", "k0"):
        assert not port.any()


# csrc/targets.cu's matching phase: one cluster of C blocks an image, block r
# owning the anchors [r*S, min((r+1)*S, N)), S = ceil(N / C), thread t taking
# anchors t and t + 1,024 of each pass of 2,048.
THREADS, PER_THREAD = 1024, 2
INT_MAX = np.iinfo(np.int32).max


def _take_max(v, i, ov, oi):
    """The kernel's take_max, elementwise: the larger IoU (floats compare as
    floats, so -0 == +0), then the lower anchor index."""
    take = (ov > v) | ((ov == v) & (oi < i))
    return np.where(take, ov, v), np.where(take, oi, i)


def _pair_keys(v, i, canonical=True):
    """The kernel's pair_key: the IoU's bits above the complemented index, 0
    where the pair is the empty (-1, INT_MAX). Zero is keyed as +0 unless
    ``canonical`` is False (the fault the kernel avoids)."""
    w = np.where(v == 0, np.float32(0), v).astype(np.float32) if canonical else v
    key = (w.view(np.uint32).astype(np.uint64) << np.uint64(32)) | (
        ~i.astype(np.uint32)).astype(np.uint64)
    return np.where(v >= 0, key, np.uint64(0))


def _cluster_matching_model(iou, C, canonical=True):
    """csrc/targets.cu's iou_phase on one image's (N, M) f32 IoU map, in the
    kernel's order: per anchor the running max over the GTs in order (strict
    >, the first maximum); per GT, each thread's pair (over its two anchors
    by strict >) meets the warp's in the butterfly (offsets 16 ... 1), each
    warp's pair enters the block's 64-bit key by max, pass after pass, and
    the cluster takes the max of its C blocks' keys. An empty slice keeps
    key 0."""
    N, M = iou.shape
    merged = np.full(N, -1.0, np.float32)
    best_gt = np.zeros(N, np.int32)
    for m in range(M):
        better = iou[:, m] > merged
        merged = np.where(better, iou[:, m], merged)
        best_gt = np.where(better, m, best_gt)
    S = -(-N // C)
    block_keys = np.zeros((C, M), np.uint64)
    for r in range(C):
        lo, hi = min(r * S, N), min(r * S + S, N)
        for base in range(lo, hi, THREADS * PER_THREAD):
            v = np.full((THREADS, M), -1, np.float32)
            i = np.full((THREADS, M), INT_MAX)
            for k in range(PER_THREAD):  # a thread's anchors ascend: strict >
                n = base + np.arange(THREADS) + k * THREADS
                iou_k = np.where((n < hi)[:, None], iou[np.minimum(n, N - 1)], np.float32(-1))
                better = iou_k > v
                v, i = np.where(better, iou_k, v), np.where(better, n[:, None], i)
            v, i = v.reshape(32, 32, M), i.reshape(32, 32, M)
            for off in (16, 8, 4, 2, 1):
                partner = np.arange(32) ^ off
                v, i = _take_max(v, i, v[:, partner], i[:, partner])
            warp_keys = _pair_keys(v[:, 0], i[:, 0], canonical)  # (warps, M)
            block_keys[r] = np.maximum(block_keys[r], warp_keys.max(axis=0))
    best_anchor = (~block_keys.max(axis=0).astype(np.uint32)).astype(np.int32)
    return merged, best_gt, best_anchor


def _random_anchors(rng, n, y0=0.0):
    yx = rng.uniform(0, 0.8, (n, 2)) * [1 - y0, 1] + [y0, 0]
    return np.concatenate([yx, yx + rng.uniform(0.02, 0.2, (n, 2))], 1).astype(np.float32)


def _matching_case(name, rng):
    """(anchors (N, 4), gt (B, M, 4)) f32 of a named edge of the cluster
    matching."""
    _, thp = hp_pair()
    grid = tpurpn_torch.generate_anchors(thp).numpy()  # 900 anchors
    if name in ("N5", "N37", "N16390_two_passes"):
        return _random_anchors(rng, int(name[1:].split("_")[0])), random_gt(rng, 2, 8, 3)[0]
    if name == "ties_across_slices":
        anchors = grid.copy()
        for k in range(1, 16):  # copies of anchor 3 in later slices, C = 8 and 16
            anchors[k * 57 + 5] = anchors[3]
        gt = random_gt(rng, 2, 8, 3)[0]
        gt[:, 0] = anchors[3]  # IoU 1 at anchor 3 and at each copy
        return anchors, gt
    if name == "signed_zero_ious":
        # anchors ending at y2 = -0.0 touch a GT starting at y1 = +0.0: IoU
        # -0 in the plain version's map; the rest lie below y = 0.5, +0
        anchors = _random_anchors(rng, 900, y0=0.5)
        anchors[1::7] = (-0.5, 0.1, -0.0, 0.3)
        gt = np.zeros((2, 4, 4), np.float32)
        gt[:, 0] = (0.0, 0.1, 0.2, 0.3)
        gt[:, 1] = (5.0, 5.0, 6.0, 6.0)  # disjoint from every anchor
        return anchors, gt
    if name == "all_padding":
        return grid, np.zeros((2, 8, 4), np.float32)
    M, n_valid = {"M64": (64, 20), "M300_two_gt_chunks": (300, 40)}[name]
    return grid, random_gt(rng, 2, M, n_valid)[0]


MATCHING_CASES = ["ties_across_slices", "signed_zero_ious", "all_padding", "M64",
                  "M300_two_gt_chunks", "N5", "N37", "N16390_two_passes"]


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("name", MATCHING_CASES)
def test_cluster_matching_model_matches_tpurpn(rng, name, C):
    """The kernel's per-slice partials and their merge give tpurpn's
    iou_matching bit for bit, the best anchor of a tie the lowest index
    across slice boundaries, and an empty slice changes nothing."""
    anchors, gt = _matching_case(name, rng)
    iou = generate_iou_map(torch.from_numpy(anchors)[None], torch.from_numpy(gt)).numpy()
    got = [np.stack(x) for x in zip(*(_cluster_matching_model(iou[b], C) for b in range(len(gt))))]
    ref = j_target.iou_matching(jnp.asarray(anchors), jnp.asarray(gt))
    plain = k_targets.fused_iou_matching(torch.from_numpy(anchors), torch.from_numpy(gt))
    for g, r, p in zip(got, ref, plain):
        np.testing.assert_array_equal(g, np.asarray(r))
        np.testing.assert_array_equal(g, p.numpy())
    N, S = len(anchors), -(-len(anchors) // C)
    if name == "ties_across_slices":
        ones = np.flatnonzero(iou[0, :, 0] == 1)
        assert ones[0] == 3 and (ones // S).max() == C - 1  # a copy in the last slice
        assert (got[2][:, 0] == 3).all()
    if name == "signed_zero_ious":
        # -0 after +0 in the touching GT's column: keyed by raw bits, a
        # warp's -0 would beat anchor 0; keyed as +0, the lowest index wins
        assert np.signbit(iou[:, 1, 0]).all() and not np.signbit(iou[:, 0, 0]).any()
        assert (iou[:, :, :2] == 0).all() and (got[2] == 0).all()
        assert _cluster_matching_model(iou[0], C, canonical=False)[2][0] != 0
    if name == "all_padding":
        assert (got[2] == 0).all() and (got[1] == 0).all()
    if name.startswith("N"):
        assert N % C and (N < C) == (name == "N5")
        assert (S > THREADS * PER_THREAD) == (name == "N16390_two_passes" and C == 8)


# The first rpn_targets_plain call of a fresh process once read 74 delta
# values ~1e-4 (relative) away from later calls (config 3, without a
# torch.set_num_threads call first). This is the repro: config 3 (VGG16
# anchors N = 8,649, B = 8, M = 8, seeded GTs and words) in a new
# interpreter, the first call against the second and third, bit for bit.
_FIRST_CALL_REPRO = """
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from tpurpn_torch import generate_anchors, get_hyper_params
from tpurpn_torch.target import rpn_targets_plain
hp = get_hyper_params("vgg16")
anchors = generate_anchors(hp, "cpu")
rng = np.random.default_rng(0)
yx = rng.uniform(0, 0.6, (8, 8, 2))
hw = rng.uniform(0.1, 0.35, (8, 8, 2))
gt = torch.from_numpy(np.concatenate([yx, np.minimum(yx + hw, 1.0)], -1).astype(np.float32))
labels = torch.ones((8, 8), dtype=torch.int32)
bits = torch.from_numpy(
    rng.integers(-2**31, 2**31, (8, 2, hp.total_anchors), dtype=np.int64).astype(np.int32))
outs = [rpn_targets_plain(anchors, gt, labels, bits, hp) for _ in range(3)]
diff = [int((outs[0][0] != o[0]).sum() + (outs[0][1] != o[1]).sum()) for o in outs[1:]]
print(hp.total_anchors, torch.get_num_threads(), diff)
sys.exit(1 if any(diff) else 0)
"""


@pytest.mark.parametrize("threads", [None, "1", "2", "4"])
def test_first_plain_targets_call_matches_later_calls(threads):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("OMP_NUM_THREADS", None)
    if threads is not None:
        env["OMP_NUM_THREADS"] = threads
    r = subprocess.run([sys.executable, "-c", _FIRST_CALL_REPRO.format(repo=repo)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert r.stdout.split()[0] == "8649"
