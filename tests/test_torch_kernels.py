"""The plain versions of the port's serving kernels held against ``tpurpn``,
and the dispatch of every kernel wrapper.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there); here the CPU wrappers dispatch to the
plain versions.

* IR stage: ``tpurpn``'s own oracle for its kernel (tests/test_ir_stage.py)
  — the stage fed the folded flax prefix's block_6 output must equal the
  full folded flax backbone tap, at bf16 tolerance; over the rest of its
  domain (S above 32, block_2, blocks 4-5, tails at 24 and 32 channels,
  ``dw_input_bf16``, ``c_exp_split``) against ``tpurpn``'s kernel in
  interpret mode, at bf16 tolerance; and fast serving at an S = 33 tap
  end to end.
* Proposals: bit-exact (atol 0) against ``tpurpn.predict.generate_proposals``
  on identical f32 candidates, over the cases of
  tests/test_proposal_pallas.py, plus one case against the Pallas kernel in
  interpret mode.
* The IR-stage kernel's weight pack: per-chunk swizzled images that round
  trip to ``pack_stage_weights``' layout, and caches that follow in-place
  parameter updates.
* The proposal kernel's chunked selection (32 candidates a round, a
  fixpoint over in-chunk suppression rows, a stop inside a chunk), modelled
  in PyTorch, selects exactly what the plain version selects.
* Dispatch: a tensor off the CPU (``meta`` here) never reaches the plain
  version; it goes to the kernel's build, or the wrapper rejects it. This
  covers every wrapper: IR stage, proposals (and the selection entry alone),
  targets, IoU matching, NMS (the plain versions of the last three are held
  against ``tpurpn`` in tests/test_torch_targets.py and
  tests/test_torch_nms.py), and the prefix's two (their plain versions
  are held in tests/test_torch_prefix.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpurpn
from tpurpn.backbones.mobilenet_v2 import MobileNetV2Backbone
from tpurpn.inference import _FUSED_BLOCKS, _PREFIX_MODULES
from tpurpn.kernels.ir_stage_pallas import fused_ir_stage as j_fused_ir_stage
from tpurpn.kernels.ir_stage_pallas import pack_stage_weights as j_pack_stage_weights
from tpurpn.kernels.proposal_pallas import fused_proposals_planes
from tpurpn.predict import generate_proposals as j_generate_proposals
import tpurpn_torch
from tpurpn_torch.kernels import _build, ir_stage, nms, prefix, proposal, targets

from test_torch_model import IMG_SIZES, close, flax_mobilenet, images, port


def test_pack_stage_weights_matches_tpurpn():
    _, _, _, _, fvars = flax_mobilenet(128)
    ref_w, ref_blocks = j_pack_stage_weights(
        jax.tree_util.tree_map(jnp.asarray, fvars["params"]["backbone"]),
        _FUSED_BLOCKS, tail_expand="block_13_expand",
    )
    got_w, got_blocks = ir_stage.pack_stage_weights(
        port(128, folded=True).backbone, _FUSED_BLOCKS, tail_expand="block_13_expand"
    )
    assert got_blocks == ref_blocks
    assert len(got_w) == len(ref_w) == 6 * 6 + 2
    for g, r in zip(got_w, ref_w):
        r = np.asarray(r, np.float32)
        r = r.reshape(-1) if r.shape[0] == 1 else r  # (1, C) bias rows
        assert g.shape == r.shape
        np.testing.assert_array_equal(g.float().numpy(), r)


def _stage(img=128):
    return ir_stage.pack_stage_weights(
        port(img, folded=True).backbone, _FUSED_BLOCKS, tail_expand="block_13_expand"
    )


def _sw64_offset(rows, row, k):
    """Element offset of (row, k) in the kernel's operand layout, as
    csrc/ir_stage.cu's sw64 computes it in bytes: planes of 32 channels,
    the 16-byte piece q of row r at q ^ ((r >> 1) & 3)."""
    return (k // 32) * rows * 32 + row * 32 + ((((k % 32) // 8) ^ ((row >> 1) & 3)) * 8) + k % 8


def _unpack(flat, spec):
    """The inverse of ``ir_stage.kernel_pack`` for one block: (we (c_in,
    c_exp), wp (c_exp, c_out) or None), in ``pack_stage_weights``' layout,
    with the padding to ``kernel_widths`` checked to be zero and cut off."""
    c_in, c_exp, c_out, _ = spec
    k_in, n_exp = ir_stage.kernel_widths(spec)
    width = ir_stage.TAIL_NC if c_out is None else ir_stage.CH
    chunks = flat.reshape(n_exp // width, -1)

    def unswizzle(m, rows, k):
        return m[:, ir_stage._sw64_index(rows, k)].reshape(-1, rows, k)

    we = unswizzle(chunks[:, : width * k_in], width, k_in).reshape(n_exp, k_in).t()
    assert not we[c_in:].any() and not we[:, c_exp:].any()
    we = we[:c_in, :c_exp]
    if c_out is None:
        return we, None
    wp = unswizzle(chunks[:, width * k_in :], c_out, width).transpose(1, 2).reshape(n_exp, c_out)
    assert not wp[c_exp:].any()
    return we, wp[:c_exp]


def _stage_of(names, tail=None):
    """(weights, blocks) of backbone ``names`` (+ tail) of the seeded port;
    ``tail`` may be a block name, whose expand conv then serves as the
    expand-only tail."""
    return ir_stage.pack_stage_weights(port(128, folded=True).backbone, names, tail_expand=tail)


# (stage, index of the block in it): the serving stage's blocks and tail,
# block_2 (c_in 24, c_exp 144: both padded), block_4 and a tail at c_in 24
PACK_CASES = {"64to64": (None, 0), "64to96": (None, 3), "96to96": (None, 4), "tail": (None, 6),
              "24to24": ((("block_2",), None), 0), "32to32": ((("block_4",), None), 0),
              "tail24": (((), "block_2"), 0)}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_kernel_pack_round_trips_to_pack_stage_weights(case):
    stage, block = PACK_CASES[case]
    weights, blocks = _stage() if stage is None else _stage_of(*stage)
    packs = ir_stage.kernel_pack(weights, blocks)
    c_in, c_exp, c_out, _ = blocks[block]
    k_in, n_exp = ir_stage.kernel_widths(blocks[block])
    wi = sum(2 if b[2] is None else 6 for b in blocks[:block])
    we, wp = _unpack(packs[block], blocks[block])
    assert torch.equal(we, weights[wi])
    if c_out is None:
        assert wp is None
        width, chunk = ir_stage.TAIL_NC, ir_stage.TAIL_NC * k_in
    else:
        assert torch.equal(wp, weights[wi + 4])
        width, chunk = ir_stage.CH, ir_stage.CH * (k_in + c_out)
    flat = packs[block]
    assert flat.dtype == torch.bfloat16 and flat.numel() == n_exp * (k_in + (c_out or 0))
    assert (chunk * 2) % 512 == 0  # one bulk copy a chunk, stages 512-byte aligned
    # element (channel n of chunk c, input k) of the expand image, and
    # (output o, channel n) of the project image, where the kernel reads them
    rng = np.random.default_rng(block)
    for c, n, k in zip(rng.integers(0, n_exp // width, 20), rng.integers(0, width, 20),
                       rng.integers(0, c_in, 20)):
        at = c * chunk + _sw64_offset(width, n, k)
        e = c * width + n
        assert flat[at] == (weights[wi][k, e] if e < c_exp else 0)
        if c_out is not None:
            o = int(k) % c_out
            at = c * chunk + width * k_in + _sw64_offset(c_out, o, n)
            assert flat[at] == (weights[wi + 4][e, o] if e < c_exp else 0)


def test_kernel_pack_cache_serves_in_place_updates():
    weights, blocks = _stage()
    packs = ir_stage.kernel_pack_cached(weights, blocks)
    assert ir_stage.kernel_pack_cached(weights, blocks) is packs
    with torch.no_grad():
        weights[0].mul_(2)  # an in-place update bumps the version
    fresh = ir_stage.kernel_pack_cached(weights, blocks)
    assert fresh is not packs
    assert torch.equal(_unpack(fresh[0], blocks[0])[0], weights[0])
    # equal values in other tensors are another key
    other = tuple(w.clone() for w in weights)
    assert ir_stage.kernel_pack_cached(other, blocks) is not fresh


def test_stage_weights_cache_follows_parameter_updates():
    bb = port(128, folded=True).backbone
    args = (bb, _FUSED_BLOCKS, "block_13_expand")
    weights, blocks = ir_stage.stage_weights_cached(*args)
    assert ir_stage.stage_weights_cached(*args)[0] is weights
    conv = bb.block_9.block_9_project
    with torch.no_grad():
        conv.weight.add_(1.0)
    updated, _ = ir_stage.stage_weights_cached(*args)
    assert updated is not weights
    ref, ref_blocks = ir_stage.pack_stage_weights(*args)
    assert ref_blocks == blocks
    for a, b in zip(updated, ref):
        assert torch.equal(a, b)
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 0.5)  # a new tensor
    replaced, _ = ir_stage.stage_weights_cached(*args)
    assert replaced is not updated
    assert torch.equal(replaced[2 * 6 + 4], ir_stage.pack_stage_weights(*args)[0][2 * 6 + 4])
    conv.weight.data = conv.weight.data * 2.0  # a new storage under the same parameter
    moved, _ = ir_stage.stage_weights_cached(*args)
    assert moved is not replaced
    assert torch.equal(moved[2 * 6 + 4], ir_stage.pack_stage_weights(*args)[0][2 * 6 + 4])


def test_weight_caches_under_inference_mode():
    bb = port(128, folded=True).backbone
    args = (bb, _FUSED_BLOCKS, "block_13_expand")
    with torch.inference_mode():
        weights, blocks = ir_stage.stage_weights_cached(*args)
        assert ir_stage.stage_weights_cached(*args)[0] is weights
        assert not any(w.is_inference() for w in weights)  # so they key the pack cache
        packs = ir_stage.kernel_pack_cached(weights, blocks)
        assert ir_stage.kernel_pack_cached(weights, blocks) is packs
        # weights made in inference mode carry no version: packed afresh, not cached
        inf_weights, _ = ir_stage.pack_stage_weights(*args)
        assert any(w.is_inference() for w in inf_weights)
        got = ir_stage.kernel_pack_cached(inf_weights, blocks)
        assert got is not ir_stage.kernel_pack_cached(inf_weights, blocks)
    for a, b in zip(got, packs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("img", IMG_SIZES)
def test_ir_stage_plain_matches_flax_tap(img):
    hp, _, _, _, fvars = flax_mobilenet(img)
    S = hp.feature_map_shape
    bb = jax.tree_util.tree_map(jnp.asarray, fvars["params"]["backbone"])
    x = jnp.asarray(images(img)).astype(jnp.bfloat16)
    full = MobileNetV2Backbone(fold_bn=True).apply({"params": bb}, x, train=False)
    prefix = MobileNetV2Backbone(fold_bn=True, stop_after_block=6)
    feat6 = prefix.apply({"params": {k: bb[k] for k in _PREFIX_MODULES}}, x, train=False)
    feat6 = torch.from_numpy(np.array(feat6.astype(jnp.float32))).to(torch.bfloat16)
    weights, blocks = ir_stage.pack_stage_weights(
        port(img, folded=True).backbone, _FUSED_BLOCKS, tail_expand="block_13_expand"
    )
    launches = ir_stage.fused_ir_stage.launches
    got = ir_stage.fused_ir_stage(feat6, weights, blocks)  # CPU -> plain version
    assert ir_stage.fused_ir_stage.launches == launches
    assert got.shape == (2, S, S, 576) and got.dtype == torch.bfloat16
    close(got.float().numpy(), np.asarray(full.astype(jnp.float32)))


# The stage's domain held against tpurpn's kernel in interpret mode (B = 1,
# the same bf16 input and weights): (block names, tail, S, c_in, options).
# Tails at c_in 24 and 32 use block_2's and block_4's expand convs.
SERVING = ("block_7", "block_8", "block_9", "block_10", "block_11", "block_12")
DOMAIN_CASES = {
    "serving_S33": (SERVING, "block_13_expand", 33, 64, {}),
    "serving_S40": (SERVING, "block_13_expand", 40, 64, {}),
    **{f"blocks45_S63_dw{int(dw)}_split{split}": (
        ("block_4", "block_5"), None, 63, 32, {"dw_input_bf16": dw, "c_exp_split": split})
       for dw in (False, True) for split in (1, 2)},
    "block2_S9": (("block_2",), None, 9, 24, {}),
    # splits whose groups are not whole 16-channel steps (72 and 24 channels)
    "block2_S9_split2": (("block_2",), None, 9, 24, {"c_exp_split": 2}),
    "blocks45_S17_split8": (("block_4", "block_5"), None, 17, 32, {"c_exp_split": 8}),
    "tail24_S9": ((), "block_2", 9, 24, {}),
    "tail32_S9": ((), "block_4", 9, 32, {}),
}


def _stage_input(S, c_in, seed=0):
    x = np.random.default_rng(seed).uniform(-1, 1, (1, S, S, c_in)).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _j_stage(names, tail):
    """tpurpn's pack of the same stage as ``_stage_of`` (``tpurpn``'s
    ``pack_stage_weights`` takes block_13_expand alone as a tail)."""
    bb = jax.tree_util.tree_map(jnp.asarray, flax_mobilenet(128)[4]["params"]["backbone"])
    if tail in (None, "block_13_expand"):
        return j_pack_stage_weights(bb, names, tail_expand=tail)
    weights, blocks = j_pack_stage_weights(bb, names)
    (we, be, *_), ((c_in, c_exp, _, _),) = j_pack_stage_weights(bb, (tail,))
    return weights + (we, be), tuple(blocks) + ((c_in, c_exp, None, False),)


@pytest.mark.parametrize("case", list(DOMAIN_CASES))
def test_ir_stage_plain_matches_tpurpn_kernel_interpreted(case):
    """fused_ir_stage on the CPU (its plain version) against tpurpn's
    fused_ir_stage in interpret mode, at bf16 tolerance. (With
    dw_input_bf16, XLA on the CPU keeps each bf16 tap product in f32; the
    port rounds it to bf16 as the operands' type says: up to one bf16 ulp
    of the output apart.)"""
    names, tail, S, c_in, opts = DOMAIN_CASES[case]
    weights, blocks = _stage_of(names, tail)
    jw, jb = _j_stage(names, tail)
    assert tuple(jb) == blocks
    x = _stage_input(S, c_in)
    ref = j_fused_ir_stage(jnp.asarray(x).astype(jnp.bfloat16), jw, tuple(jb), interpret=True,
                           **opts)
    got = ir_stage.fused_ir_stage(torch.from_numpy(x).to(torch.bfloat16), weights, blocks,
                                  **opts)
    c_last = blocks[-1][2] or blocks[-1][1]
    assert got.shape == (1, S, S, c_last) and got.dtype == torch.bfloat16
    close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_ir_stage_dw_input_bf16_changes_the_plain_result():
    weights, blocks = _stage_of(("block_4", "block_5"))
    x = torch.from_numpy(_stage_input(17, 32)).to(torch.bfloat16)
    f32 = ir_stage.fused_ir_stage_plain(x, weights, blocks)
    bf16 = ir_stage.fused_ir_stage_plain(x, weights, blocks, dw_input_bf16=True)
    assert not torch.equal(f32, bf16)
    close(bf16.float().numpy(), f32.float().numpy())


def test_fast_serving_at_a_tap_wider_than_32_matches_tpurpn():
    """make_predict_fn(fast=True) at img_size 520 (an S = 33 stage): the
    fast heads within bf16 tolerance of tpurpn's fast_mobilenet_forward in
    interpret mode, the served proposals exactly those of the port's heads,
    and the proposals of tpurpn's heads selected as tpurpn selects them."""
    from tpurpn.anchors import generate_anchors as j_generate_anchors
    from tpurpn.inference import fast_mobilenet_forward as j_fast_forward
    from tpurpn.predict import decode_outputs as j_decode_outputs
    from tpurpn_torch.inference import fast_mobilenet_forward
    from tpurpn_torch.predict import decode_outputs, generate_proposals, make_predict_fn

    img = 520
    hp, _, _, _, fvars = flax_mobilenet(img)
    thp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=img)
    assert hp.feature_map_shape == thp.feature_map_shape == 33
    model = port(img, folded=True)
    x = images(img, batch=1)
    ref_reg, ref_cls = j_fast_forward(hp, jax.tree_util.tree_map(jnp.asarray, fvars),
                                      jnp.asarray(x).astype(jnp.bfloat16), interpret=True)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    reg, cls = fast_mobilenet_forward(model, xt)
    close(reg.numpy(), np.asarray(ref_reg))
    close(cls.numpy(), np.asarray(ref_cls))

    launches = ir_stage.fused_ir_stage.launches
    out = make_predict_fn(model, thp, fast=True, device="cpu")(xt)
    assert ir_stage.fused_ir_stage.launches == launches  # the CPU runs the plain version
    anchors = tpurpn_torch.generate_anchors(thp, device="cpu")
    expect = generate_proposals(*decode_outputs(anchors, reg, cls, thp), thp)
    for k in expect:
        torch.testing.assert_close(out[k], expect[k], rtol=0, atol=0)
    nv = int(out["num_valid"][0])
    assert 0 < nv <= thp.test_nms_topn and not out["roi_boxes"][0, nv:].any()

    ref_boxes, ref_scores = j_decode_outputs(j_generate_anchors(hp), ref_reg, ref_cls, hp)
    ref = j_generate_proposals(ref_boxes, ref_scores, hp)
    boxes, scores = decode_outputs(anchors, torch.from_numpy(np.array(ref_reg)),
                                   torch.from_numpy(np.array(ref_cls)), thp)
    got = proposal.fused_proposals(boxes, scores, min(thp.pre_nms_topn, thp.total_anchors),
                                   thp.nms_iou_threshold, thp.test_nms_topn)
    np.testing.assert_array_equal(got["num_valid"].numpy(), np.asarray(ref["num_valid"]))
    np.testing.assert_allclose(got["roi_boxes"].numpy(), np.asarray(ref["roi_boxes"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["roi_scores"].numpy(), np.asarray(ref["roi_scores"]),
                               atol=1e-6, rtol=0)


def _strip_tiling(S):
    """(blocks an image, strips, width) of column strips at S: one strip of S
    up to 32 columns, else the fewest of at most 30 columns, balanced."""
    if S <= 32:
        return -(-S // 8), 1, S
    strips = -(-S // 30)
    width = -(-S // strips)
    strips = -(-S // width)
    return -(-S // 8) * strips, strips, width


def test_ir_block_plan_tiles_every_S():
    """ir_block_plan for S = 1..160: each tiling's blocks cover an image's S^2
    pixels exactly once, strips fit 32 slots with their halo, a flat run's
    staged range (n + 2 S + 2) fits the 320-pixel tile, spans 3 image rows or
    more and holds at most 32 units of 8 columns (the fewest blocks that
    do), the plan takes the
    tiling of fewer blocks an image (strips on a tie) and takes strips at
    S <= 32 and at block_2's S = 125 and 160, flat at the 640, 750 and
    1000 px serving taps (S = 40, 47, 63)."""

    def fits(n, S):
        shape = [ir_stage.flat_units(S, n, f0) for f0 in range(0, S * S, n)]
        return n + 2 * (S + 1) <= 320 and all(r >= 3 and u <= 32 for r, u in shape)

    tiling = {}
    for S in range(1, 161):
        plan = ir_stage.ir_block_plan(S)
        tiling[S] = plan.tiling
        blocks, strips, width = _strip_tiling(S)
        cover = np.zeros((S, S), np.int64)
        for rb in range(-(-S // 8)):
            for st in range(strips):
                cover[8 * rb:8 * rb + 8, st * width:min(st * width + width, S)] += 1
        assert (cover == 1).all() and width <= (32 if strips == 1 else 30), S
        flat = ir_stage.flat_plan(S)
        n_max = 320 - 2 * (S + 1)
        if flat is None:  # no run fits: one that spans 3 rows has 2 S + 1 pixels or more
            assert S <= 32 or n_max < 1 or not any(
                fits(-(-S * S // b), S) for b in range(-(-S * S // n_max), S * S // (2 * S) + 1))
        else:
            n = flat.width
            assert flat.strips == 0 and flat.blocks == -(-S * S // n) and fits(n, S), S
            assert flat.blocks == 1 or not fits(-(-S * S // (flat.blocks - 1)), S), S
            cover = np.zeros(S * S, np.int64)
            for b in range(flat.blocks):
                cover[b * n:(b + 1) * n] += 1
            assert (cover == 1).all(), S
        if flat is not None and flat.blocks < blocks:
            assert plan == flat, S
        else:
            assert plan == ("strips", blocks, strips, width), S
    assert all(tiling[S] == "strips" for S in list(range(1, 33)) + [80, 125, 160])
    assert tiling[40] == tiling[47] == tiling[63] == "flat"
    assert ir_stage.ir_block_plan(40) == ("flat", 7, 0, 229)
    assert ir_stage.ir_block_plan(32) == ("strips", 4, 1, 32)
    with pytest.raises(ValueError):
        ir_stage.ir_block_plan(0)


KSLOTS, PITCH = 332, 65  # csrc/ir_stage.cu: kSlots, kPitch of the flat tiling's expand tile


def _flat_word(c):
    """csrc/ir_stage.cu: flat_word, channel c's word in a slot."""
    return (c & 0x21) | ((c >> 2) & 6) | ((c << 2) & 0x18)


def _flat_depthwise_model(h, taps, S, n):
    """csrc/ir_stage.cu's flat tiling of the depthwise, index for index: per
    thread block the slot table (pitch S + 1, a zero slot between image rows,
    65 words a slot, channel c at word flat_word(c)), the 32 units of 8
    columns (the first row's from its first output, then k-major down the
    rows, a unit past a row's last output shifted back to end there; 8 a
    thread in two streams of 4, a unit below the one before keeping two
    window rows; every window inside the tile), each unit's outputs in h2
    rows 8u + i and the table of the pixel each row holds (-1: none).
    h (S*S, 64) expanded values, taps (9, 64); returns the depthwise sums
    (S*S, 64) and how often each pixel was written."""
    word = _flat_word(np.arange(64))
    assert sorted(word) == list(range(64))
    out = np.zeros((S * S, 64))
    written = np.zeros(S * S, np.int64)
    for blk in range(-(-S * S // n)):
        f0 = blk * n
        g0 = f0 - S - 1
        tile = np.zeros(KSLOTS * PITCH)
        y0 = (g0 + 2 * S) // S - 2
        x0 = g0 - y0 * S
        for p in range(320):
            slot = p + 1 + (x0 + p) // S
            assert slot < KSLOTS
            g = g0 + p
            tile[slot * PITCH + word] = h[g] if 0 <= g < S * S else 0.0
        nv = min(n, S * S - f0)
        ya, ca = divmod(f0, S)
        yb, cb = divmod(f0 + nv - 1, S)
        nseg, first, last = (S + 7) >> 3, (S - ca + 7) >> 3, (cb + 8) >> 3
        assert yb - ya >= 2
        unit_sb, pix_of = [], []
        for t in range(32):
            y, k, u = -1, 0, t
            if u < first:
                y, k = ya, u
            else:
                u -= first
                for kk in range(nseg):
                    rows = yb - ya - 1 + (kk < last)
                    if u < rows:
                        y, k = ya + 1 + u, kk
                        break
                    u -= rows
            hi, ns = (cb if y == yb else S - 1), (ca if y == ya else 0) + 8 * k
            st = max(ca, min(ns, hi - 7)) if y == ya else min(ns, hi - 7)
            unit_sb.append((y - 1 - y0) * (S + 1) + st - x0 if y >= 0 else 0)
            for i in range(8):
                xc = st + i
                mine = y >= 0 and ns <= xc < ns + 8 and xc <= hi
                pix_of.append(y * S + xc - f0 if mine else -1)

        def window(sb):
            assert 0 <= sb and sb + 10 <= KSLOTS
            return np.stack([tile[(sb + i) * PITCH + word] for i in range(10)])

        h2 = np.zeros((256, 64))
        for qt, first in [(qt, first) for qt in range(4) for first in (0, 4)]:
            win = [None] * 3
            for r in range(first, first + 4):
                sb = unit_sb[8 * qt + r]
                if r == first or sb != unit_sb[8 * qt + r - 1] + S + 1:
                    win[r % 3], win[(r + 1) % 3] = window(sb), window(sb + S + 1)
                win[(r + 2) % 3] = window(sb + 2 * (S + 1))
                rows3 = [win[r % 3], win[(r + 1) % 3], win[(r + 2) % 3]]
                for i in range(8):
                    acc = np.zeros(64)
                    for dy in range(3):
                        for dx in range(3):
                            acc = acc + rows3[dy][i + dx] * taps[dy * 3 + dx]
                    h2[64 * qt + 8 * r + i] = acc
        for m, j in enumerate(pix_of):
            if j >= 0:
                out[f0 + j] = h2[m]
                written[f0 + j] += 1
    return out, written


@pytest.mark.parametrize("S", [33, 40, 47, 52, 63, 68])
def test_flat_tiling_model_computes_the_same_depthwise(S):
    """The flat tiling's geometry (model above, at the plan's n) gives every
    pixel once, the SAME depthwise summed in tpurpn's tap order, bit for bit
    (the taps and values are exact in float64, the order is the same)."""
    plan = ir_stage.ir_block_plan(S)
    assert plan.tiling == "flat"
    rng = np.random.default_rng(S)
    h = rng.uniform(0, 6, (S * S, 64))
    taps = rng.normal(size=(9, 64))
    got, written = _flat_depthwise_model(h, taps, S, plan.width)
    assert (written == 1).all()
    hp = np.pad(h.reshape(S, S, 64), ((1, 1), (1, 1), (0, 0)))
    ref = np.zeros((S, S, 64))
    for dy in range(3):
        for dx in range(3):
            ref = ref + hp[dy:dy + S, dx:dx + S] * taps[dy * 3 + dx]
    np.testing.assert_array_equal(got, ref.reshape(S * S, 64))


def _random_candidates(rng, B, N):
    b = np.zeros((B, N, 4), np.float32)
    b[..., :2] = rng.uniform(0, 0.6, (B, N, 2))
    b[..., 2:] = b[..., :2] + rng.uniform(0.02, 0.4, (B, N, 2))
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    return b, scores


def _case(name, rng):
    """(boxes, scores, topn, pre_nms_topn): the cases of test_proposal_pallas.py."""
    if name == "random":
        return (*_random_candidates(rng, 3, 1500), 50, 6000)
    if name == "early_exit_multiblock":
        return (*_random_candidates(rng, 2, 3000), 300, 6000)
    if name == "duplicates":
        boxes = np.tile(np.array([0.2, 0.2, 0.5, 0.5], np.float32), (1, 600, 1))
        boxes[0, 599] = [0.6, 0.6, 0.9, 0.9]
        return boxes, np.linspace(0.1, 0.9, 600, dtype=np.float32)[None], 10, 6000
    if name == "score_ties":
        boxes, _ = _random_candidates(rng, 2, 1024)
        return boxes, (rng.integers(0, 7, (2, 1024)) / 7.0).astype(np.float32), 40, 6000
    if name == "pre_smaller_than_n":
        return (*_random_candidates(rng, 2, 2048), 100, 512)
    if name == "fewer_than_topn":
        return (*_random_candidates(rng, 2, 160), 300, 6000)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "random", "early_exit_multiblock", "duplicates", "score_ties",
    "pre_smaller_than_n", "fewer_than_topn",
])
def test_proposal_plain_matches_generate_proposals_exactly(rng, name):
    boxes, scores, topn, pre_nms = _case(name, rng)
    hp = tpurpn.get_hyper_params("vgg16", img_size=160, compute_dtype="float32",
                                 pre_nms_topn=pre_nms)
    ref = j_generate_proposals(jnp.asarray(boxes), jnp.asarray(scores), hp, topn=topn)
    launches = proposal.fused_proposals.launches
    got = proposal.fused_proposals(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        pre=min(pre_nms, boxes.shape[1]), iou_threshold=hp.nms_iou_threshold,
        max_output=topn,
    )  # CPU -> plain version
    assert proposal.fused_proposals.launches == launches
    assert got["num_valid"].dtype == torch.int32
    np.testing.assert_array_equal(got["num_valid"].numpy(), np.asarray(ref["num_valid"]))
    np.testing.assert_array_equal(got["roi_boxes"].numpy(), np.asarray(ref["roi_boxes"]))
    np.testing.assert_array_equal(got["roi_scores"].numpy(), np.asarray(ref["roi_scores"]))
    if name == "duplicates":
        assert int(got["num_valid"][0]) == 2


def test_proposal_plain_matches_pallas_kernel_interpreted(rng):
    boxes, scores = _random_candidates(rng, 2, 1200)
    ref = fused_proposals_planes(
        jnp.moveaxis(jnp.asarray(boxes), -1, 1), jnp.asarray(scores),
        pre=1000, iou_threshold=0.7, max_output=120, interpret=True,
    )
    got = proposal.fused_proposals_plain(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        pre=1000, iou_threshold=0.7, max_output=120,
    )
    np.testing.assert_array_equal(got["num_valid"].numpy(), np.asarray(ref["num_valid"]))
    np.testing.assert_array_equal(got["roi_boxes"].numpy(), np.asarray(ref["roi_boxes"]))
    np.testing.assert_array_equal(got["roi_scores"].numpy(), np.asarray(ref["roi_scores"]))


def _chunked_selection(boxes, scores, pre, thr, max_output, chunk=32):
    """csrc/proposal.cu's selection, one image at a time: rounds of `chunk`
    candidates in score order, each tested against the boxes kept before
    the round, then resolved by the fixpoint of chunk_walk over the in-chunk
    rows; at most max_output keeps, even inside a round."""
    def side(a, b, lo, hi):
        return torch.clamp(torch.minimum(a[..., hi], b[..., hi])
                           - torch.maximum(a[..., lo], b[..., lo]), min=0)

    def area(x):
        return torch.clamp(x[..., 2] - x[..., 0], min=0) * torch.clamp(x[..., 3] - x[..., 1], min=0)

    def iou_above(a, b):  # tpurpn.boxes.generate_iou_map, op for op
        inter = side(a, b, 0, 2) * side(a, b, 1, 3)
        return inter / torch.clamp(area(a) + area(b) - inter, min=1e-8) > thr

    order = proposal.top_candidates(scores, pre)
    out_b = torch.zeros((scores.shape[0], max_output, 4))
    out_s = torch.zeros((scores.shape[0], max_output))
    counts = []
    for img in range(scores.shape[0]):
        kept = []
        for c0 in range(0, pre, chunk):
            if len(kept) == max_output:
                break
            idx = order[img, c0 : c0 + chunk]
            cb, cs = boxes[img, idx], scores[img, idx]
            alive = cs > -float("inf")
            if kept:
                kb = boxes[img, torch.stack(kept)]
                alive &= ~iou_above(cb[:, None], kb[None]).any(1)
            rows = iou_above(cb[:, None], cb[None]) & torch.ones(len(idx), len(idx)).tril(-1).bool()
            keep = alive.clone()
            while True:  # the unique fixpoint: bit i depends on bits below i
                nxt = alive & ~(rows & keep[None]).any(1)
                if torch.equal(nxt, keep):
                    break
                keep = nxt
            for i in torch.nonzero(keep).flatten()[: max_output - len(kept)]:
                kept.append(idx[i])
        n = len(kept)
        counts.append(n)
        if n:
            out_b[img, :n] = boxes[img, torch.stack(kept)]
            out_s[img, :n] = scores[img, torch.stack(kept)]
    return {"roi_boxes": out_b, "roi_scores": out_s,
            "num_valid": torch.tensor(counts, dtype=torch.int32)}


@pytest.mark.parametrize("name", ["random", "duplicates", "score_ties", "pre_smaller_than_n",
                                  "fewer_than_topn", "dense_keep_all", "all_neg_inf_image"])
def test_chunked_selection_matches_plain(rng, name):
    if name == "dense_keep_all":  # disjoint boxes: the 300th keep lands inside a chunk
        i = np.arange(2000, dtype=np.float32)
        yx = np.stack([i // 50, i % 50], -1) * 0.02
        boxes = np.tile(np.concatenate([yx, yx + 0.01], -1)[None], (2, 1, 1))
        scores, topn, pre = rng.uniform(0, 1, (2, 2000)).astype(np.float32), 300, 1037
    elif name == "all_neg_inf_image":
        boxes, scores = _random_candidates(rng, 2, 700)
        scores[0] = -np.inf
        topn, pre = 50, 700
    else:
        boxes, scores, topn, pre = _case(name, rng)
        pre = min(pre, boxes.shape[1])
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = _chunked_selection(boxes, scores, pre, 0.7, topn)
    ref = proposal.fused_proposals_plain(boxes, scores, pre, 0.7, topn)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key


def test_top_candidates_break_ties_to_the_lower_index():
    scores = torch.zeros((1, 40))
    scores[0, 7] = 1.0
    order = proposal.top_candidates(scores, 5)
    assert order.tolist() == [[7, 0, 1, 2, 3]]
    _, ref = jax.lax.top_k(jnp.zeros((1, 40)).at[0, 7].set(1.0), 5)
    assert order.tolist() == np.asarray(ref).tolist()


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """No CUDA compiler anywhere, no library built or loaded."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})


def _meta_stage():
    weights, blocks = ir_stage.pack_stage_weights(
        port(128, folded=True).backbone, _FUSED_BLOCKS, tail_expand="block_13_expand"
    )
    return tuple(w.to("meta") for w in weights), blocks


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


HP_VGG = tpurpn_torch.get_hyper_params("vgg16")


@pytest.mark.parametrize("kernel", ["ir_stage", "proposals", "proposal_select", "targets",
                                    "iou_matching", "nms", "prefix_pointwise",
                                    "prefix_depthwise"])
def test_wrappers_build_the_kernel_or_raise_off_the_cpu(no_nvcc, kernel):
    if kernel == "proposal_select":
        fn = proposal.fused_proposals  # _select counts its launches here
        launches = fn.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            proposal._select(_meta((2, 500, 4)), _meta((2, 500)), _meta((2, 400), torch.int64),
                             0.7, 50)
        assert fn.launches == launches
        return
    if kernel == "ir_stage":
        weights, blocks = _meta_stage()
        fn = ir_stage.fused_ir_stage
        args = (_meta((2, 32, 32, 64), torch.bfloat16), weights, blocks)
    elif kernel == "proposals":
        fn = proposal.fused_proposals
        args = (_meta((2, 500, 4)), _meta((2, 500)), 400, 0.7, 50)
    elif kernel == "targets":
        fn = targets.fused_rpn_targets
        args = (_meta((8649, 4)), _meta((2, 8, 4)), _meta((2, 8), torch.int32),
                _meta((2, 2, 8649), torch.int32), HP_VGG)
    elif kernel == "iou_matching":
        fn = targets.fused_iou_matching
        args = (_meta((8649, 4)), _meta((2, 8, 4)))
    elif kernel == "prefix_pointwise":  # block_2's project, with its residual
        fn = prefix.prefix_pointwise
        pw = prefix.pack_pointwise(port(128, folded=True).backbone.block_2.block_2_project,
                                   False, True)
        args = (_meta((2, 9, 9, 144), torch.bfloat16),
                prefix.Pointwise(*(t.to("meta") for t in pw[:3]), *pw[3:]),
                _meta((2, 9, 9, 24), torch.bfloat16))
    elif kernel == "prefix_depthwise":
        fn = prefix.prefix_depthwise
        dw = prefix.pack_depthwise(port(128, folded=True).backbone.block_3.block_3_depthwise)
        args = (_meta((2, 9, 9, 144), torch.bfloat16),
                prefix.Depthwise(dw.taps.to("meta"), dw.b.to("meta"), dw.stride))
    else:
        fn = nms.nms_keep
        args = (_meta((2, 500, 4)), _meta((2, 500), torch.bool), 0.7, 50)
    launches = fn.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fn(*args)
    assert fn.launches == launches


def test_cluster_size_names_an_entry_and_needs_the_kernels(no_nvcc):
    with pytest.raises(ValueError, match="no CUDA entry"):
        targets.cluster_size("targets")
    for entry in ("iou_matching", "rpn_targets"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            targets.cluster_size(entry)


def test_wrappers_reject_inputs_their_kernels_do_not_take(no_nvcc):
    weights, blocks = _meta_stage()
    for x in (_meta((2, 32, 32, 64)), _meta((2, 32, 32, 96), torch.bfloat16),
              _meta((2, 32, 16, 64), torch.bfloat16)):
        with pytest.raises(ValueError):
            ir_stage.fused_ir_stage(x, weights, blocks)
    # a block spec outside the stage's domain, and splits it refuses, on
    # the card and on the CPU alike
    x40 = _meta((2, 40, 40, 64), torch.bfloat16)
    w48 = (_meta((48, 288), torch.bfloat16), _meta((288,)), _meta((9, 288)), _meta((288,)),
           _meta((288, 48), torch.bfloat16), _meta((48,)))
    with pytest.raises(ValueError, match="takes the blocks"):
        ir_stage.fused_ir_stage(_meta((2, 40, 40, 48), torch.bfloat16), w48,
                                ((48, 288, 48, True),))
    with pytest.raises(ValueError, match="does not divide"):
        ir_stage.fused_ir_stage(x40, weights, blocks, c_exp_split=5)
    with pytest.raises(ValueError, match="one \\(c_exp, c_out\\)"):
        ir_stage.fused_ir_stage(x40, weights, blocks, c_exp_split=2)
    with pytest.raises(ValueError, match="does not divide"):
        ir_stage.fused_ir_stage(torch.zeros((1, 9, 9, 32), dtype=torch.bfloat16),
                                *_stage_of(("block_4", "block_5")), c_exp_split=5)
    for boxes, scores, pre in (
        (_meta((2, 500, 4), torch.float64), _meta((2, 500)), 400),
        (_meta((2, 500, 4)), _meta((2, 400)), 400),
        (_meta((2, 500, 4)), _meta((2, 500)), 600),
    ):
        with pytest.raises(ValueError):
            proposal.fused_proposals(boxes, scores, pre, 0.7, 50)
    gt, lab, bits = _meta((2, 8, 4)), _meta((2, 8), torch.int32), _meta((2, 2, 900), torch.int32)
    for a, g, lb, w in (
        (_meta((900, 4), torch.float64), gt, lab, bits),
        (_meta((900, 4)), _meta((2, 0, 4)), _meta((2, 0), torch.int32), bits),
        (_meta((900, 4)), gt, lab, _meta((2, 2, 900))),
        (_meta((900, 4)), gt, lab, _meta((2, 2, 800), torch.int32)),
        (_meta((900,)), gt, lab, bits),
    ):
        with pytest.raises(ValueError):
            targets.fused_rpn_targets(a, g, lb, w, HP_VGG)
    with pytest.raises(ValueError):
        targets.fused_iou_matching(_meta((900, 4)), _meta((2, 8, 5)))
    for b, v, block in (
        (_meta((2, 500, 4), torch.float16), _meta((2, 500), torch.bool), 128),
        (_meta((2, 500, 4)), _meta((2, 500)), 128),
        (_meta((2, 500, 4)), _meta((2, 400), torch.bool), 128),
        (_meta((2, 500, 4)), _meta((2, 500), torch.bool), 100),
        (_meta((2, 500, 4)), _meta((2, 500), torch.bool), 2048),
    ):
        with pytest.raises(ValueError):
            nms.nms_keep(b, v, 0.7, 50, block=block)
