"""The plain versions of the port's serving kernels held against ``tpurpn``,
and the dispatch of every kernel wrapper.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there); here the CPU wrappers dispatch to the
plain versions.

* IR stage: ``tpurpn``'s own oracle for its kernel (tests/test_ir_stage.py)
  — the stage fed the folded flax prefix's block_6 output must equal the
  full folded flax backbone tap, at bf16 tolerance.
* Proposals: bit-exact (atol 0) against ``tpurpn.predict.generate_proposals``
  on identical f32 candidates, over the cases of
  tests/test_proposal_pallas.py, plus one case against the Pallas kernel in
  interpret mode.
* Dispatch: a tensor off the CPU (``meta`` here) never reaches the plain
  version; it goes to the kernel's build, or the wrapper rejects it. This
  covers every wrapper: IR stage, proposals, targets, IoU matching, NMS
  (the plain versions of the last three are held against ``tpurpn`` in
  tests/test_torch_targets.py and tests/test_torch_nms.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpurpn
from tpurpn.backbones.mobilenet_v2 import MobileNetV2Backbone
from tpurpn.inference import _FUSED_BLOCKS, _PREFIX_MODULES
from tpurpn.kernels.ir_stage_pallas import pack_stage_weights as j_pack_stage_weights
from tpurpn.kernels.proposal_pallas import fused_proposals_planes
from tpurpn.predict import generate_proposals as j_generate_proposals
import tpurpn_torch
from tpurpn_torch.kernels import _build, ir_stage, nms, proposal, targets

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


@pytest.mark.parametrize("kernel", ["ir_stage", "proposals", "targets", "iou_matching", "nms"])
def test_wrappers_build_the_kernel_or_raise_off_the_cpu(no_nvcc, kernel):
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
    else:
        fn = nms.nms_keep
        args = (_meta((2, 500, 4)), _meta((2, 500), torch.bool), 0.7, 50)
    launches = fn.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fn(*args)
    assert fn.launches == launches


def test_wrappers_reject_inputs_their_kernels_do_not_take(no_nvcc):
    weights, blocks = _meta_stage()
    for x in (_meta((2, 32, 32, 64)), _meta((2, 32, 32, 96), torch.bfloat16),
              _meta((2, 32, 16, 64), torch.bfloat16)):
        with pytest.raises(ValueError):
            ir_stage.fused_ir_stage(x, weights, blocks)
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
