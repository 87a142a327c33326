"""Proposal recall of the port held against ``tpurpn.eval.proposal_recall``.

Seeded numpy proposals and GT go through both; recall, GT count and
recalled count are equal, including IoUs of exactly 0.5, padded GT rows,
``num_valid`` = 0 and images of padding only. Then the committed trained
checkpoint serves 4 native validation frames at 500x500 in both packages
(``tpurpn`` from the ``.h5`` through its plain forward; the port from the
``.npz`` through its fast path, which runs the kernels' plain versions on
the CPU): the GT counts agree and the recalled counts within 1. Recall is
compared, not indices: greedy NMS flips on 1-ulp differences of the
forwards.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpurpn
import tpurpn.data as j_data
from tpurpn.eval import proposal_recall as j_proposal_recall
from tpurpn.io_utils import load_keras_h5_weights as j_load_h5
from tpurpn.model import fold_batch_norm as j_fold_batch_norm
from tpurpn.model import get_model as j_get_model
from tpurpn.model import init_model as j_init_model
from tpurpn.predict import make_predict_fn as j_make_predict_fn
import tpurpn_torch
from tpurpn_torch import data, io_utils, proposal_recall

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "trained", "rpn_mobilenet_v2_trained")


def both(roi, nv, gt, labels, thr=0.5):
    ref = j_proposal_recall(jnp.asarray(roi), jnp.asarray(nv), jnp.asarray(gt),
                            jnp.asarray(labels), iou_threshold=thr)
    got = proposal_recall(*(torch.from_numpy(a) for a in (roi, nv, gt, labels)),
                          iou_threshold=thr)
    return ({k: float(v) for k, v in got.items()}, {k: float(v) for k, v in ref.items()})


def random_case(rng, B, P, M):
    yx = rng.uniform(0, 0.7, (B, P, 2))
    roi = np.concatenate([yx, yx + rng.uniform(0.05, 0.3, (B, P, 2))], -1).astype(np.float32)
    nv = rng.integers(0, P + 1, (B,)).astype(np.int32)
    roi[np.arange(P)[None] >= nv[:, None]] = 0.0
    gyx = rng.uniform(0, 0.7, (B, M, 2))
    gt = np.concatenate([gyx, gyx + rng.uniform(0.05, 0.3, (B, M, 2))], -1).astype(np.float32)
    n_gt = rng.integers(0, M + 1, (B,))
    labels = np.where(np.arange(M)[None] < n_gt[:, None], 1, -1).astype(np.int32)
    gt[labels == -1] = 0.0
    return roi, nv, gt, labels


@pytest.mark.parametrize("seed,B,P,M,thr", [
    (0, 4, 300, 8, 0.5), (1, 3, 50, 16, 0.5), (2, 5, 20, 4, 0.3), (3, 2, 300, 64, 0.7),
])
def test_recall_matches_tpurpn(seed, B, P, M, thr):
    got, ref = both(*random_case(np.random.default_rng(seed), B, P, M), thr=thr)
    assert got == ref
    assert 0 < ref["num_gt"]


def test_recall_edges_match_tpurpn():
    # image 0: IoU of exactly 0.5 (recalled) and one just below (not);
    # image 1: num_valid = 0 with real boxes past it; image 2: padding only
    roi = np.zeros((3, 4, 4), np.float32)
    roi[0, 0] = (0.0, 0.0, 0.5, 1.0)    # IoU 0.5 with GT 0 (0, 0, 1, 1)
    roi[0, 1] = (0.0, 0.0, 0.25, 0.5)   # IoU 0.5 with GT 1 (0, 0, 0.5, 0.5)
    roi[0, 2] = (0.5, 0.5, 0.74, 1.0)   # IoU 0.48 with GT 2 (0.5, 0.5, 1, 1)
    roi[1, :2] = (0.1, 0.1, 0.4, 0.4)
    gt = np.zeros((3, 5, 4), np.float32)
    gt[0, :3] = [(0, 0, 1, 1), (0, 0, 0.5, 0.5), (0.5, 0.5, 1, 1)]
    gt[1, 0] = (0.1, 0.1, 0.4, 0.4)
    labels = np.full((3, 5), -1, np.int32)
    labels[0, :3] = 1
    labels[1, 0] = 2
    nv = np.array([3, 0, 4], np.int32)
    got, ref = both(roi, nv, gt, labels)
    assert got == ref
    assert ref["num_gt"] == 4 and ref["num_recalled"] == 2
    got, ref = both(roi[2:], nv[2:], gt[2:], labels[2:])
    assert got == ref and ref == {"recall": 0.0, "num_gt": 0.0, "num_recalled": 0.0}


def test_trained_checkpoint_recall_matches_tpurpn():
    B = 4
    jhp = tpurpn.get_hyper_params("mobilenet_v2")
    thp = tpurpn_torch.get_hyper_params("mobilenet_v2")
    imgs, boxes, labels = next(j_data.SyntheticVOC(num_samples=B, seed=1).batches(B))
    port_batch = next(data.SyntheticVOC(num_samples=B, seed=1).batches(B))
    for a, b in zip(port_batch, (imgs, boxes, labels)):
        np.testing.assert_array_equal(a, b)

    jmodel = j_get_model(jhp)
    v = j_init_model(jmodel, jax.random.key(0))
    params, stats, missing = j_load_h5(TRAINED + ".h5", v["params"], v["batch_stats"])
    assert missing == []
    fmodel, fvars = j_fold_batch_norm(jhp, {"params": params, "batch_stats": stats})
    x, b = j_data.preprocess_batch(jnp.asarray(imgs), jnp.asarray(boxes), jhp.img_size)
    out = j_make_predict_fn(fmodel, jhp)(fvars, x)
    ref = j_proposal_recall(out["roi_boxes"], out["num_valid"], b, jnp.asarray(labels))

    model = tpurpn_torch.init_model(tpurpn_torch.get_model(thp), device="cpu")
    model, missing = io_utils.load_keras_h5_weights(TRAINED + ".npz", model)
    assert missing == []
    predict = tpurpn_torch.make_predict_fn(tpurpn_torch.fold_batch_norm(model), thp,
                                           fast=True, device="cpu")
    tx, tb = data.preprocess_batch(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                   thp.img_size)
    tout = predict(tx)
    got = proposal_recall(tout["roi_boxes"], tout["num_valid"], tb, torch.from_numpy(labels))
    assert int(got["num_gt"]) == int(ref["num_gt"]) > 0
    assert abs(int(got["num_recalled"]) - int(ref["num_recalled"])) <= 1
    assert float(ref["recall"]) > 0.5  # the trained weights find the objects
