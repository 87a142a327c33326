"""The plain reference against tpurpn_torch's plain (CPU, float32) path at
a small size: anchors, decoding, preprocessing, targets, both networks and
the loss."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers.train import leaves
from portbench.reference import geometry, nets
from portbench.reference import serve as ref_serve

IMG = 64


def test_anchors_and_decode():
    import tpurpn_torch as T

    for backbone in ("mobilenet_v2", "vgg16"):
        hp = T.get_hyper_params(backbone, img_size=IMG)
        fm = geometry.feature_map(backbone, IMG)
        assert fm == hp.feature_map_shape
        anc = geometry.anchors(IMG, fm)
        assert np.array_equal(anc, T.generate_anchors(hp).numpy())
    d = torch.randn((2, anc.shape[0], 4), generator=torch.Generator().manual_seed(0)) * 0.1
    a = torch.from_numpy(anc)
    assert torch.equal(geometry.decode(a[None], d), T.get_bboxes_from_deltas(a[None], d))


def _batch(n=3, seed=5):
    from tpurpn_torch.data import SyntheticVOC

    imgs, boxes, labels = next(SyntheticVOC(num_samples=n, raw_h=48, raw_w=64,
                                            seed=seed).batches(n))
    return torch.from_numpy(imgs), torch.from_numpy(boxes), torch.from_numpy(labels)


def test_preprocess_and_targets():
    import tpurpn_torch as T
    from tpurpn_torch.data import preprocess_batch
    from tpurpn_torch.target import rpn_targets_plain, target_rand_bits

    imgs, boxes, labels = _batch()
    flip = torch.tensor([True, False, True])
    x, b = geometry.preprocess(imgs, IMG, boxes, flip)
    xp, bp = preprocess_batch(imgs, boxes, IMG, augment=True, flip=flip)
    assert torch.allclose(x, xp, atol=1e-6) and torch.equal(b, bp)
    hp = T.get_hyper_params("vgg16", img_size=IMG)
    anc = T.generate_anchors(hp)
    words = target_rand_bits(torch.Generator().manual_seed(2), 3, anc.shape[0])
    d, lab = geometry.targets(anc, b, labels, words)
    dp, lp = rpn_targets_plain(anc, bp, labels, words, hp)
    assert torch.equal(lab, lp)
    assert torch.allclose(d, dp, rtol=1e-6, atol=1e-7)
    assert int((lab == 1).sum()) > 0 and int((lab == 0).sum()) > 0


def test_mobilenet_v2_against_the_port():
    import tpurpn_torch as T
    from tpurpn_torch.io_utils import load_keras_h5_weights

    cfg = harness.config("mobilenet_v2-500-serve")
    hp = T.get_hyper_params("mobilenet_v2", img_size=IMG, compute_dtype="float32")
    model, _ = load_keras_h5_weights(str(harness.REPO / cfg["weights"]), T.get_model(hp))
    model.eval()
    x = torch.rand((2, IMG, IMG, 3), generator=torch.Generator().manual_seed(1))
    reg_p, cls_p = model(x)
    p = ref_serve.load_npz(harness.REPO / cfg["weights"], "cpu")
    reg, cls = nets.mobilenet_v2(p, x)
    assert torch.allclose(reg, reg_p.reshape(reg.shape), rtol=1e-4, atol=1e-4)
    assert torch.allclose(cls, cls_p.reshape(cls.shape), rtol=1e-4, atol=1e-4)
    q_reg, _ = nets.mobilenet_v2(p, x, quant="fp8")
    assert (q_reg - reg).abs().max() > 10 * (reg - reg_p.reshape(reg.shape)).abs().max()


def test_vgg16_and_loss_against_the_port():
    import tpurpn_torch as T
    from tpurpn_torch.losses import reg_loss, rpn_cls_loss
    from tpurpn_torch.model import to_device

    hp = T.get_hyper_params("vgg16", img_size=IMG, compute_dtype="float32")
    p0 = leaves(torch, nets.vgg16_names(), 7, "cpu")
    model = to_device(T.get_model(hp), "cpu")
    with torch.no_grad():
        for k, v in model.named_parameters():
            v.copy_(p0[k])
    x = torch.rand((2, IMG, IMG, 3), generator=torch.Generator().manual_seed(1))
    reg_p, cls_p = model(x)
    reg, cls = nets.vgg16(p0, x)
    assert torch.allclose(reg, reg_p.reshape(reg.shape), rtol=1e-4, atol=1e-5)
    assert torch.allclose(cls, cls_p.reshape(cls.shape), rtol=1e-4, atol=1e-5)
    g = torch.Generator().manual_seed(4)
    deltas = torch.where(torch.rand(reg.shape, generator=g) < 0.05, 0.3, 0.0)
    labels = torch.randint(-1, 2, cls.shape, generator=g).float()
    l_reg, l_cls = geometry.rpn_loss(deltas, labels, reg, cls)
    assert torch.allclose(l_reg, reg_loss(deltas, reg), rtol=1e-6)
    assert torch.allclose(l_cls, rpn_cls_loss(labels, cls), rtol=1e-6)


@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_greedy_nms_against_the_port(thr):
    from tpurpn_torch.boxes import batched_non_max_suppression

    g = torch.Generator().manual_seed(3)
    ctr = torch.rand((2, 500, 2), generator=g)
    hw = torch.rand((2, 500, 2), generator=g) * 0.3 + 0.02
    boxes = torch.cat([ctr - hw / 2, ctr + hw / 2], -1)
    scores = torch.rand((2, 500), generator=g)
    sel = ref_serve.select(boxes, scores, 400, thr, 50)
    idx, nv = batched_non_max_suppression(boxes, scores, 50, thr, use_kernel=False)
    for i in range(2):
        want = boxes[i, idx[i, :nv[i]].long()].numpy()
        assert sel["num_valid"][i] == nv[i]
        assert np.array_equal(sel["roi_boxes"][i, :nv[i]], want)
