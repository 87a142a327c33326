"""The frozen counts: FLOPs against hand-worked layer sums, and the kernel
bounds against ``chip_smoke.py``'s at the same shapes."""

import importlib.util

import numpy as np
import pytest
import torch

from portbench import counts, harness
from portbench.reference import geometry


def _sum(layers):
    """2 x h_out^2 x c_out x c_in_per_group x k^2 over (h_out, c_in_g, c_out, k)."""
    return sum(2 * h * h * co * ci * k * k for h, ci, co, k in layers)


def _head(h, c):
    return [(h, c, 512, 3), (h, 512, 9, 1), (h, 512, 36, 1)]


def test_mobilenet_v2_500_by_hand():
    L = [(250, 3, 32, 3),  # Conv1, stride 2
         (250, 1, 32, 3), (250, 32, 16, 1)]  # expanded_conv: dw, project
    L += [(250, 16, 96, 1), (125, 1, 96, 3), (125, 96, 24, 1)]  # block_1
    L += [(125, 24, 144, 1), (125, 1, 144, 3), (125, 144, 24, 1)]  # block_2
    L += [(125, 24, 144, 1), (63, 1, 144, 3), (63, 144, 32, 1)]  # block_3
    L += [(63, 32, 192, 1), (63, 1, 192, 3), (63, 192, 32, 1)] * 2  # block_4, 5
    L += [(63, 32, 192, 1), (32, 1, 192, 3), (32, 192, 64, 1)]  # block_6
    L += [(32, 64, 384, 1), (32, 1, 384, 3), (32, 384, 64, 1)] * 3  # block_7-9
    L += [(32, 64, 384, 1), (32, 1, 384, 3), (32, 384, 96, 1)]  # block_10
    L += [(32, 96, 576, 1), (32, 1, 576, 3), (32, 576, 96, 1)] * 2  # block_11, 12
    L += [(32, 96, 576, 1)] + _head(32, 576)  # block_13_expand, head
    assert counts.mobilenet_v2_flops(500) == _sum(L)
    assert round(counts.mobilenet_v2_flops(500) / 1e9, 2) == 7.74
    assert round(counts.mobilenet_v2_flops(640) / 1e9, 2) == 12.17


def test_vgg16_500_by_hand():
    L = [(500, 3, 64, 3), (500, 64, 64, 3), (250, 64, 128, 3), (250, 128, 128, 3),
         (125, 128, 256, 3), (125, 256, 256, 3), (125, 256, 256, 3),
         (62, 256, 512, 3), (62, 512, 512, 3), (62, 512, 512, 3),
         (31, 512, 512, 3), (31, 512, 512, 3), (31, 512, 512, 3)] + _head(31, 512)
    assert counts.vgg16_flops(500) == _sum(L)
    assert round(counts.vgg16_flops(500) / 1e9, 1) == 156.6


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", harness.REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("batch,s", [(2, 32), (128, 32), (128, 40)])
def test_ir_stage_bound_as_chip_smoke(chip_smoke, batch, s):
    import tpurpn_torch as T
    from tpurpn_torch.kernels.ir_stage import pack_stage_weights

    hp = T.get_hyper_params("mobilenet_v2", img_size=64)
    model = T.fold_batch_norm(T.init_model(T.get_model(hp), device="cpu"))
    weights, blocks = pack_stage_weights(
        model.backbone, [f"block_{i}" for i in range(7, 13)], tail_expand="block_13_expand")
    x = torch.zeros((batch, s, s, 64), dtype=torch.bfloat16)
    assert chip_smoke.ir_stage_bound(x, weights, blocks) == counts.ir_stage_bound(batch, s)


@pytest.mark.parametrize("b,n,m", [(8, 8649, 8), (16, 14400, 64)])
def test_targets_bound_as_chip_smoke(chip_smoke, b, n, m):
    assert chip_smoke.targets_bound(b, n, m) == counts.targets_bound(b, n, m)


def test_proposal_bound_as_chip_smoke(chip_smoke):
    g = torch.Generator().manual_seed(3)
    B, N, pre, topn = 3, 2000, 1500, 100
    ctr = torch.rand((B, N, 2), generator=g)
    hw = torch.rand((B, N, 2), generator=g) * 0.3 + 0.02
    boxes = torch.cat([ctr - hw / 2, ctr + hw / 2], -1)
    scores = torch.rand((B, N), generator=g)
    want, _, _ = chip_smoke.proposal_bound(torch, boxes, scores, pre, topn, 0.7)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :pre]
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).numpy()
    walks = [counts.nms_walk_counts(geometry.greedy_nms(sb[i], 0.7, topn), topn)
             for i in range(B)]
    got = counts.proposal_bound(B, N, topn, sum(w[0] for w in walks), sum(w[1] for w in walks))
    assert np.isclose(got[0], want, rtol=1e-12)
