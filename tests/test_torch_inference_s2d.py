"""The port's space-to-depth uint8 serving stem against ``tpurpn``'s
(``tpurpn/inference.py``), with ``tpurpn``'s own tolerances
(``tests/test_inference_s2d.py``): ``s2d_resize`` within 2e-6 in f32 and
4e-3 in bf16, ``fold_conv1_s2d`` exactly, ``s2d_uint8_stem`` and
``fast_uint8_forward(fused_stage=False)`` within 0.05 * max(scale, 1) of the
reference's. Then the routing of ``make_predict_fn(fast=True,
from_uint8=True)`` on the CPU (the IR stage's plain version): through
``fast_uint8_forward`` exactly where ``s2d_stem_supported`` holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurpn.inference as j_inf
import tpurpn.model as j_model
import tpurpn_torch
from tpurpn import get_hyper_params as j_hp
from tpurpn.data import SyntheticVOC
from tpurpn_torch import inference
from tpurpn_torch.convert import from_flax_variables


def _raw(batch=2, h=375, w=500):
    return next(SyntheticVOC(num_samples=batch, raw_h=h, raw_w=w).batches(batch))[0]


def _folded_pair(img_size):
    """tpurpn's folded MobileNetV2 (random init, BN statistics drawn away from
    identity so the fold does work) and the port's model of it."""
    hp = j_hp("mobilenet_v2", img_size=img_size)
    variables = j_model.init_model(j_model.get_model(hp), jax.random.key(0))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), variables["batch_stats"])
    model, folded = j_model.fold_batch_norm(hp, {"params": variables["params"],
                                                 "batch_stats": stats})
    np_tree = {"params": jax.tree_util.tree_map(np.array, folded["params"])}
    thp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=img_size)
    return hp, model, folded, from_flax_variables(thp, np_tree, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(375, 500, 500), (96, 120, 128)])
def test_s2d_resize_matches_tpurpn(dtype, shape):
    h, w, out = shape
    raw = _raw(h=h, w=w)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = j_inf.s2d_resize(jnp.asarray(raw).astype(jd) / jnp.asarray(255.0, jd), out)
    x = torch.from_numpy(raw).to(td) / torch.full((), 255.0, dtype=td)
    got = inference.s2d_resize(x, out)
    assert got.shape == (2, out // 2, out // 2, 12) and got.dtype == td
    err = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= (4e-3 if dtype == "bfloat16" else 2e-6), err


def test_s2d_resize_rejects_downsampling_and_odd_sizes():
    with pytest.raises(AssertionError, match="upsampling"):
        inference.s2d_resize(torch.zeros((1, 600, 600, 3)), 500)
    with pytest.raises(AssertionError, match="even"):
        inference.s2d_resize(torch.zeros((1, 60, 60, 3)), 125)
    hp = tpurpn_torch.get_hyper_params("mobilenet_v2")
    assert inference.s2d_stem_supported(hp, (8, 375, 500, 3))
    assert not inference.s2d_stem_supported(hp, (8, 600, 500, 3))
    assert not inference.s2d_stem_supported(
        tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=125), (8, 100, 100, 3))


def test_fold_conv1_s2d_is_tpurpns_exactly():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)  # HWIO
    b = rng.normal(size=(8,)).astype(np.float32)
    ref_w, ref_b = j_inf.fold_conv1_s2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)})
    got_w, got_b = inference.fold_conv1_s2d(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                            torch.from_numpy(b))
    np.testing.assert_array_equal(got_w.numpy().transpose(2, 3, 1, 0), np.asarray(ref_w))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(ref_b))
    # and the fold is the strided conv: 3x3/s2 SAME == 2x2/s1 over s2d input
    x = torch.from_numpy(rng.normal(size=(2, 3, 20, 20)).astype(np.float32))
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    ref = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (0, 1, 0, 1)), tw,
                                     torch.from_numpy(b), stride=2)
    s2d = torch.cat([x[:, :, p::2, q::2] for p in (0, 1) for q in (0, 1)], dim=1)
    got = torch.nn.functional.conv2d(torch.nn.functional.pad(s2d, (0, 1, 0, 1)), got_w, got_b)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _close(got, ref):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 0.05 * max(scale, 1.0), (err, scale)


def test_s2d_uint8_stem_matches_tpurpn():
    hp, _, folded, model = _folded_pair(500)
    raw = _raw()
    ref = j_inf.s2d_uint8_stem(hp, folded, jnp.asarray(raw))
    with torch.no_grad():
        got = inference.s2d_uint8_stem(model, torch.from_numpy(raw))
    assert got.shape == (2, 250, 250, 32) and got.dtype == torch.bfloat16
    _close(got, ref)


def test_fast_uint8_forward_matches_tpurpn():
    hp, _, folded, model = _folded_pair(128)
    raw = _raw(h=96, w=120)
    ref = j_inf.fast_uint8_forward(hp, folded, jnp.asarray(raw), fused_stage=False)
    got = inference.fast_uint8_forward(model, torch.from_numpy(raw), fused_stage=False)
    for g, r in zip(got, ref):  # both heads: a broken reg branch would pass on cls
        _close(g, r)


@pytest.mark.parametrize("raw_hw, routed", [((96, 120), True), ((150, 120), False)])
def test_predict_routes_uint8_frames_through_the_s2d_stem(raw_hw, routed, monkeypatch):
    """make_predict_fn(fast=True, from_uint8=True) takes the s2d stem exactly
    where s2d_stem_supported holds; both routes give proposals of the same
    shapes, and the stem's head outputs stay within bf16 tolerance of
    preprocess_batch + fast_mobilenet_forward."""
    _, _, _, model = _folded_pair(128)
    thp = model.hp
    raw = torch.from_numpy(_raw(h=raw_hw[0], w=raw_hw[1]))
    calls = []
    real = inference.fast_uint8_forward
    monkeypatch.setattr(inference, "fast_uint8_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = tpurpn_torch.make_predict_fn(model, thp, fast=True, from_uint8=True,
                                       device="cpu")(raw)
    assert len(calls) == int(routed)
    assert out["roi_boxes"].shape == (2, 300, 4) and out["num_valid"].shape == (2,)
    if routed:
        from tpurpn_torch.data import preprocess_batch

        x, _ = preprocess_batch(raw, torch.zeros((2, 1, 4)), thp.img_size, dtype=torch.bfloat16)
        for g, r in zip(real(model, raw), inference.fast_mobilenet_forward(model, x)):
            _close(g, r.numpy())
