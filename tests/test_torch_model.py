"""MobileNetV2 RPN forward of the PyTorch port held against ``tpurpn``.

Seeded numpy weights (a flax variable tree with perturbed BN statistics, so
the fold does real work) go through ``tpurpn``'s flax model and, converted,
through the port on the CPU. Forwards agree at the bf16 tolerance of
tests/test_ir_stage.py (rel=0.02 of max(1, |ref|max)): both compute in bf16
but round at different places. The port's BN fold of the converted unfolded
weights equals ``tpurpn``'s folded weights exactly: both are the same eager
IEEE ops.
"""

import functools
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpurpn
from tpurpn.model import fold_batch_norm as j_fold_batch_norm
from tpurpn.model import get_model as j_get_model
import tpurpn_torch
from tpurpn_torch.convert import from_flax_variables
from tpurpn_torch.inference import fast_mobilenet_forward
from tpurpn_torch.model import fold_batch_norm, get_model, init_model

# 136 has odd stride-2 inputs (136 -> 68 -> 34 -> 17 -> 9): SAME pads (1, 1)
IMG_SIZES = (128, 136)


def close(a, b, rel=0.02):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=rel * scale, rtol=rel)


@functools.lru_cache(maxsize=None)
def flax_mobilenet(img: int, seed: int = 0):
    """(hp, flax model, unfolded numpy variables, folded model, folded
    numpy variables), weights drawn from ``seed`` with numpy."""
    hp = tpurpn.get_hyper_params("mobilenet_v2", img_size=img)
    model = j_get_model(hp)
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / math.sqrt(math.prod(s.shape[:-1]))
            v = rng.normal(0.0, std, s.shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:  # conv / BN bias, BN mean
            v = rng.normal(0.0, 0.1, s.shape)
        return v.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    fmodel, fvars = j_fold_batch_norm(hp, jax.tree_util.tree_map(jnp.asarray, variables))
    fvars = jax.tree_util.tree_map(np.asarray, fvars)
    return hp, model, variables, fmodel, fvars


def images(img: int, seed: int = 1, batch: int = 2) -> np.ndarray:
    """bf16-representable f32 images, so both sides see the same input."""
    x = np.random.default_rng(seed).uniform(0, 1, (batch, img, img, 3)).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def flax_forward(model, variables, x):
    fn = jax.jit(model.module.apply)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    return [np.asarray(o) for o in fn(jv, jnp.asarray(x).astype(jnp.bfloat16))]


def port(img, folded):
    hp, _, variables, _, fvars = flax_mobilenet(img)
    thp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=img)
    return from_flax_variables(thp, fvars if folded else variables, device="cpu")


def torch_images(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("img", IMG_SIZES)
def test_unfolded_forward_matches_flax(img):
    hp, model, variables, _, _ = flax_mobilenet(img)
    x = images(img)
    ref_reg, ref_cls = flax_forward(model, variables, x)
    with torch.no_grad():
        reg, cls = port(img, folded=False)(torch_images(x))
    fm = hp.feature_map_shape
    assert reg.shape == (2, fm, fm, 36) and cls.shape == (2, fm, fm, 9)
    assert reg.dtype == cls.dtype == torch.float32
    close(reg.numpy(), ref_reg)
    close(cls.numpy(), ref_cls)


@pytest.mark.parametrize("img", IMG_SIZES)
def test_folded_and_fast_forward_match_flax(img):
    _, _, _, fmodel, fvars = flax_mobilenet(img)
    x = images(img)
    ref_reg, ref_cls = flax_forward(fmodel, fvars, x)
    model = port(img, folded=True)
    with torch.no_grad():
        reg, cls = model(torch_images(x))
    close(reg.numpy(), ref_reg)
    close(cls.numpy(), ref_cls)
    reg, cls = fast_mobilenet_forward(model, torch_images(x))
    close(reg.numpy(), ref_reg)
    close(cls.numpy(), ref_cls)


def test_fold_batch_norm_matches_tpurpn_exactly():
    folded = fold_batch_norm(port(128, folded=False))
    ref = port(128, folded=True).state_dict()
    got = folded.state_dict()
    assert folded.fold_bn and got.keys() == ref.keys()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0, msg=k)


def test_converted_names_and_shapes_cover_the_flax_tree():
    _, _, variables, _, _ = flax_mobilenet(128)
    sd = port(128, folded=False).state_dict()
    kernel = variables["params"]["backbone"]["block_7"]["block_7_depthwise"]["kernel"]
    w = sd["backbone.block_7.block_7_depthwise.weight"]
    assert kernel.shape == (3, 3, 1, 384) and w.shape == (384, 1, 3, 3)
    np.testing.assert_array_equal(w.numpy()[:, 0], kernel[:, :, 0, :].transpose(2, 0, 1))
    mean = variables["batch_stats"]["backbone"]["bn_Conv1"]["mean"]
    np.testing.assert_array_equal(sd["backbone.bn_Conv1.running_mean"].numpy(), mean)
    n_flax = sum(1 for _ in jax.tree_util.tree_leaves(variables))
    n_port = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    assert n_flax == n_port


def test_init_model_is_seeded_and_flax_shaped():
    hp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=128)
    a = init_model(get_model(hp), torch.Generator().manual_seed(3), device="cpu")
    b = init_model(get_model(hp), torch.Generator().manual_seed(3), device="cpu")
    c = init_model(get_model(hp), torch.Generator().manual_seed(4), device="cpu")
    w = "backbone.block_7.block_7_expand.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    std = 1.0 / math.sqrt(64)  # lecun normal, fan_in 64, truncated at 2 sigma
    assert float(a.state_dict()[w].abs().max()) <= 2 * std / 0.87962566 + 1e-6
    assert not a.training
    ref_shapes = port(128, folded=False).state_dict()
    assert {k: v.shape for k, v in a.state_dict().items()} == {
        k: v.shape for k, v in ref_shapes.items()
    }
