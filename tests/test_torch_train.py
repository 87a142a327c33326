"""The port's training step held against ``tpurpn``'s.

One train step per backbone from the same weights (a ``tpurpn`` train state
carried over by ``convert.from_flax_variables``) on the same batch (the two
packages' ``SyntheticVOC`` give the same samples), with ``tpurpn``'s random
draws replayed: the flip mask and the selection words of
``fold_in(key, step)``. At f32 compute the losses and metrics agree within
rel 1e-5, the updated parameters and BatchNorm statistics within rtol 1e-4
(atol 1e-6): the convolutions sum in other orders. MobileNetV2's updates are
held per parameter, relative to the parameter's own gradient (see its
test), and planted faults show that check fails. A bf16 step agrees within rel
0.02. The rest: exact gradient accumulation, the BatchNorm running variance
against flax's, VGG16 weight conversion both ways, the losses, the eval loss
and the dataset. The ``tpurpn`` states and steps are built once per
configuration and shared by the tests.
"""

import copy
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
import torch.nn.functional as F
from torch import nn

import tpurpn
import tpurpn.data as j_data
import tpurpn.losses as j_losses
import tpurpn.model as j_model
import tpurpn.target as j_target
import tpurpn.train as j_train
import tpurpn_torch
from tpurpn_torch import data, losses, train
from tpurpn_torch.backbones.mobilenet_v2 import BatchNorm
from tpurpn_torch.convert import from_flax_variables, to_flax_numpy


def hp_pair(backbone="vgg16", dtype="float32"):
    kw = dict(img_size=64, compute_dtype=dtype, max_gt_boxes=8,
              total_pos_bboxes=16, total_neg_bboxes=16)
    return (tpurpn.get_hyper_params(backbone, **kw),
            tpurpn_torch.get_hyper_params(backbone, **kw))


@functools.lru_cache(maxsize=None)
def batch(B=8, seed=0):
    ds = j_data.SyntheticVOC(num_samples=B, raw_h=72, raw_w=96, seed=seed)
    return next(ds.batches(B, native=False))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


@functools.lru_cache(maxsize=None)
def jax_state(backbone):
    """tpurpn's initial train state and its variables as numpy (f32 at
    either compute dtype; jitted, the same values as eager and faster).
    The steps donate their state, so callers step a copy."""
    init = jax.jit(functools.partial(j_train.create_train_state, hp_pair(backbone)[0]))
    state = init(jax.random.key(0))
    variables = {"params": to_numpy(state.params)}
    if j_train._has_batch_stats(state):
        variables["batch_stats"] = to_numpy(state.batch_stats)
    return state, variables


def replayed_draws(jhp, key, step, B):
    """tpurpn's per-step draws: the flip mask and the selection words."""
    prep_key, target_key = jax.random.split(jax.random.fold_in(key, step))
    flip = np.array(jax.random.bernoulli(prep_key, 0.5, (B,)))
    bits = np.array(j_target.target_rand_bits(target_key, B, jhp.total_anchors))
    return torch.from_numpy(flip), torch.from_numpy(bits)


@functools.lru_cache(maxsize=None)
def jax_step(backbone, dtype="float32", augment=True):
    """One tpurpn step from ``jax_state``: (new state, metrics, flip, words)."""
    jhp, _ = hp_pair(backbone, dtype)
    imgs, boxes, labels = batch()
    state = jax.tree_util.tree_map(jnp.copy, jax_state(backbone)[0])
    key = jax.random.key(42)
    jstate, jm = j_train.make_train_step(jhp, augment=augment)(
        state, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(labels), key)
    return (jstate, jm) + replayed_draws(jhp, key, 0, imgs.shape[0])


def run_both(backbone, dtype="float32", augment=True, prepare=None):
    """One tpurpn step and one port step from the same state and batch;
    ``prepare(model)`` may alter the port's model before its step."""
    _, thp = hp_pair(backbone, dtype)
    imgs, boxes, labels = batch()
    jstate, jm, flip, bits = jax_step(backbone, dtype, augment)
    model = from_flax_variables(thp, jax_state(backbone)[1], device="cpu")
    if prepare is not None:
        prepare(model)
    state = train.create_train_state(thp, model=model)
    state, m = train.make_train_step(thp, augment=augment)(
        state, torch.from_numpy(imgs), torch.from_numpy(boxes), torch.from_numpy(labels),
        flip=flip if augment else None, rand_bits=bits)
    return jstate, jm, state, m


def assert_metrics_close(m, jm, rel):
    assert int(m["num_pos"]) == int(jm["num_pos"])
    for k in ("loss", "reg_loss", "cls_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rel, err_msg=k)


def assert_trees_close(got, ref, rtol=1e-4, atol=1e-6):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_g) == len(flat_r)
    for path, g in flat_g:
        np.testing.assert_allclose(g, np.asarray(flat_r[path]), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_vgg16_step_matches_tpurpn():
    jstate, jm, state, m = run_both("vgg16")
    assert_metrics_close(m, jm, 1e-5)
    assert state.step == 1 and int(jstate.step) == 1
    assert not state.model.training
    assert_trees_close(to_flax_numpy(state.model)["params"], jstate.params)


def port_grads(state):
    """The port step's gradients in the flax layout: SGD's momentum buffers
    after a first step are the gradients (optax's trace is the same)."""
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for p, q in zip(state.model.parameters(), model.parameters()):
            q.copy_(state.optimizer.state[p]["momentum_buffer"])
    return to_flax_numpy(model)["params"]


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


GRAD_RTOL = 0.25


def _check_grads(got, ref):
    """Each gradient against its own size, ||g_port - g_tpurpn|| / ||g_tpurpn||.
    The project BatchNorms' biases are zero in exact arithmetic (a channel's
    shift goes linearly through the next 1x1 conv, and residual adds, into a
    train-mode BatchNorm, which takes it out); both packages give them
    rounding noise, held under 1e-5 of the largest gradient instead."""
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    top = max(_rms(r) for _, r in flat_r)
    ratio, noise = {}, {}
    for path, r in flat_r:
        g, name = flat_g[path], jax.tree_util.keystr(path)
        if path[-2].key.endswith("_project_BN") and path[-1].key == "bias":
            noise[name] = max(_rms(g), _rms(r)) / top
        else:
            d = np.asarray(g, np.float64) - np.asarray(r, np.float64)
            ratio[name] = np.linalg.norm(d) / np.linalg.norm(np.asarray(r, np.float64))
    assert len(noise) == 13 and max(noise.values()) < 1e-5, noise
    worst = max(ratio, key=ratio.get)
    assert ratio[worst] < GRAD_RTOL, (worst, ratio[worst])


def check_mobilenet_step(jstate, jm, state, m):
    """The three checks of a MobileNetV2 step, by name, each None if it
    passes or the AssertionError it raised."""
    tree = to_flax_numpy(state.model)
    results = {}
    for name, check in (
        ("metrics", lambda: assert_metrics_close(m, jm, 1e-5)),
        ("batch_stats", lambda: assert_trees_close(tree["batch_stats"], jstate.batch_stats)),
        ("grads", lambda: _check_grads(port_grads(state), jstate.opt_state[0].trace)),
    ):
        try:
            check()
            results[name] = None
        except AssertionError as e:
            results[name] = e
    return results


def test_mobilenet_v2_step_matches_tpurpn_in_bn_train_mode():
    """Losses and BatchNorm statistics (forward quantities) as VGG16's. The
    gradients are held per parameter against their own size, within 25 %
    (the measured worst is 9 %, a BatchNorm scale in block_3; the median
    3 %), not elementwise: the gradients of this f32 step move by as much
    when only the summation order changes. The port against itself run on
    one CPU thread differs by up to 6.6 % (median 4 %); against itself with
    the weights perturbed by 1e-6 relative, by up to 1 %. The update is the
    same SGD step as VGG16's, held there at rtol 1e-4."""
    jstate, jm, state, m = run_both("mobilenet_v2")
    results = check_mobilenet_step(jstate, jm, state, m)
    for name, err in results.items():
        assert err is None, (name, err)
    init = jax_state("mobilenet_v2")[1]["batch_stats"]["backbone"]["bn_Conv1"]["var"]
    tree = to_flax_numpy(state.model)
    assert not np.allclose(tree["batch_stats"]["backbone"]["bn_Conv1"]["var"], init)


def _zero_bn_grads(model):
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            for p in (mod.weight, mod.bias):
                p.register_hook(torch.zeros_like)


def _bn_stats_as_constants(self, x):
    """Train-mode BatchNorm whose backward misses the batch statistics."""
    xf = x.float()
    with torch.no_grad():
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        m = self.bn_momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
    return F.batch_norm(xf, mean, var, self.weight, self.bias, False, 0.0, self.eps).to(x.dtype)


@pytest.mark.parametrize("fault, caught_by", [
    ("bn_grads_zeroed", "grads"),
    ("bn_stats_constant_in_backward", "grads"),
    ("torch_unbiased_running_var", "batch_stats"),
])
def test_mobilenet_v2_step_check_catches_planted_faults(fault, caught_by, monkeypatch):
    """Each planted fault fails exactly the check that should see it: a
    BatchNorm backward fault leaves the losses and statistics alone and
    fails the per-parameter gradient check."""
    prepare = None
    if fault == "bn_grads_zeroed":
        prepare = _zero_bn_grads
    elif fault == "bn_stats_constant_in_backward":
        monkeypatch.setattr(BatchNorm, "forward", _bn_stats_as_constants)
    else:  # torch's own train mode: stores the unbiased variance
        monkeypatch.setattr(BatchNorm, "forward",
                            lambda self, x: nn.BatchNorm2d.forward(self, x.float()).to(x.dtype))
    results = check_mobilenet_step(*run_both("mobilenet_v2", prepare=prepare))
    assert {n for n, e in results.items() if e is not None} == {caught_by}


def test_bf16_step_matches_tpurpn():
    _, jm, _, m = run_both("vgg16", dtype="bfloat16", augment=False)
    assert_metrics_close(m, jm, 0.02)


def test_grad_accum_equals_the_full_batch():
    _, thp = hp_pair("vgg16")
    imgs, boxes, labels = (torch.from_numpy(a) for a in batch())
    rand = train.target_rand_bits(torch.Generator().manual_seed(3), 8, thp.total_anchors)
    states, metrics = [], []
    for n in (1, 2):
        model = tpurpn_torch.init_model(tpurpn_torch.get_model(thp),
                                        torch.Generator().manual_seed(0), device="cpu")
        state = train.create_train_state(thp, model=model)
        state, m = train.make_train_step(thp, augment=False, grad_accum=n)(
            state, imgs, boxes, labels, rand_bits=rand)
        states.append(state)
        metrics.append(m)
    assert int(metrics[0]["num_pos"]) == int(metrics[1]["num_pos"])
    for k in ("loss", "reg_loss", "cls_loss"):
        torch.testing.assert_close(metrics[1][k], metrics[0][k], rtol=1e-5, atol=0)
    for (name, a), b in zip(states[0].model.state_dict().items(),
                            states[1].model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7, msg=name)
    with pytest.raises(ValueError, match="divisible"):
        train.make_train_step(thp, augment=False, grad_accum=3)(
            states[0], imgs, boxes, labels, rand_bits=rand)
    with pytest.raises(ValueError, match="grad_accum"):
        train.make_train_step(thp, grad_accum=0)


@pytest.mark.parametrize("x", [[0.0, 2.0], "random"])
def test_bn_running_variance_is_biased_as_flax(x):
    """torch's BatchNorm2d stores the unbiased batch variance; flax (and the
    port) the biased one: on [0, 2] with full momentum, 1.0 and not 2.0."""
    if x == "random":
        arr = np.random.default_rng(0).normal(1.0, 2.0, (4, 5, 5, 3)).astype(np.float32)
        momentum = 0.9
    else:
        arr = np.array(x, np.float32).reshape(2, 1, 1, 1)
        momentum = 0.0
    C = arr.shape[-1]
    scale = np.linspace(0.5, 1.5, C).astype(np.float32)
    bias = np.linspace(-0.2, 0.2, C).astype(np.float32)
    mean0 = np.linspace(-0.1, 0.1, C).astype(np.float32)
    var0 = np.linspace(0.8, 1.2, C).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-3)
    y_ref, upd = flax_bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(arr), mutable=["batch_stats"])
    bn = BatchNorm(C, bn_momentum=momentum)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    y = bn(torch.from_numpy(arr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-6)
    for got, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(got.numpy(), np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-7)
    if momentum == 0.0:
        assert float(bn.running_var[0]) == 1.0
    bn.eval()  # eval normalizes with the running statistics
    y_eval = bn(torch.from_numpy(arr).permute(0, 3, 1, 2))
    expect = ((torch.from_numpy(arr).permute(0, 3, 1, 2) - bn.running_mean[:, None, None])
              / torch.sqrt(bn.running_var[:, None, None] + 1e-3) * bn.weight[:, None, None]
              + bn.bias[:, None, None])
    torch.testing.assert_close(y_eval, expect.detach(), rtol=1e-5, atol=1e-6)


def test_vgg16_weights_convert_both_ways():
    jhp, thp = hp_pair("vgg16")
    jstate, variables = jax_state("vgg16")
    model = from_flax_variables(thp, variables, device="cpu")
    assert not model.fold_bn and tpurpn_torch.fold_batch_norm(model) is model
    back = to_flax_numpy(model)
    assert back.keys() == {"params"}
    assert_trees_close(back["params"], variables["params"], rtol=0, atol=0)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = j_model.get_model(jhp).module.apply({"params": jstate.params}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got[0].shape == (2, 4, 4, 36) and got[1].shape == (2, 4, 4, 9)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_losses_match_tpurpn(rng):
    t = np.zeros((2, 4, 4, 36), np.float32)
    t[:, 1, 2, :8] = rng.normal(0, 1, (2, 8))
    p = rng.normal(0, 1, (2, 4, 4, 36)).astype(np.float32)
    lab = rng.choice([-1.0, 0.0, 1.0], (2, 4, 4, 9)).astype(np.float32)
    logits = rng.normal(0, 2, (2, 4, 4, 9)).astype(np.float32)
    logits[0, 0, 0, :3] = 0.0  # the max(x, 0) tie
    pairs = [
        (losses.reg_loss(torch.from_numpy(t), torch.from_numpy(p)), j_losses.reg_loss(t, p)),
        (losses.rpn_cls_loss(torch.from_numpy(lab), torch.from_numpy(logits)),
         j_losses.rpn_cls_loss(lab, logits)),
        (losses.rpn_cls_loss_probs(torch.from_numpy(lab), torch.sigmoid(torch.from_numpy(logits))),
         j_losses.rpn_cls_loss_probs(lab, jax.nn.sigmoid(logits))),
        (losses.reg_pos_count(torch.from_numpy(t)), j_losses.reg_pos_count(t)),
        (losses.cls_valid_count(torch.from_numpy(lab)), j_losses.cls_valid_count(lab)),
        (losses.huber(torch.from_numpy(p)), j_losses.huber(p)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    x = torch.from_numpy(logits).requires_grad_()
    losses.rpn_cls_loss(torch.from_numpy(lab), x).backward()
    ref_g = jax.grad(lambda z: j_losses.rpn_cls_loss(lab, z))(logits)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-7)


def test_eval_loss_matches_tpurpn():
    jhp, thp = hp_pair("mobilenet_v2")
    imgs, boxes, labels = batch()
    jstate, variables = jax_state("mobilenet_v2")
    key = jax.random.key(9)
    ref = j_train.make_eval_loss_fn(jhp)(jstate, jnp.asarray(imgs), jnp.asarray(boxes),
                                         jnp.asarray(labels), key)
    bits = torch.from_numpy(np.array(j_target.target_rand_bits(key, 8, jhp.total_anchors)))
    state = train.create_train_state(
        thp, model=from_flax_variables(thp, variables, device="cpu"))
    got = train.make_eval_loss_fn(thp)(state, torch.from_numpy(imgs), torch.from_numpy(boxes),
                                       torch.from_numpy(labels), rand_bits=bits)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_synthetic_voc_and_batch_walk_match_tpurpn():
    ref_ds = j_data.SyntheticVOC(num_samples=6, raw_h=40, raw_w=56, seed=3)
    ds = data.SyntheticVOC(num_samples=6, raw_h=40, raw_w=56, seed=3)
    # both packages' defaults (the native generator) and their Python samplers
    for native in (None, False):
        for got, ref in zip(ds.batches(2, shuffle=5, native=native),
                            ref_ds.batches(2, shuffle=5, native=native)):
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
    walk = data.batch_index_iter(7, 3, repeat=True, shuffle=1)
    ref_walk = j_data.batch_index_iter(7, 3, repeat=True, shuffle=1)
    for _ in range(5):
        np.testing.assert_array_equal(next(walk), next(ref_walk))
    assert data.VOC_CLASSES == j_data.VOC_CLASSES


def test_rpn_generator_and_step_size():
    _, thp = hp_pair("vgg16")
    anchors = tpurpn_torch.generate_anchors(thp)
    ds = data.SyntheticVOC(num_samples=4, raw_h=40, raw_w=56)
    gen = train.rpn_generator(ds, anchors, thp, torch.Generator().manual_seed(0), batch_size=2)
    for _ in range(3):  # repeats past the end of the dataset
        images, (deltas, labels) = next(gen)
    assert images.shape == (2, 64, 64, 3) and deltas.shape == (2, 4, 4, 36)
    assert labels.shape == (2, 4, 4, 9)
    assert train.get_step_size(10, 4) == j_train.get_step_size(10, 4) == 3


def test_generator_draws_make_training_reproducible():
    _, thp = hp_pair("vgg16")
    imgs, boxes, labels = (torch.from_numpy(a) for a in batch())
    losses_by_seed = []
    for seed in (1, 1, 2):
        model = tpurpn_torch.init_model(tpurpn_torch.get_model(thp),
                                        torch.Generator().manual_seed(0), device="cpu")
        state = train.create_train_state(thp, model=model)
        _, m = train.make_train_step(thp)(state, imgs, boxes, labels,
                                          torch.Generator().manual_seed(seed))
        losses_by_seed.append(float(m["loss"]))
    assert losses_by_seed[0] == losses_by_seed[1] != losses_by_seed[2]
    with pytest.raises(ValueError, match="generator"):
        train.make_train_step(thp)(state, imgs, boxes, labels)
