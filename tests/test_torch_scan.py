"""``make_scan_train_steps`` on the CPU (the eager loop) against a host loop
of ``make_train_step`` with the same generator over the same rows, bit for
bit: per-step metrics, the state's tensors and the generator's state after.
Chunked calls resume the walk, ``sample_idx`` replays a shuffled host loop,
``start_step`` overrides ``state.step``, and the refusals are ``tpurpn``'s.
Last, three steps against ``tpurpn.make_scan_train_steps`` with its per-step
draws replayed (``split(key)`` a step, then ``fold_in(sk, step)``), within
``tests/test_torch_train.py``'s VGG16 step tolerance (losses rel 1e-5,
parameters rtol 1e-4 atol 1e-6). The card's CUDA-graph route is held
against the eager loop by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import tpurpn_torch
from tpurpn_torch import train
from tpurpn_torch.data import SyntheticVOC, batch_index_iter

HP_KW = dict(img_size=64, compute_dtype="float32", max_gt_boxes=8,
             total_pos_bboxes=16, total_neg_bboxes=16)


def _hp(backbone="vgg16"):
    return tpurpn_torch.get_hyper_params(backbone, **HP_KW)


def _state(backbone="vgg16"):
    model = tpurpn_torch.init_model(tpurpn_torch.get_model(_hp(backbone)),
                                    torch.Generator().manual_seed(0), device="cpu")
    return train.create_train_state(_hp(backbone), model=model)


def _data(n=8):
    return tuple(torch.from_numpy(a) for a in next(
        SyntheticVOC(num_samples=n, raw_h=72, raw_w=96, seed=3).batches(n)))


def _host_loop(backbone, rows, augment=True):
    """make_train_step over the given rows, generator seeded 1."""
    imgs, boxes, labels = _data()
    state, gen = _state(backbone), torch.Generator().manual_seed(1)
    step = train.make_train_step(_hp(backbone), augment=augment)
    metrics = []
    for r in rows:
        state, m = step(state, imgs[r], boxes[r], labels[r], gen)
        metrics.append(m)
    return state, gen, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def _assert_same(a, b):
    (sa, ga, ma), (sb, gb, mb) = a, b
    assert sa.step == sb.step
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (name, x), y in zip(sa.model.state_dict().items(), sb.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.parametrize("backbone", ["vgg16", "mobilenet_v2"])
def test_scan_equals_the_host_loop(backbone):
    """6 steps over 2 batches: the walk wraps three times."""
    rows = [np.arange(4) + (s * 4) % 8 for s in range(6)]
    state, gen = _state(backbone), torch.Generator().manual_seed(1)
    run = train.make_scan_train_steps(_hp(backbone), batch_size=4, num_steps=6)
    state, metrics = run(state, gen, *_data())
    assert metrics["loss"].shape == (6,) and metrics["num_pos"].dtype == torch.int64
    _assert_same(_host_loop(backbone, rows), (state, gen, metrics))


def test_chunked_calls_resume_the_walk():
    rows = [np.arange(4) + (s * 4) % 8 for s in range(5)]
    state, gen = _state(), torch.Generator().manual_seed(1)
    parts = []
    for k in (2, 3):  # the second call starts at row (2 * 4) % 8 = 0, step 2
        state, m = train.make_scan_train_steps(_hp(), batch_size=4, num_steps=k)(
            state, gen, *_data())
        parts.append(m)
    metrics = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    _assert_same(_host_loop("vgg16", rows), (state, gen, metrics))


def test_sample_idx_replays_the_shuffled_host_loop():
    """batch_index_iter rows (an epoch boundary crossed) == the host loop
    over ``SyntheticVOC.batches(shuffle=7)``, which walks the same rows."""
    it = batch_index_iter(8, 4, repeat=True, shuffle=7)
    rows = np.stack([next(it) for _ in range(5)])
    ds = SyntheticVOC(num_samples=8, raw_h=72, raw_w=96, seed=3)
    batches = ds.batches(4, repeat=True, shuffle=7)
    imgs, _, _ = _data()
    for r in rows:
        assert torch.equal(torch.from_numpy(next(batches)[0]), imgs[r])
    state, gen = _state(), torch.Generator().manual_seed(1)
    run = train.make_scan_train_steps(_hp(), batch_size=4, num_steps=5)
    state, metrics = run(state, gen, *_data(), torch.from_numpy(rows))
    _assert_same(_host_loop("vgg16", rows), (state, gen, metrics))


def test_start_step_overrides_state_step():
    origin = 5
    rows = np.stack([((origin + s) * 4) % 8 + np.arange(4) for s in range(3)])
    run = train.make_scan_train_steps(_hp(), augment=False, batch_size=4, num_steps=3)
    state = _state()
    state.step = 1  # ignored: start_step pins the walk
    a = run(state, torch.Generator().manual_seed(1), *_data(), start_step=origin)
    b = run(_state(), torch.Generator().manual_seed(1), *_data(), rows)
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k])
    assert a[0].step == 4 and b[0].step == 3
    for x, y in zip(a[0].model.parameters(), b[0].model.parameters()):
        assert torch.equal(x, y)


def test_refusals():
    run = train.make_scan_train_steps(_hp(), augment=False, batch_size=4, num_steps=2)
    ragged = tuple(t[:6] for t in _data())
    with pytest.raises(ValueError, match="dataset size 6 not divisible by batch_size 4"):
        run(_state(), torch.Generator(), *ragged)
    with pytest.raises(ValueError, match="sample_idx shape"):
        run(_state(), torch.Generator(), *ragged, np.zeros((3, 4), np.int64))
    with pytest.raises(ValueError, match="mutually exclusive"):
        run(_state(), torch.Generator(), *ragged, np.zeros((2, 4), np.int64), 0)
    with pytest.raises(ValueError, match="outside the dataset's 6 rows"):
        run(_state(), torch.Generator(), *ragged, np.full((2, 4), 6, np.int64))
    for b, k in ((0, 2), (4, 0)):
        with pytest.raises(ValueError, match=">= 1"):
            train.make_scan_train_steps(_hp(), batch_size=b, num_steps=k)
    # explicit rows lift the divisibility requirement (6 % 4 != 0)
    state, metrics = run(_state(), torch.Generator().manual_seed(1), *ragged,
                         np.array([[0, 1, 2, 3], [4, 5, 0, 1]]))
    assert state.step == 2 and metrics["loss"].shape == (2,)


def test_scan_matches_tpurpn_scan_with_replayed_draws(monkeypatch):
    import jax
    import jax.numpy as jnp

    import tpurpn
    import tpurpn.target as j_target
    import tpurpn.train as j_train
    from tpurpn_torch.convert import from_flax_variables, to_flax_numpy

    jhp = tpurpn.get_hyper_params("vgg16", **HP_KW)
    n_steps, key = 3, jax.random.key(1)
    imgs, boxes, labels = _data()
    jstate = j_train.create_train_state(jhp, jax.random.key(0))
    variables = {"params": jax.tree_util.tree_map(np.array, jstate.params)}
    model = from_flax_variables(_hp(), variables, device="cpu")
    jstate, _, jm = j_train.make_scan_train_steps(jhp, batch_size=4, num_steps=n_steps)(
        jstate, key, *(jnp.asarray(t.numpy()) for t in (imgs, boxes, labels)))

    # tpurpn's draws: key, sk = split(key) a step; fold_in(sk, step) inside it
    replayed = []
    for s in range(n_steps):
        key, sk = jax.random.split(key)
        prep_key, target_key = jax.random.split(jax.random.fold_in(sk, s))
        replayed.append((torch.from_numpy(np.array(jax.random.bernoulli(prep_key, 0.5, (4,)))),
                         torch.from_numpy(np.array(j_target.target_rand_bits(
                             target_key, 4, jhp.total_anchors)))))
    monkeypatch.setattr(train._Step, "draws", lambda self, *a: replayed.pop(0))
    state = train.create_train_state(_hp(), model=model)
    state, metrics = train.make_scan_train_steps(_hp(), batch_size=4, num_steps=n_steps)(
        state, torch.Generator(), imgs, boxes, labels)
    assert not replayed and state.step == n_steps
    np.testing.assert_array_equal(metrics["num_pos"].numpy(), np.asarray(jm["num_pos"]))
    for k in ("loss", "reg_loss", "cls_loss"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    got = to_flax_numpy(state.model)["params"]
    flat = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    for path, ref in flat:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, np.asarray(ref), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
