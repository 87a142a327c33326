"""The port's data-parallel paths on two CPU ranks (gloo), held against
the single-device port and against ``tpurpn``'s GSPMD mesh.

One spawn of two rank processes (this file run as a script, a file-store
rendezvous, ``OMP_NUM_THREADS=1`` each; the ranks import only the port) runs
every mesh-side check and writes its results; the tests read them. The
parent process computes the single-device port results and ``tpurpn``'s
``make_train_step(mesh=make_data_mesh(2))`` / ``make_eval_loss_fn(mesh=...)``
on conftest's virtual CPU devices, from the same weights (``tpurpn``'s init,
converted), the same batch and ``tpurpn``'s draws replayed (the global flip
mask and words of ``fold_in(key, step)``).

Tolerances at f32 (img 64): loss rtol 1e-5 and ``num_pos`` exact
everywhere. VGG16's updated parameters within atol 1e-6 of the
single-device port's and as ``tests/test_torch_train.py`` holds its
single-device step against ``tpurpn`` (rtol 1e-4, atol 1e-6). MobileNetV2's
BatchNorm statistics within rtol 1e-4 atol 1e-6 of both. Its updated
parameters within atol ``MOBILENET_PARAM_ATOL`` of the single-device port's,
computed on one thread as the ranks run: the two differ by 9.8e-5 at most
(the first blocks' kernels, whose update is about 1e-3: round-off that
the small maps' BatchNorms amplify; relu6 masks flip), the same size as the
single-device step's own gap between 1 and 8 threads. Two wrong reductions
fail that limit (``test_mesh_step_limit_fails_wrong_reductions``). Against
``tpurpn``'s mesh step, whose convolutions sum in XLA's order, each gradient
within 25 % of its own size, as ``tests/test_torch_train.py`` holds the
single-device step. The cross-rank BatchNorm itself is held in f64 against
torch's full-batch BatchNorm, outputs and gradients within 1e-10. The mesh
predict is bit-equal to the single-device one, and so is the mesh scan to a
host loop of the mesh step over the same global rows.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpurpn_torch
from tpurpn_torch import train
from tpurpn_torch.data import SyntheticVOC, sharded_batch_index_iter

WORLD = 2
HP_KW = dict(img_size=64, compute_dtype="float32", max_gt_boxes=8,
             total_pos_bboxes=16, total_neg_bboxes=16)
BACKBONES = ("vgg16", "mobilenet_v2")
# twice the mesh step's largest gap to the single-device step (9.8e-5), a
# sixth of averaging the ranks' gradients (5.9e-4)
MOBILENET_PARAM_ATOL = 2e-4


def _hp(backbone):
    return tpurpn_torch.get_hyper_params(backbone, **HP_KW)


def _model(backbone, state_dict):
    model = tpurpn_torch.get_model(_hp(backbone))
    model.load_state_dict(state_dict)
    return tpurpn_torch.model.to_device(model, "cpu")


def _state(backbone, state_dict):
    return train.create_train_state(_hp(backbone), model=_model(backbone, state_dict))


def _tensors(state):
    """Parameters, buffers and SGD momentum (the summed gradients after a
    first step), by name."""
    out = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"grad:{name}"] = buf.clone()
    return out


def _scan_vs_host_loop(mesh, sd, data, shuffle):
    """A scanned mesh call over this rank's shard against a host loop of the
    mesh step over the same global rows (losses and tensors, bit for bit)."""
    hp = _hp("vgg16")
    imgs, boxes, labels = data
    n, batch, steps = imgs.shape[0], 8, 5
    it = sharded_batch_index_iter(n, batch, WORLD, repeat=True, shuffle=shuffle)
    rows = np.stack([next(it) for _ in range(steps)])
    state_a, gen_a = _state("vgg16", sd), torch.Generator().manual_seed(1)
    step = train.make_train_step(hp, mesh=mesh)
    losses_a = []
    for sel in rows:
        state_a, m = step(state_a, *train.shard_batch(mesh, imgs[sel], boxes[sel], labels[sel]),
                          gen_a)
        losses_a.append(m["loss"])
    state_b, gen_b = _state("vgg16", sd), torch.Generator().manual_seed(1)
    run = train.make_scan_train_steps(hp, batch_size=batch, num_steps=steps, mesh=mesh)
    state_b, mb = run(state_b, gen_b, *train.shard_batch(mesh, imgs, boxes, labels),
                      None if shuffle is None else rows)
    same = all(torch.equal(a, b) for a, b in zip(_tensors(state_a).values(),
                                                  _tensors(state_b).values()))
    return {"host_losses": torch.stack(losses_a), "scan_losses": mb["loss"],
            "same_tensors": same, "steps": (state_a.step, state_b.step),
            "same_generator": torch.equal(gen_a.get_state(), gen_b.get_state())}


def _errors(mesh, sd, data):
    """The messages of the mesh paths' refusals."""
    hp = _hp("vgg16")
    imgs, boxes, labels = data
    out = {}
    checks = {
        "batch_not_divisible": lambda: train.make_scan_train_steps(
            hp, batch_size=3, num_steps=2, mesh=mesh),
        "rows_not_divisible": lambda: train.shard_batch(mesh, imgs[:3]),
        "n_devices": lambda: train.make_data_mesh(WORLD + 1, device="cpu"),
        "grad_accum": lambda: train.make_train_step(hp, grad_accum=2, mesh=mesh),
        "fast_predict": lambda: tpurpn_torch.make_predict_fn(
            _model("vgg16", sd), hp, fast=True, mesh=mesh, device="cpu"),
        # block 1 (rows 8-15) reads row 0, which lies in shard 0
        "shard_locality": lambda: train.make_scan_train_steps(
            hp, augment=False, batch_size=4, num_steps=2, mesh=mesh)(
            _state("vgg16", sd), torch.Generator(),
            *train.shard_batch(mesh, imgs, boxes, labels), np.zeros((2, 4), np.int64)),
        "per_shard_not_divisible": lambda: train.make_scan_train_steps(
            hp, augment=False, batch_size=6, num_steps=2, mesh=mesh)(
            _state("vgg16", sd), torch.Generator(),
            *train.shard_batch(mesh, imgs, boxes, labels)),
        "exclusive": lambda: train.make_scan_train_steps(
            hp, augment=False, batch_size=4, num_steps=2, mesh=mesh)(
            _state("vgg16", sd), torch.Generator(),
            *train.shard_batch(mesh, imgs, boxes, labels), np.zeros((2, 4), np.int64), 0),
    }
    for name, fn in checks.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _bn_inputs():
    g = torch.Generator().manual_seed(3)
    shape = (4, 6, 5, 7)
    x = torch.randn(shape, dtype=torch.float64, generator=g) * 2 + 1
    w = torch.rand(6, dtype=torch.float64, generator=g) + 0.5
    b = torch.randn(6, dtype=torch.float64, generator=g)
    dy = torch.randn(shape, dtype=torch.float64, generator=g)
    return x, w, b, dy


def _bn_layer(mesh):
    """The cross-rank BatchNorm on this rank's rows of an f64 batch."""
    from tpurpn_torch.backbones.mobilenet_v2 import _GlobalBatchNorm

    x, w, b, dy = _bn_inputs()
    rows = train.shard_batch(mesh, torch.arange(x.shape[0]))
    x, w, b = (t.requires_grad_() for t in (x[rows].clone(), w, b))
    y, mean, var = _GlobalBatchNorm.apply(x, w, b, 1e-3, mesh.get_group())
    (y * dy[rows]).sum().backward()
    return {"rows": rows, "y": y.detach(), "dx": x.grad, "dw": w.grad, "db": b.grad,
            "mean": mean, "var": var}


def _replicate_serves_rank_0(mesh, backbone, inp):
    """A bf16 model from a rank-dependent start, served once (its compute
    copies made), then replicated: serving must read rank 0's weights, as a
    fresh model of them does (the broadcasts bump the versions)."""
    hp = tpurpn_torch.get_hyper_params(backbone, **{**HP_KW, "compute_dtype": "bfloat16"})

    def model():
        m = tpurpn_torch.get_model(hp)
        m.load_state_dict(inp[f"sd_{backbone}"])
        return tpurpn_torch.model.to_device(m, "cpu")

    state = train.create_train_state(hp, model=model())
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(mesh.get_local_rank())
        state.model(inp["serve"])
        state = train.replicate(mesh, state)
        got, ref = state.model(inp["serve"]), model()(inp["serve"])
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def worker(rank: int, store: str, inputs: str, outputs: str) -> None:
    """One rank of the two: every mesh-side check, results to ``outputs``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        mesh = train.make_data_mesh(WORLD, device="cpu")
        inp = torch.load(inputs, weights_only=False)
        batch = inp["batch"]
        res = {"rank": mesh.get_local_rank(), "bn_layer": _bn_layer(mesh)}
        for bb in BACKBONES:
            # a rank-dependent start: replicate must hand out rank 0's state
            state = _state(bb, inp[f"sd_{bb}"])
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(rank)
            versions = [t._version for t in train._state_tensors(state)]
            state = train.replicate(mesh, state)
            res[f"replicate_{bb}"] = {
                "bumped": all(t._version > v for t, v in
                              zip(train._state_tensors(state), versions)),
                "serves_rank_0": _replicate_serves_rank_0(mesh, bb, inp)}
            step = train.make_train_step(_hp(bb), mesh=mesh)
            state, m = step(state, *train.shard_batch(mesh, *batch),
                            flip=inp[f"flip_{bb}"], rand_bits=inp[f"bits_{bb}"])
            res[f"step_{bb}"] = ({k: v.clone() for k, v in m.items()}, _tensors(state))
            res[f"eval_{bb}"] = train.make_eval_loss_fn(_hp(bb), mesh=mesh)(
                state, *train.shard_batch(mesh, *batch), rand_bits=inp[f"eval_bits_{bb}"])
        folded = tpurpn_torch.fold_batch_norm(_model("mobilenet_v2", inp["sd_mobilenet_v2"]))
        predict = tpurpn_torch.make_predict_fn(folded, _hp("mobilenet_v2"), mesh=mesh,
                                               device="cpu")
        res["predict"] = predict(train.shard_batch(mesh, inp["serve"]))
        for shuffle in (None, 11):
            res[f"scan_{shuffle}"] = _scan_vs_host_loop(mesh, inp["sd_vgg16"], inp["scan"],
                                                        shuffle)
        res["errors"] = _errors(mesh, inp["sd_vgg16"], inp["scan"])
        torch.save(res, outputs)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: inputs, one spawn, references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax

    import tpurpn.target as j_target
    import tpurpn.train as j_train
    from tpurpn_torch.convert import from_flax_variables

    tmp = tmp_path_factory.mktemp("dist")
    key = jax.random.key(42)
    batch = next(SyntheticVOC(num_samples=8, raw_h=72, raw_w=96, seed=0).batches(8, native=False))
    inp = {"batch": tuple(torch.from_numpy(a) for a in batch),
           "scan": tuple(torch.from_numpy(a) for a in next(
               SyntheticVOC(num_samples=16, raw_h=72, raw_w=96, seed=3).batches(16)))}
    jax_states = {}
    for bb in BACKBONES:
        jhp = _jax_hp(bb)
        jstate = jax.jit(lambda k, jhp=jhp: j_train.create_train_state(jhp, k))(
            jax.random.key(0))
        variables = {"params": jax.tree_util.tree_map(np.array, jstate.params)}
        if j_train._has_batch_stats(jstate):
            variables["batch_stats"] = jax.tree_util.tree_map(np.array, jstate.batch_stats)
        inp[f"sd_{bb}"] = from_flax_variables(_hp(bb), variables, device="cpu").state_dict()
        prep_key, target_key = jax.random.split(jax.random.fold_in(key, 0))
        inp[f"flip_{bb}"] = torch.from_numpy(np.array(jax.random.bernoulli(prep_key, 0.5, (8,))))
        inp[f"bits_{bb}"] = torch.from_numpy(np.array(
            j_target.target_rand_bits(target_key, 8, jhp.total_anchors)))
        jax_states[bb] = (jhp, jstate)
    eval_key = jax.random.key(9)
    for bb in BACKBONES:
        inp[f"eval_bits_{bb}"] = torch.from_numpy(np.array(j_target.target_rand_bits(
            eval_key, 8, _hp(bb).total_anchors)))
    inp["serve"] = torch.from_numpy(
        np.random.default_rng(5).uniform(0, 1, (8, 64, 64, 3)).astype(np.float32))
    inputs = str(tmp / "inputs.pt")
    torch.save(inp, inputs)

    # the two ranks run while this process computes tpurpn's mesh results
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))}
    store = tempfile.mktemp(dir=tmp)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), store,
                               inputs, str(tmp / f"out{r}.pt")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]

    mesh = j_train.make_data_mesh(WORLD)
    ref = {}
    imgs, boxes, labels = (jax.numpy.asarray(a) for a in batch)
    for bb, (jhp, jstate) in jax_states.items():
        state = j_train.replicate(mesh, jstate)
        new, jm = j_train.make_train_step(jhp, mesh=mesh)(
            state, *j_train.shard_batch(mesh, imgs, boxes, labels), key)
        loss = j_train.make_eval_loss_fn(jhp, mesh=mesh)(
            new, *j_train.shard_batch(mesh, imgs, boxes, labels), eval_key)
        ref[bb] = (jax.tree_util.tree_map(np.array, new.params),
                   jax.tree_util.tree_map(np.array, new.batch_stats),
                   jax.tree_util.tree_map(np.array, new.opt_state[0].trace),
                   {k: float(v) for k, v in jm.items()}, float(loss))

    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    results = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(WORLD)]
    return inp, results, ref


def _jax_hp(backbone):
    import tpurpn

    return tpurpn.get_hyper_params(backbone, **HP_KW)


def _one_thread(fn):
    """``fn()`` on one thread, as the ranks run: the CPU convs sum in another
    order on more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _single_step(inp, bb, rows=slice(None)):
    """The single-device step on ``rows`` of the batch and of its draws."""
    state = _state(bb, inp[f"sd_{bb}"])
    return _one_thread(lambda: train.make_train_step(_hp(bb))(
        state, *(t[rows] for t in inp["batch"]), flip=inp[f"flip_{bb}"][rows],
        rand_bits=inp[f"bits_{bb}"][rows]))


def _max_gap(got, ref):
    """max |got - ref| over the leaves of two flax-layout trees."""
    return max(float(np.abs(_at(got, path) - v).max()) for path, v in _flat(ref))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _worst_grad_ratio(got, ref):
    """max over parameters of ||g - g_ref|| / ||g_ref||, flax-layout trees.
    The project BatchNorms' biases are left out: their gradients are zero in
    exact arithmetic (a shift that the next train-mode BatchNorm removes),
    rounding noise in every implementation."""
    ratios = {}
    for path, r in _flat(ref):
        if path[-2].endswith("_project_BN") and path[-1] == "bias":
            continue
        d = _at(got, path).astype(np.float64) - r.astype(np.float64)
        ratios["/".join(path)] = np.linalg.norm(d) / np.linalg.norm(r.astype(np.float64))
    worst = max(ratios, key=ratios.get)
    return worst, ratios[worst]


def _as_flax(bb, tensors):
    """(parameters, BatchNorm statistics, summed gradients) of a step's
    tensors (``_tensors``) as flax-layout numpy trees."""
    from tpurpn_torch.convert import to_flax_numpy

    plain = {k: v for k, v in tensors.items() if not k.startswith("grad:")}
    tree = to_flax_numpy(_model(bb, plain))
    grads = {k[5:]: v for k, v in tensors.items() if k.startswith("grad:")}
    gtree = to_flax_numpy(_model(bb, {**plain, **grads}))
    return tree["params"], tree.get("batch_stats", {}), gtree["params"]


def _check_metrics(got, ref):
    assert int(got["num_pos"]) == int(ref["num_pos"])
    for k in ("loss", "reg_loss", "cls_loss"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("bb", BACKBONES)
def test_mesh_step_matches_the_single_device_step(run, bb):
    inp, results, _ = run
    state, m = _single_step(inp, bb)
    params, stats, _ = _as_flax(bb, _tensors(state))
    for res in results:  # every rank holds the global metrics and the same state
        assert res[f"replicate_{bb}"] == {"bumped": True, "serves_rank_0": True}
        got_m, got = res[f"step_{bb}"]
        _check_metrics(got_m, m)
        g_params, g_stats, _ = _as_flax(bb, got)
        atol = 1e-6 if bb == "vgg16" else MOBILENET_PARAM_ATOL
        for path, v in _flat(params):
            np.testing.assert_allclose(_at(g_params, path), v, rtol=0, atol=atol,
                                       err_msg="/".join(path))
        for path, v in _flat(stats):
            np.testing.assert_allclose(_at(g_stats, path), v, rtol=1e-4, atol=1e-6,
                                       err_msg="/".join(path))
    for a, b in zip(results[0][f"step_{bb}"][1].values(), results[1][f"step_{bb}"][1].values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bb", BACKBONES)
def test_mesh_step_matches_tpurpn_mesh_step(run, bb):
    inp, results, ref = run
    params, stats, trace, jm, _ = ref[bb]
    got_m, got = results[0][f"step_{bb}"]
    _check_metrics(got_m, jm)
    g_params, g_stats, g_grads = _as_flax(bb, got)
    if bb == "vgg16":
        for path, v in _flat(params):
            np.testing.assert_allclose(_at(g_params, path), v, rtol=1e-4, atol=1e-6,
                                       err_msg="/".join(path))
        return
    for path, v in _flat(stats):
        np.testing.assert_allclose(_at(g_stats, path), v, rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(path))
    worst, ratio = _worst_grad_ratio(g_grads, trace)
    assert ratio < 0.25, (worst, ratio)


def test_mesh_step_limit_fails_wrong_reductions(run):
    """MobileNetV2's parameter limit has room for round-off only: rank 0's
    rows stepped alone (no reduction at all: 3.7e-3 in the parameters, 3.7e-2
    in the statistics) and the ranks' gradients averaged instead of summed
    (half the update: 5.9e-4) both fail it."""
    inp, _, _ = run
    bb = "mobilenet_v2"
    p0, _, _ = _as_flax(bb, _tensors(_state(bb, inp[f"sd_{bb}"])))
    params, stats, _ = _as_flax(bb, _tensors(_single_step(inp, bb)[0]))
    alone, alone_stats, _ = _as_flax(bb, _tensors(_single_step(inp, bb, slice(0, 4))[0]))
    averaged = {}
    for path, v in _flat(params):  # SGD's first step is -lr * gradient
        node = averaged
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = (_at(p0, path) + v) / 2
    assert _max_gap(alone, params) > 10 * MOBILENET_PARAM_ATOL
    assert _max_gap(alone_stats, stats) > 1e-2
    assert _max_gap(averaged, params) > 2 * MOBILENET_PARAM_ATOL


def test_cross_rank_batch_norm_is_the_full_batch_batch_norm(run):
    """f64: the ranks' outputs and input gradients are the full batch's rows,
    the weight and bias gradients sum to the full batch's, and the statistics
    are its mean and biased variance."""
    x, w, b, dy = _bn_inputs()
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    y = torch.nn.functional.batch_norm(x, None, None, w, b, training=True, eps=1e-3)
    (y * dy).sum().backward()
    _, results, _ = run
    parts = [res["bn_layer"] for res in results]
    for p in parts:
        torch.testing.assert_close(p["y"], y.detach()[p["rows"]], rtol=0, atol=1e-10)
        torch.testing.assert_close(p["dx"], x.grad[p["rows"]], rtol=0, atol=1e-10)
        torch.testing.assert_close(p["mean"], x.detach().mean((0, 2, 3)), rtol=0, atol=1e-12)
        torch.testing.assert_close(p["var"], x.detach().var((0, 2, 3), correction=0),
                                   rtol=0, atol=1e-10)
    for k, ref in (("dw", w.grad), ("db", b.grad)):
        torch.testing.assert_close(sum(p[k] for p in parts), ref, rtol=0, atol=1e-10)


def test_mesh_eval_loss_matches(run):
    inp, results, ref = run
    for bb in BACKBONES:
        state, _ = _single_step(inp, bb)
        single = train.make_eval_loss_fn(_hp(bb))(state, *inp["batch"],
                                                  rand_bits=inp[f"eval_bits_{bb}"])
        for res in results:
            torch.testing.assert_close(res[f"eval_{bb}"], single, rtol=1e-5, atol=0)
            np.testing.assert_allclose(float(res[f"eval_{bb}"]), ref[bb][4], rtol=1e-5)


def test_mesh_predict_is_bit_equal_to_single_device(run):
    inp, results, _ = run
    folded = tpurpn_torch.fold_batch_norm(_model("mobilenet_v2", inp["sd_mobilenet_v2"]))
    # on one thread, as the ranks: the CPU convs sum in another order on more
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = tpurpn_torch.make_predict_fn(folded, _hp("mobilenet_v2"), device="cpu")(
            inp["serve"])
    finally:
        torch.set_num_threads(threads)
    for res in results:
        assert res["predict"].keys() == single.keys()
        for k, v in single.items():
            assert torch.equal(res["predict"][k], v), k
        assert res["predict"]["roi_boxes"].shape[0] == 8


@pytest.mark.parametrize("shuffle", [None, 11])
def test_mesh_scan_matches_sharded_host_loop(run, shuffle):
    _, results, _ = run
    for res in results:
        r = res[f"scan_{shuffle}"]
        assert torch.equal(r["scan_losses"], r["host_losses"])
        assert r["same_tensors"] and r["same_generator"] and r["steps"] == (5, 5)
    assert torch.equal(results[0][f"scan_{shuffle}"]["scan_losses"],
                       results[1][f"scan_{shuffle}"]["scan_losses"])


def test_mesh_refusals(run):
    _, results, _ = run
    for res in results:
        e = res["errors"]
        assert "not divisible by the mesh's 2 devices" in e["batch_not_divisible"]
        assert "does not divide among 2 ranks" in e["rows_not_divisible"]
        assert "n_devices=3" in e["n_devices"]
        assert e["grad_accum"].startswith("NotImplementedError")
        assert "mesh" in e["fast_predict"]
        assert "violates shard locality: batch position block 1 must index rows [8, 16)" \
            in e["shard_locality"]
        assert "per-shard size 8 not divisible by per-shard batch 3" \
            in e["per_shard_not_divisible"]
        assert "mutually exclusive" in e["exclusive"]


if __name__ == "__main__":
    worker(int(sys.argv[1]), *sys.argv[2:])
