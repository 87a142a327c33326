"""I/O of the port held against ``tpurpn.io_utils``: Keras ``.h5`` weights
(the committed trained file bit for bit, the same ``missing`` entries,
export read back by the other package), the ``.npz`` twin of the trained
file, checkpoints, and the CLI flags."""

import os

import numpy as np
import pytest
import jax
import torch

import tpurpn
from tpurpn import io_utils as j_io
from tpurpn.model import get_model as j_get_model
from tpurpn.model import init_model as j_init_model
import tpurpn_torch
from tpurpn_torch import io_utils, train
from tpurpn_torch.convert import from_flax_variables, to_flax_numpy

from test_torch_model import flax_mobilenet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "trained", "rpn_mobilenet_v2_trained")


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_equal(got, ref):
    g, r = dict(flat(got)), dict(flat(ref))
    assert sorted(g) == sorted(r)
    for k in r:
        assert g[k].dtype == np.float32, k
        np.testing.assert_array_equal(g[k], r[k], err_msg="/".join(k))


def j_load(path, backbone="mobilenet_v2", img=64):
    """tpurpn's import into a fresh init: ({params, batch_stats}, missing)."""
    v = j_init_model(j_get_model(tpurpn.get_hyper_params(backbone, img_size=img)),
                     jax.random.key(0))
    params, stats, missing = j_io.load_keras_h5_weights(path, v["params"], v.get("batch_stats"))
    tree = {"params": jax.tree_util.tree_map(np.asarray, params)}
    if stats is not None:
        tree["batch_stats"] = jax.tree_util.tree_map(np.asarray, stats)
    return tree, missing


def port_load(path, backbone="mobilenet_v2", img=64):
    hp = tpurpn_torch.get_hyper_params(backbone, img_size=img)
    model = tpurpn_torch.init_model(tpurpn_torch.get_model(hp),
                                    torch.Generator().manual_seed(3), device="cpu")
    return io_utils.load_keras_h5_weights(path, model)


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_trained_weights_load_bit_for_bit_as_in_tpurpn(suffix):
    ref, ref_missing = j_load(TRAINED + ".h5")
    model, missing = port_load(TRAINED + suffix)
    assert missing == ref_missing == []
    assert_trees_equal(to_flax_numpy(model), ref)


def test_npz_twin_equals_the_h5(tmp_path):
    import h5py

    with h5py.File(TRAINED + ".h5", "r") as f:
        layers = io_utils._h5_layer_weights(f)
    with np.load(TRAINED + ".npz") as z:
        twin = {k: z[k] for k in z.files}
    expected = {f"{l}/{p}": a for l, ps in layers.items() for p, a in ps.items()}
    assert sorted(twin) == sorted(expected) and len(twin) == 206
    for k, a in expected.items():
        assert twin[k].dtype == a.dtype and twin[k].shape == a.shape, k
        np.testing.assert_array_equal(twin[k], a, err_msg=k)
    # h5_to_npz is what made it
    io_utils.h5_to_npz(TRAINED + ".h5", str(tmp_path / "again.npz"))
    with np.load(tmp_path / "again.npz") as z:
        assert sorted(z.files) == sorted(expected)
        for k in z.files:
            np.testing.assert_array_equal(z[k], twin[k])


def _write_legacy_h5(path, layers):
    """A Keras-2-style weights file: model_weights/<l>/<l>/<param>:0."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        for name, params in layers.items():
            lg = g.create_group(name).create_group(name)
            for pname, arr in params.items():
                lg.create_dataset(pname + ":0", data=arr)


def test_partial_files_leave_the_same_entries_missing(tmp_path, rng):
    """Conv + head into VGG16; BN + depthwise into MobileNetV2: the same
    values and the same ``missing`` paths as tpurpn."""
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    vgg = str(tmp_path / "vgg.h5")
    _write_legacy_h5(vgg, {"block1_conv1": {"kernel": f(3, 3, 3, 64), "bias": f(64)},
                           "rpn_cls": {"kernel": f(1, 1, 512, 9), "bias": f(9)}})
    mnv2 = str(tmp_path / "mnv2.h5")
    _write_legacy_h5(mnv2, {
        "bn_Conv1": {"gamma": f(32), "beta": f(32), "moving_mean": f(32),
                     "moving_variance": np.abs(f(32)) + 0.5},
        "expanded_conv_depthwise": {"depthwise_kernel": f(3, 3, 32, 1)},
        "rpn_reg": {"kernel": f(1, 1, 9, 36)},  # a wrong shape stays missing
    })
    for path, backbone in ((vgg, "vgg16"), (mnv2, "mobilenet_v2")):
        ref, ref_missing = j_load(path, backbone, img=64)
        model, missing = port_load(path, backbone, img=64)
        assert sorted(missing) == sorted(ref_missing) and missing
        got = to_flax_numpy(model)
        loaded = {k for k, _ in flat(ref)} - {tuple(["params", *m.split("/")]) for m in missing}
        loaded -= {tuple(["batch_stats", *m.split("/")]) for m in missing}
        g, r = dict(flat(got)), dict(flat(ref))
        assert loaded
        for k in loaded:
            np.testing.assert_array_equal(g[k], r[k], err_msg="/".join(k))
    assert "rpn_reg/kernel" in missing and "backbone/bn_Conv1/mean" not in missing


def test_export_reads_back_in_both_packages(tmp_path):
    hp, _, variables, _, _ = flax_mobilenet(64)
    thp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=64)
    # the port's export, read by tpurpn
    port_h5 = str(tmp_path / "port.h5")
    io_utils.save_keras_h5_weights(port_h5, from_flax_variables(thp, variables, device="cpu"))
    ref, missing = j_load(port_h5, img=64)
    assert missing == []
    assert_trees_equal(ref, variables)
    # tpurpn's export, read by the port
    j_h5 = str(tmp_path / "tpurpn.h5")
    j_io.save_keras_h5_weights(j_h5, variables["params"], variables["batch_stats"])
    model, missing = port_load(j_h5, img=64)
    assert missing == []
    assert_trees_equal(to_flax_numpy(model), variables)
    # and the two files hold the same layers, names and attributes
    import h5py

    with h5py.File(port_h5) as a, h5py.File(j_h5) as b:
        assert sorted(a["model_weights"].attrs["layer_names"]) == sorted(
            b["model_weights"].attrs["layer_names"])
        for layer in b["model_weights"]:
            assert list(a["model_weights"][layer].attrs["weight_names"]) == list(
                b["model_weights"][layer].attrs["weight_names"])


def test_export_refuses_duplicate_layer_names(tmp_path, monkeypatch):
    k = np.zeros((1, 1, 1, 1), np.float32)
    tree = {"params": {"a": {"conv": {"kernel": k}}, "b": {"conv": {"kernel": k}}}}
    monkeypatch.setattr(io_utils, "to_flax_numpy", lambda model: tree)
    with pytest.raises(ValueError, match="duplicate Keras layer name 'conv'"):
        io_utils.save_keras_h5_weights(str(tmp_path / "dup.h5"), None)


def _state(hp, seed):
    model = tpurpn_torch.init_model(tpurpn_torch.get_model(hp),
                                    torch.Generator().manual_seed(seed), device="cpu")
    return train.create_train_state(hp, model=model)


def _payload(state):
    return {"params": dict(state.model.named_parameters()),
            "batch_stats": dict(state.model.named_buffers()),
            "opt_state": state.optimizer.state_dict(), "step": state.step}


def test_checkpoint_roundtrip_full_and_partial(tmp_path):
    hp = tpurpn_torch.get_hyper_params("mobilenet_v2", img_size=64, max_gt_boxes=8)
    state = _state(hp, 0)
    imgs, boxes, labels = (torch.from_numpy(a) for a in
                           next(tpurpn_torch.data.SyntheticVOC(num_samples=2, raw_h=40,
                                                               raw_w=56).batches(2)))
    train.make_train_step(hp)(state, imgs, boxes, labels, torch.Generator().manual_seed(1))
    path = io_utils.get_model_path("mobilenet_v2", str(tmp_path / "out"))
    io_utils.save_checkpoint(path, {k: (v if k in ("opt_state", "step") else
                                        {n: t.detach() for n, t in v.items()})
                                    for k, v in _payload(state).items()})
    assert os.listdir(path) == ["state.pt"]

    fresh = _state(hp, 1)
    like = _payload(fresh)
    restored = io_utils.load_checkpoint(path, like)
    assert restored["step"] == 1
    fresh.model.load_state_dict({**restored["params"], **restored["batch_stats"]})
    fresh.optimizer.load_state_dict(restored["opt_state"])
    for (n, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    mom = [s["momentum_buffer"] for s in state.optimizer.state.values()]
    mom_fresh = [s["momentum_buffer"] for s in fresh.optimizer.state.values()]
    assert len(mom) == len(mom_fresh) > 0
    assert all(torch.equal(a, b) for a, b in zip(mom, mom_fresh))

    part = io_utils.load_checkpoint(path, {"params": None, "batch_stats": None, "x": None},
                                    partial=True)
    assert sorted(part) == ["batch_stats", "params"]
    with pytest.raises(KeyError, match="x"):
        io_utils.load_checkpoint(path, {"params": None, "x": None})
    other = _payload(_state(tpurpn_torch.get_hyper_params("vgg16", img_size=64), 0))
    with pytest.raises(ValueError, match="params"):
        io_utils.load_checkpoint(path, other)


@pytest.mark.parametrize("argv", [
    [],
    ["--backbone", "mobilenet_v2", "-handle-gpu", "--grad-accum", "4", "--batch-size", "32"],
    ["--epochs", "3", "--steps-per-epoch", "7", "--learning-rate", "0.01", "--img-size", "64",
     "--dataset", "x.json", "--val-dataset", "voc/2007", "--data-parallel", "--device-data",
     "--eval-recall-every", "2", "--no-augment", "--no-shuffle", "--fast", "--tensorboard",
     "--seed", "5", "--output-dir", "o", "--weights", "w.npz"],
])
def test_handle_args_matches_tpurpn(argv):
    got = vars(io_utils.handle_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(j_io.handle_args(argv))
    assert io_utils.handle_args(argv + ["--device", "cpu"]).device == "cpu"


def test_paths_and_backbones(tmp_path):
    p = io_utils.get_model_path("vgg16", str(tmp_path / "out"))
    assert p == j_io.get_model_path("vgg16", str(tmp_path / "out")) and p.endswith("rpn_vgg16")
    log = io_utils.get_log_path("vgg16", str(tmp_path / "logs"))
    assert os.path.isdir(log) and log.startswith(str(tmp_path / "logs" / "vgg16"))
    for b in ("vgg16", "mobilenet_v2", "resnet50"):
        assert io_utils.is_valid_backbone(b) == j_io.is_valid_backbone(b)
