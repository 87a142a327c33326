"""I/O, args, paths, checkpoints and Keras ``.h5`` weights (port of
``tpurpn/io_utils.py``).

Rebuild of the reference's ``utils/io_utils`` (SURVEY.md §2 row 8) plus the
checkpoint / resume subsystem (SURVEY.md §5). Checkpoints are a directory
holding one ``state.pt`` written by ``torch.save`` (``tpurpn`` uses orbax).
Keras ``.h5`` weight files map onto the port's ``RPN`` through the flax
naming of ``convert.py``: the model's weights as a ``tpurpn`` variable tree
(``to_flax_numpy``), the reference's name-based mapping on that tree, and
back (``load_flax_variables``).

``h5py`` is imported only to read or write an ``.h5`` file. A machine
without it reads the ``.npz`` twin that ``h5_to_npz`` makes of an ``.h5``:
the same ``{layer: {param: array}}`` table, keyed ``"<layer>/<param>"``.
"""

from __future__ import annotations

import argparse
import datetime
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .config import VALID_BACKBONES
from .convert import _flatten, load_flax_variables, to_flax_numpy
from .model import RPN


# ---------------------------------------------------------------------------
# args / paths (reference: io_utils.handle_args / get_model_path / get_log_path)
# ---------------------------------------------------------------------------


def handle_args(argv=None) -> argparse.Namespace:
    """CLI flags of ``tpurpn``'s trainer and predictor, plus ``--device``."""
    p = argparse.ArgumentParser(description="tpurpn_torch — RPN in PyTorch")
    p.add_argument("--backbone", default="vgg16", choices=list(VALID_BACKBONES))
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--img-size", type=int, default=500)
    p.add_argument(
        "--dataset",
        default="synthetic",
        help="'synthetic', a path to a VOCdevkit VOC20xx directory, "
             "'voc/2007' (tfds), or a COCO instances .json",
    )
    p.add_argument(
        "--val-dataset",
        default=None,
        help="separate validation data source (same forms as --dataset); "
             "required for meaningful best-checkpoint selection with a COCO "
             ".json --dataset, whose split is implied by the file",
    )
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the batch over all visible devices "
                        "(torchrun --nproc-per-node N ...; a plain launch is a group of one)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each batch into N microbatches and accumulate "
                        "gradients (exact — equals the full-batch gradient). "
                        "Incompatible with --data-parallel")
    p.add_argument("--device-data", action="store_true",
                   help="keep the whole training set resident in device "
                        "memory and chain steps on the device "
                        "(on the card: one CUDA graph of the step, replayed)")
    p.add_argument("--eval-recall-every", type=int, default=0, metavar="N",
                   help="trainer: every N epochs, also evaluate proposal "
                        "recall@test_nms_topn on the validation set and log "
                        "it alongside val_loss; 0 (default) disables")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--no-shuffle", action="store_true",
                   help="disable per-epoch training-data shuffling")
    p.add_argument("--fast", action="store_true",
                   help="predictor: fused inverted-residual-stage forward "
                        "(folded-BN mobilenet_v2 only)")
    p.add_argument("--tensorboard", action="store_true",
                   help="write TensorBoard scalars (reference parity)")
    p.add_argument(
        "-handle-gpu", "--handle-gpu", dest="handle_gpu", action="store_true",
        help="reference parity for -handle-gpu: log the CUDA device setup",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="trained")
    p.add_argument("--weights", default=None,
                   help="checkpoint dir, .h5 file or its .npz twin to load")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p.parse_args(argv)


def is_valid_backbone(backbone: str) -> bool:
    return backbone in VALID_BACKBONES


def handle_device_compatibility() -> None:
    """Parity shim for the reference's ``handle_gpu_compatibility()``: the
    reference sets CUDA memory growth; PyTorch's caching allocator grows on
    demand, so this logs the CUDA devices."""
    if torch.cuda.is_available():
        print(f"[tpurpn_torch] cuda devices: {torch.cuda.device_count()} "
              f"({torch.cuda.get_device_name()})")
    else:
        print("[tpurpn_torch] no CUDA device visible")


def get_model_path(backbone: str, output_dir: str = "trained") -> str:
    """Checkpoint directory path (reference: trained/rpn_<backbone>_model_weights.h5)."""
    os.makedirs(output_dir, exist_ok=True)
    return os.path.abspath(os.path.join(output_dir, f"rpn_{backbone}"))


def get_log_path(backbone: str, log_dir: str = "logs") -> str:
    now = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    path = os.path.join(log_dir, backbone, now)
    os.makedirs(path, exist_ok=True)
    return path


# ---------------------------------------------------------------------------
# checkpoints (reference: orbax; Keras ModelCheckpoint — SURVEY.md §5)
# ---------------------------------------------------------------------------

_STATE_FILE = "state.pt"


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Save a dict of state dicts, tensors and numbers as
    ``<path>/state.pt``: the trainer saves ``params`` and ``batch_stats``
    (the model's parameters and buffers by name), ``opt_state`` (the
    optimizer's state dict) and ``step``. Written to a temporary name and
    renamed, so a reader never sees half a file."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, _STATE_FILE)
    tmp = f"{final}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, final)


def load_checkpoint(path: str, like: Dict[str, Any], partial: bool = False) -> Dict[str, Any]:
    """Restore the entries of ``like``'s top-level keys from a checkpoint
    directory of :func:`save_checkpoint`, on the CPU.

    ``partial=False`` needs every key of ``like``, and each state dict among
    them with the same names as ``like``'s; ``partial=True`` returns the keys
    of ``like`` the file holds (the predictor takes ``params`` and
    ``batch_stats`` out of a train-state checkpoint).
    """
    saved = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                       weights_only=True)
    if partial:
        return {k: saved[k] for k in like if k in saved}
    absent = [k for k in like if k not in saved]
    if absent:
        raise KeyError(f"checkpoint {path} holds no {absent}")
    for k, v in like.items():
        if isinstance(v, dict) and set(v) != set(saved[k]):
            diff = sorted(set(v) ^ set(saved[k]))
            raise ValueError(f"checkpoint {path}: {k!r} differs in the names {diff[:8]}")
    return {k: saved[k] for k in like}


# ---------------------------------------------------------------------------
# Keras .h5 weights
# ---------------------------------------------------------------------------


def _h5_layer_weights(h5file) -> Dict[str, Dict[str, np.ndarray]]:
    """Collect {layer_name: {param_name: array}} from a legacy Keras .h5 file.

    Legacy (Keras 2 / TF2-era, what the reference's ModelCheckpoint wrote)
    weight files store datasets at ``model_weights/<layer>/<layer>/kernel:0``
    etc.; param names are kernel / bias / gamma / beta / moving_mean /
    moving_variance / depthwise_kernel.
    """
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            parts = [p for p in name.split("/") if p]
            pname = parts[-1].split(":")[0]
            layer = None
            for p in reversed(parts[:-1]):
                if p not in ("model_weights", "vars"):
                    layer = p
                    break
            if layer is not None:
                out.setdefault(layer, {})[pname] = np.asarray(obj)

    h5file.visititems(visit)
    return out


def h5_to_npz(h5_path: str, npz_path: str) -> None:
    """Store an ``.h5``'s ``{layer: {param: array}}`` table as an uncompressed
    ``.npz`` keyed ``"<layer>/<param>"``: the weights without ``h5py``."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        layers = _h5_layer_weights(f)
    np.savez(npz_path, **{f"{layer}/{name}": arr for layer, params in layers.items()
                          for name, arr in params.items()})


def _layer_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The ``{layer: {param: array}}`` table of an ``.h5`` or ``.npz`` file."""
    if path.endswith(".npz"):
        out: Dict[str, Dict[str, np.ndarray]] = {}
        with np.load(path) as z:
            for key in z.files:
                layer, name = key.rsplit("/", 1)
                out.setdefault(layer, {})[name] = z[key]
        return out
    import h5py

    with h5py.File(path, "r") as f:
        return _h5_layer_weights(f)


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


# flax param leaf name -> candidate names in a Keras layer dict
_PARAM_CANDIDATES = {
    "kernel": ("kernel", "depthwise_kernel"),
    "bias": ("bias",),  # conv bias; BN beta handled below
    "scale": ("gamma",),
    "mean": ("moving_mean",),
    "var": ("moving_variance",),
}


def load_keras_h5_weights(path: str, model: RPN) -> Tuple[RPN, List[str]]:
    """Map a legacy Keras ``.h5`` weight file (or its ``.npz`` twin, chosen
    by the suffix) onto ``model``, in place.

    The modules are named after their Keras counterparts (block1_conv1 ...
    rpn_cls; Conv1/block_N_expand... for MobileNetV2), so the mapping is by
    name on the model's flax-layout tree: conv kernels share the HWIO
    layout; Keras depthwise kernels (H, W, C, 1) become (H, W, 1, C); a BN
    layer's ``beta`` is its ``bias``. Entries of the model absent from the
    file keep their values and are returned in ``missing`` under their flax
    paths (``backbone/bn_Conv1/mean``), as ``tpurpn`` returns them.

    Returns (model, missing_entries).
    """
    layers = _layer_weights(path)

    def lookup(layer_name: str, leaf: str, want_shape, is_bn_layer: bool):
        layer = layers.get(layer_name)
        if layer is None:
            return None
        if leaf == "bias" and is_bn_layer:
            cands = ("beta",)
        else:
            cands = _PARAM_CANDIDATES.get(leaf, (leaf,))
        for c in cands:
            if c in layer:
                arr = layer[c]
                if arr.shape == tuple(want_shape):
                    return arr
                # Keras depthwise (H, W, C, 1) -> flax grouped conv (H, W, 1, C)
                if (
                    c == "depthwise_kernel"
                    and arr.ndim == 4
                    and arr.shape[-1] == 1
                    and arr.transpose(0, 1, 3, 2).shape == tuple(want_shape)
                ):
                    return arr.transpose(0, 1, 3, 2)
        return None

    tree = to_flax_numpy(model)
    missing: List[str] = []
    for collection in ("params", "batch_stats"):
        if collection not in tree:
            continue
        flat = dict(_flatten(tree[collection]))
        for key in flat:
            layer_name, leaf = key[-2], key[-1]
            is_bn = "gamma" in layers.get(layer_name, {})
            arr = lookup(layer_name, leaf, flat[key].shape, is_bn)
            if arr is None:
                missing.append("/".join(key))
            else:
                flat[key] = arr.astype(flat[key].dtype)
        tree[collection] = _unflatten(flat)
    load_flax_variables(model, tree)
    return model, missing


def save_keras_h5_weights(path: str, model: RPN) -> None:
    """Write ``model``'s weights as a legacy Keras ``.h5`` weight file.

    The inverse of :func:`load_keras_h5_weights`: weights land at
    ``model_weights/<layer>/<layer>/<name>:0`` with Keras names (kernel /
    bias / gamma / beta / moving_mean / moving_variance / depthwise_kernel),
    plus the legacy ``layer_names`` / ``weight_names`` HDF5 attributes; the
    file ``tpurpn.io_utils.save_keras_h5_weights`` writes for the same
    weights. Depthwise kernels are transposed back to Keras (H, W, C, 1)
    layout; BN biases are written as ``beta``.
    """
    import h5py

    tree = to_flax_numpy(model)
    p_flat = dict(_flatten(tree["params"]))
    s_flat = dict(_flatten(tree.get("batch_stats", {})))
    # which layers are BatchNorms (a 'scale' leaf or statistics), so their
    # 'bias' exports as 'beta' rather than a conv bias
    bn_layers = {key[-2] for key in p_flat if key[-1] == "scale"}
    bn_layers |= {key[-2] for key in s_flat}

    # h5 groups are keyed by the bare Keras layer name (key[-2]): valid only
    # while layer names are unique, as they are in Keras models
    owners: Dict[str, tuple] = {}
    for key in list(p_flat) + list(s_flat):
        prefix, layer = key[:-2], key[-2]
        if owners.setdefault(layer, prefix) != prefix:
            raise ValueError(
                f"duplicate Keras layer name {layer!r} at module paths "
                f"{'/'.join(owners[layer])} and {'/'.join(prefix)}: the .h5 "
                "export keys groups by bare layer name and cannot represent "
                "both — rename one module"
            )

    export_names = {"scale": "gamma", "mean": "moving_mean", "var": "moving_variance"}
    # Keras `layer.weights` order (what the legacy by-name loader zips
    # against): conv [*kernel, bias]; BN [gamma, beta, moving_mean,
    # moving_variance]
    weight_order = ("kernel", "depthwise_kernel", "gamma", "beta", "bias",
                    "moving_mean", "moving_variance")

    layers: Dict[str, Dict[str, np.ndarray]] = {}
    for key, arr in list(p_flat.items()) + list(s_flat.items()):
        layer, leaf = key[-2], key[-1]
        if leaf == "bias" and layer in bn_layers:
            name = "beta"
        elif leaf == "kernel" and "depthwise" in layer:
            # (H, W, 1, C) -> Keras (H, W, C, 1), classified by the layer
            # NAME: a conv over one input channel has the same shape
            if not (arr.ndim == 4 and arr.shape[2] == 1):
                raise ValueError(f"depthwise kernel {layer} has shape {arr.shape}")
            name = "depthwise_kernel"
            arr = arr.transpose(0, 1, 3, 2)
        else:
            name = export_names.get(leaf, leaf)
        layers.setdefault(layer, {})[name] = np.asarray(arr, np.float32)

    with h5py.File(path, "w") as f:
        grp = f.create_group("model_weights")
        grp.attrs["backend"] = np.bytes_(b"tensorflow")
        grp.attrs["keras_version"] = np.bytes_(b"2.15.0")
        # no fixed-width dtype: numpy truncates names longer than an explicit
        # width; a bare np.array sizes to the longest name
        grp.attrs["layer_names"] = np.array([layer.encode() for layer in layers])
        for layer, weights in layers.items():
            g = grp.create_group(layer)
            inner = g.create_group(layer)
            names = sorted(weights, key=weight_order.index)
            g.attrs["weight_names"] = np.array([f"{layer}/{n}:0".encode() for n in names])
            for n in names:
                inner.create_dataset(f"{n}:0", data=weights[n])
