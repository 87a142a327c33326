"""Weight carrier: ``tpurpn`` (flax) variable trees <-> the port's modules.

``from_flax_variables(hp, variables_np)`` takes the JAX package's variable
tree as nested dicts of numpy arrays — the unfolded tree (``params`` +
``batch_stats``), the BN-folded ``{"params"}`` tree of
``tpurpn.model.fold_batch_norm``, or a VGG16 tree — and returns an ``RPN``
holding the same numbers; ``to_flax_numpy(model)`` goes back. It imports
nothing of JAX: callers hand over numpy arrays.

Layout mapping (flax -> torch):

* conv ``kernel`` HWIO -> ``weight`` OIHW; the depthwise kernel (3, 3, 1, C)
  follows the same transpose to (C, 1, 3, 3);
* conv ``bias`` -> ``bias``;
* BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``, ``batch_stats``
  ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

Names carry over unchanged: ``backbone/block_7/block_7_expand/kernel`` is
``backbone.block_7.block_7_expand.weight``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import HyperParams
from .model import RPN, to_device


def _is_bn(layer: str) -> bool:
    return layer.endswith("_BN") or layer == "bn_Conv1"


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_PARAM_NAMES = {"kernel": "weight", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(variables_np) -> Dict[str, torch.Tensor]:
    """Flax variable tree (numpy leaves) -> torch state-dict entries."""
    sd = {}
    for path, v in _flatten(variables_np["params"]):
        arr = np.asarray(v, np.float32)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        name = _PARAM_NAMES.get(path[-1], path[-1])
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(arr.copy())
    for path, v in _flatten(variables_np.get("batch_stats", {})):
        if not _is_bn(path[-2]):
            raise ValueError(f"batch_stats entry outside a BatchNorm: {'/'.join(path)}")
        name = _STAT_NAMES[path[-1]]
        sd[".".join(path[:-1] + (name,))] = torch.tensor(np.asarray(v, np.float32))
    return sd


def from_flax_variables(hp: HyperParams, variables_np, device=None) -> RPN:
    """Build an ``RPN`` on ``device`` (default: cuda) from a ``tpurpn``
    variable tree. A MobileNetV2 tree without BatchNorm parameters is the
    folded one; VGG16 has no BatchNorm either way."""
    has_bn = any(_is_bn(path[-2]) for path, _ in _flatten(variables_np["params"]))
    model = RPN(hp, fold_bn=hp.backbone == "mobilenet_v2" and not has_bn)
    return to_device(load_flax_variables(model, variables_np), device)


@torch.no_grad()
def load_flax_variables(model: RPN, variables_np) -> RPN:
    """Copy a ``tpurpn`` variable tree (numpy leaves, the same layout as
    ``to_flax_numpy(model)``) into ``model`` in place: its parameters keep
    their identity and device, so an optimizer built on them stays valid."""
    sd = flax_to_state_dict(variables_np)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    model.load_state_dict(sd, strict=True)
    return model


_FLAX_PARAM = {"weight": "kernel", "bias": "bias"}
_FLAX_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def to_flax_numpy(model: RPN):
    """The inverse of ``from_flax_variables``: the port's weights as a
    ``tpurpn`` variable tree of numpy arrays ({"params"}, plus
    {"batch_stats"} when the model has BatchNorms)."""
    tree = {"params": {}}
    for key, v in model.state_dict().items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = v.detach().float().cpu().numpy()
        if _is_bn(path[-1]):
            collection, leaf = _FLAX_BN[leaf]
        else:
            collection, leaf = "params", _FLAX_PARAM[leaf]
            if leaf == "kernel":
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        node = tree.setdefault(collection, {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree
