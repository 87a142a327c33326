"""Serving in the reference: uint8 frames -> every anchor's decoded box and
score, and the proposals (top ``pre`` by score, greedy NMS, the first
``topn`` kept), in float32 or, with ``quant="fp8"``, the control."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import geometry, nets

VARIANCES = (0.1, 0.1, 0.2, 0.2)


def load_npz(path, device) -> nets.Params:
    """A Keras-layout weight file (``<layer>/<param>`` arrays) as f32 tensors."""
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device) for k in z.files}


@torch.no_grad()
def candidates(params: nets.Params, frames_u8: torch.Tensor, cfg: dict, quant=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boxes (B, N, 4), scores (B, N)) of every anchor for uint8 NHWC frames."""
    img = cfg["img_size"]
    fm = geometry.feature_map(cfg["backbone"], img)
    anc = torch.from_numpy(geometry.anchors(img, fm)).to(frames_u8.device)
    x, _ = geometry.preprocess(frames_u8, img)
    net = nets.mobilenet_v2 if cfg["backbone"] == "mobilenet_v2" else nets.vgg16
    reg, cls = net(params, x, quant)
    var = torch.tensor(VARIANCES, dtype=torch.float32, device=reg.device)
    return geometry.decode(anc[None], reg * var), torch.sigmoid(cls)


def select(boxes: torch.Tensor, scores: torch.Tensor, pre: int, thr: float, topn: int
           ) -> Dict[str, np.ndarray]:
    """Proposals of each image: the ``pre`` best scores (ties to the lower
    index), greedy NMS, the first ``topn`` kept, zero past ``num_valid``.
    Also returns each image's keep flags over its sorted candidates."""
    B = boxes.shape[0]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :pre]
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    ss = torch.gather(scores, 1, order).cpu().numpy()
    out = {"roi_boxes": np.zeros((B, topn, 4), np.float32),
           "roi_scores": np.zeros((B, topn), np.float32),
           "num_valid": np.zeros((B,), np.int32), "keep": []}
    for i in range(B):
        keep = geometry.greedy_nms(sb[i], thr, topn)
        idx = np.nonzero(keep)[0][:topn]
        out["roi_boxes"][i, :len(idx)] = sb[i, idx].cpu().numpy()
        out["roi_scores"][i, :len(idx)] = ss[i, idx]
        out["num_valid"][i] = len(idx)
        out["keep"].append(keep)
    return out
