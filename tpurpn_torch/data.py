"""On-device preprocessing and the synthetic dataset (port of parts of
``tpurpn/data.py``).

Rebuild of the reference's ``utils/data_utils.preprocessing`` (SURVEY.md §2
row 7): uint8 frames -> [0, 1] floats, bilinear resize to the model's input
size, optional horizontal flip that mirrors the boxes. ``SyntheticVOC``
(its Python sampler and, by default, the native C++ generator of
``tpurpn_torch.native``), the index walks, the VOC directory / tfds / COCO
sources, ``Prefetcher`` and ``get_dataset`` are host-side numpy copies of
``tpurpn``'s, so one seed gives the same bytes in both packages. Images are
decoded with PIL (imported only by the sources that read JPEG files).
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC bilinear resize to (size, size), as ``jax.image.resize``:
    half-pixel centers, and an antialiasing (triangle-kernel widened by the
    scale) filter along a dimension that shrinks.

    torch's antialiased bilinear has no bfloat16 kernel on the CPU, so a
    shrinking resize runs in f32 and is cast back to the input dtype.
    """
    H, W = x.shape[1], x.shape[2]
    xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view
    if H > size or W > size:
        out = F.interpolate(xc.float(), size=(size, size), mode="bilinear",
                            align_corners=False, antialias=True).to(x.dtype)
    else:
        out = F.interpolate(xc, size=(size, size), mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1)


def preprocess_batch(
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    img_size: int,
    augment: bool = False,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    flip: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 (B, H, W, 3) batch -> [0,1] ``dtype`` images resized to
    (img_size, img_size); with ``augment`` a per-image random horizontal flip
    mirroring the boxes' x-coordinates.

    Boxes are normalized, so the resize leaves them unchanged; the flip maps
    x -> 1 - x on real rows and keeps zero-padded rows zero. ``flip`` (B,)
    bool gives the flip mask; otherwise it is drawn from ``generator``
    (p = 0.5 per image, on the CPU).
    """
    B = images.shape[0]
    # a fill, not a host copy (capturable in a CUDA graph); a true division,
    # where a Python scalar divisor would multiply by its reciprocal on the card
    x = images.to(dtype) / torch.full((), 255.0, dtype=dtype, device=images.device)
    x = resize_bilinear(x, img_size)
    if augment:
        if flip is None:
            if generator is None:
                raise ValueError("augment=True requires a generator or a flip mask")
            flip = torch.rand((B,), generator=generator) < 0.5
        flip = flip.to(images.device)
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        y1, x1, y2, x2 = gt_boxes.unbind(-1)
        valid = (gt_boxes != 0.0).any(dim=-1)
        fb = torch.stack([y1, 1.0 - x2, y2, 1.0 - x1], dim=-1)
        fb = torch.where(valid[..., None], fb, 0.0)
        gt_boxes = torch.where(flip[:, None, None], fb, gt_boxes)
    return x, gt_boxes


# ---------------------------------------------------------------------------
# Synthetic VOC-style dataset (a copy of tpurpn.data's, numpy only)
# ---------------------------------------------------------------------------


def _max_iou(box: np.ndarray, others: np.ndarray) -> float:
    y1 = np.maximum(box[0], others[:, 0])
    x1 = np.maximum(box[1], others[:, 1])
    y2 = np.minimum(box[2], others[:, 2])
    x2 = np.minimum(box[3], others[:, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
    union = area(box) + area(others) - inter
    return float((inter / np.maximum(union, 1e-8)).max())


def batch_index_iter(
    num_samples: int,
    batch_size: int,
    *,
    repeat: bool = False,
    drop_remainder: bool = True,
    shuffle: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield per-batch sample indices: fixed order, or a fresh deterministic
    permutation per epoch when ``shuffle`` is an integer seed; remainder
    batches dropped by default."""
    epoch = 0
    while True:
        if shuffle is not None:
            order = np.random.default_rng(
                (np.uint32(shuffle), np.uint32(epoch))
            ).permutation(num_samples)
        else:
            order = np.arange(num_samples)
        for start in range(0, num_samples, batch_size):
            idxs = order[start : min(start + batch_size, num_samples)]
            if drop_remainder and len(idxs) < batch_size:
                continue
            yield idxs
        epoch += 1
        if not repeat:
            return


@dataclasses.dataclass
class SyntheticVOC:
    """Procedural detection data: bright axis-aligned rectangles on noise.

    Deterministic per (seed, index), and the same samples as
    ``tpurpn.data.SyntheticVOC``'s Python sampler. Raw images are
    (raw_h, raw_w) like typical VOC photos; preprocessing resizes them.
    """

    num_samples: int = 256
    raw_h: int = 375
    raw_w: int = 500
    max_boxes: int = 8
    min_boxes: int = 1
    seed: int = 0

    def __len__(self) -> int:
        return self.num_samples

    def sample(self, index: int):
        rng = np.random.default_rng(np.uint32(self.seed * 1_000_003 + index))
        img = rng.integers(0, 60, size=(self.raw_h, self.raw_w, 3), dtype=np.uint8)
        n = int(rng.integers(self.min_boxes, self.max_boxes + 1))
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.full((self.max_boxes,), -1, np.int32)
        count = 0
        for _ in range(n):
            # rejection-sample boxes with low mutual overlap
            for _attempt in range(8):
                h = rng.uniform(0.12, 0.6)
                w = rng.uniform(0.12, 0.6)
                y1 = rng.uniform(0.0, 1.0 - h)
                x1 = rng.uniform(0.0, 1.0 - w)
                cand = np.array([y1, x1, y1 + h, x1 + w], np.float32)
                if count == 0 or _max_iou(cand, boxes[:count]) < 0.3:
                    break
            else:
                continue
            boxes[count] = cand
            labels[count] = int(rng.integers(1, len(VOC_CLASSES) + 1))  # 0 = bg
            color = rng.integers(120, 255, size=3)
            py1, px1 = int(y1 * self.raw_h), int(x1 * self.raw_w)
            py2, px2 = int((y1 + h) * self.raw_h), int((x1 + w) * self.raw_w)
            img[py1:py2, px1:px2] = color
            count += 1
        return img, boxes, labels

    def batches(
        self,
        batch_size: int,
        *,
        repeat: bool = False,
        drop_remainder: bool = True,
        native: Optional[bool] = None,
        shuffle: Optional[int] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (images u8 (B,H,W,3), boxes (B,M,4), labels (B,M)) batches
        in the order of ``batch_index_iter``.

        ``native`` selects the C++ OpenMP generator (``tpurpn_torch.native``),
        whose samples differ from the Python sampler's (its own RNG). None =
        auto, as in ``tpurpn``: native when this is a ``SyntheticVOC`` and the
        generator builds. ``shuffle``: an integer seed gives a fresh
        permutation per epoch; None keeps the fixed order.
        """
        use_native = False
        if native is not False and type(self) is SyntheticVOC:
            from . import native as native_mod

            use_native = native_mod.available() if native is None else True
        # len(self) also covers the sources with no num_samples field
        for idxs in batch_index_iter(
            len(self), batch_size, repeat=repeat,
            drop_remainder=drop_remainder, shuffle=shuffle,
        ):
            if use_native:
                yield native_mod.generate_batch(
                    self.seed, np.asarray(idxs, np.int64), self.raw_h, self.raw_w,
                    self.max_boxes, self.min_boxes, len(VOC_CLASSES),
                )
            else:
                samples = [self.sample(i) for i in idxs]
                yield (
                    np.stack([s[0] for s in samples]),
                    np.stack([s[1] for s in samples]),
                    np.stack([s[2] for s in samples]),
                )


def sharded_batch_index_iter(
    num_samples: int,
    batch_size: int,
    num_shards: int,
    *,
    repeat: bool = False,
    shuffle: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Shard-local dataset walk: yields ``(batch_size,)`` global row indices
    where batch-position block ``d`` (entries ``[d*B/D, (d+1)*B/D)``) indexes
    only shard ``d``'s rows (``[d*N/D, (d+1)*N/D)``). Each shard walks its
    rows in fixed order, or under its own per-epoch permutation seeded by
    (shuffle, shard, epoch). N/D and B/D must divide evenly, so the shards'
    epochs stay aligned."""
    if num_samples % num_shards or batch_size % num_shards:
        raise ValueError(
            f"num_samples {num_samples} and batch_size {batch_size} must "
            f"both divide by num_shards {num_shards}"
        )
    n_local = num_samples // num_shards
    b_local = batch_size // num_shards
    if n_local % b_local:
        raise ValueError(
            f"per-shard size {n_local} not divisible by per-shard batch "
            f"{b_local}: shards would drop different remainders"
        )
    epoch = 0
    while True:
        if shuffle is not None:
            orders = [
                np.random.default_rng(
                    (np.uint32(shuffle), np.uint32(d), np.uint32(epoch))
                ).permutation(n_local)
                for d in range(num_shards)
            ]
        else:
            orders = [np.arange(n_local)] * num_shards
        for start in range(0, n_local, b_local):
            yield np.concatenate([
                d * n_local + orders[d][start : start + b_local]
                for d in range(num_shards)
            ])
        epoch += 1
        if not repeat:
            return


# ---------------------------------------------------------------------------
# Pascal-VOC directory, tfds VOC and COCO sources (host-side, numpy)
# ---------------------------------------------------------------------------


def _parse_voc_xml(path: str, max_boxes: int):
    root = ET.parse(path).getroot()
    size = root.find("size")
    h = float(size.find("height").text)
    w = float(size.find("width").text)
    boxes = np.zeros((max_boxes, 4), np.float32)
    labels = np.full((max_boxes,), -1, np.int32)
    i = 0
    for obj in root.iter("object"):
        if i >= max_boxes:
            break
        name = obj.find("name").text.strip()
        if name not in VOC_CLASSES:
            continue
        bb = obj.find("bndbox")
        # VOC bndbox pixel coordinates are 1-based; tfds pascal_voc (what the
        # reference consumes) converts min corners as (coord-1)/size
        x1 = (float(bb.find("xmin").text) - 1.0) / w
        y1 = (float(bb.find("ymin").text) - 1.0) / h
        x2 = float(bb.find("xmax").text) / w
        y2 = float(bb.find("ymax").text) / h
        boxes[i] = (y1, x1, y2, x2)
        labels[i] = VOC_CLASSES.index(name) + 1  # 0 = background
        i += 1
    return boxes, labels


def _load_rgb(path: str, raw_size: Tuple[int, int]) -> np.ndarray:
    """Decode an image file to uint8 RGB at ``raw_size`` (H, W): bilinear,
    as the reference's tf.image.resize (Pillow's RGB default is bicubic)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize(
        (raw_size[1], raw_size[0]), resample=Image.BILINEAR
    )
    return np.asarray(img, np.uint8)


@dataclasses.dataclass
class VOCDirectory:
    """Pascal-VOC on local disk: <root>/JPEGImages + <root>/Annotations.

    Images are decoded host-side (PIL) to ``raw_size`` and resized to the
    model's input by :func:`preprocess_batch`, the reference's plain square
    resize.
    """

    root: str
    split_ids: List[str]
    max_boxes: int = 64
    raw_size: Tuple[int, int] = (500, 500)  # host-side standardization size

    def __len__(self) -> int:
        return len(self.split_ids)

    def sample(self, index: int):
        img_id = self.split_ids[index]
        img = _load_rgb(os.path.join(self.root, "JPEGImages", img_id + ".jpg"),
                        self.raw_size)
        boxes, labels = _parse_voc_xml(
            os.path.join(self.root, "Annotations", img_id + ".xml"), self.max_boxes)
        return img, boxes, labels

    batches = SyntheticVOC.batches  # same batching logic


def load_voc_directory(
    root: str, split: str = "train", max_boxes: int = 64
) -> VOCDirectory:
    """Open a VOCdevkit-style directory (e.g. .../VOC2007). Raises if absent.

    tfds-style split names (what the trainer passes) are translated to the
    ImageSets files VOCdevkit ships: 'validation' -> val.txt,
    'train+validation' -> trainval.txt.
    """
    fname = {"validation": "val", "train+validation": "trainval"}.get(split, split)
    split_file = os.path.join(root, "ImageSets", "Main", fname + ".txt")
    with open(split_file) as f:
        ids = [line.split()[0] for line in f if line.strip()]
    return VOCDirectory(root=root, split_ids=ids, max_boxes=max_boxes)


@dataclasses.dataclass
class TfdsVOC:
    """tensorflow_datasets-backed VOC, the reference's data source
    (``data_utils.get_dataset("voc/2007", split)``, SURVEY.md §2 row 7).

    Requires ``tensorflow_datasets`` (construction raises a clear
    ImportError without it). Samples are resized host-side to ``raw_size``
    like VOCDirectory; tfds boxes are already normalized y1x1y2x2; labels are
    shifted +1 (0 = background) and padded with -1.
    """

    name: str = "voc/2007"
    split: str = "train"
    max_boxes: int = 64
    raw_size: Tuple[int, int] = (500, 500)

    def __post_init__(self):
        try:
            import tensorflow_datasets as tfds
        except ImportError as e:
            raise ImportError(
                "tensorflow_datasets is required for TfdsVOC "
                f"(get_dataset({self.name!r})). It is not installed in this "
                "environment; use name='synthetic' or a local VOCdevkit path."
            ) from e
        builder = tfds.builder(self.name)
        builder.download_and_prepare()
        self._examples = None
        self._builder = builder
        self._tfds = tfds
        self._len = int(builder.info.splits[self.split].num_examples)

    def __len__(self) -> int:
        return self._len

    def _materialize(self):
        # decode once, keep host-side uint8 + padded GT (VOC 2007 fits in RAM)
        if self._examples is not None:
            return self._examples
        from PIL import Image

        out = []
        for ex in self._tfds.as_numpy(
            self._builder.as_dataset(split=self.split, shuffle_files=False)
        ):
            img = np.asarray(
                Image.fromarray(ex["image"]).resize(
                    (self.raw_size[1], self.raw_size[0]), resample=Image.BILINEAR
                ),
                np.uint8,
            )
            bb = ex["objects"]["bbox"].astype(np.float32)  # (n, 4) y1x1y2x2
            lb = ex["objects"]["label"].astype(np.int32) + 1  # 0 = background
            n = min(len(lb), self.max_boxes)
            boxes = np.zeros((self.max_boxes, 4), np.float32)
            labels = np.full((self.max_boxes,), -1, np.int32)
            boxes[:n] = bb[:n]
            labels[:n] = lb[:n]
            out.append((img, boxes, labels))
        self._examples = out
        return out

    def sample(self, index: int):
        return self._materialize()[index]

    batches = SyntheticVOC.batches  # same batching logic


@dataclasses.dataclass
class CocoJson:
    """COCO-format detection data: an ``instances_*.json`` + an image dir.

    Boxes come as COCO pixel ``[x, y, w, h]`` and become normalized
    ``[y1, x1, y2, x2]``; ``iscrowd`` and unknown-category annotations are
    skipped; category ids are remapped to contiguous 1..K with 0 =
    background, the label convention of every other source.
    """

    ann_file: str
    images_dir: Optional[str] = None
    max_boxes: int = 64
    raw_size: Tuple[int, int] = (500, 500)

    def __post_init__(self):
        import json

        with open(self.ann_file) as f:
            coco = json.load(f)
        if self.images_dir is None:
            # annotations/instances_train2017.json -> <root>/train2017
            base = os.path.basename(self.ann_file)
            split = base.replace("instances_", "").rsplit(".", 1)[0]
            root = os.path.dirname(os.path.dirname(os.path.abspath(self.ann_file)))
            self.images_dir = os.path.join(root, split)
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self._cat_map = {cid: i + 1 for i, cid in enumerate(cat_ids)}
        self._images = sorted(coco["images"], key=lambda im: im["id"])
        anns_by_img: dict = {}
        for a in coco.get("annotations", []):
            # a category outside the list would become a "background" GT row
            # that every labels != -1 check still counts: skip it, like iscrowd
            if a.get("iscrowd", 0) or a["category_id"] not in self._cat_map:
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self._anns = anns_by_img

    def __len__(self) -> int:
        return len(self._images)

    def sample(self, index: int):
        info = self._images[index]
        img = _load_rgb(os.path.join(self.images_dir, info["file_name"]), self.raw_size)
        w, h = float(info["width"]), float(info["height"])
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.full((self.max_boxes,), -1, np.int32)
        for i, a in enumerate(self._anns.get(info["id"], [])[: self.max_boxes]):
            x, y, bw, bh = a["bbox"]
            boxes[i] = (y / h, x / w, (y + bh) / h, (x + bw) / w)
            labels[i] = self._cat_map[a["category_id"]]
        return img, boxes, labels

    batches = SyntheticVOC.batches  # same batching logic


class Prefetcher:
    """Background-thread batch prefetcher (depth-bounded queue): overlaps
    host batch generation with device compute. Wraps any batch iterator; an
    error in the worker is re-raised by ``__next__``."""

    def __init__(self, iterator: Iterator, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: BaseException | None = None

        def worker():
            try:
                for item in iterator:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 — re-raised in __next__
                self._error = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            # put the sentinel back: a later call stops (or raises) again
            # instead of blocking on an empty queue
            self._q.put(item)
            if self._error is not None:
                raise RuntimeError("data pipeline worker failed") from self._error
            raise StopIteration
        return item


def get_data_types():
    """Mirror of the reference's ``data_utils.get_data_types``: element
    dtypes of a preprocessed (image, gt_boxes, gt_labels) sample."""
    return (np.float32, np.float32, np.int32)


def get_data_shapes():
    """Mirror of the reference's ``data_utils.get_data_shapes``: per-element
    shapes with None for the data-dependent dimensions (the batches pad them
    to static sizes)."""
    return ((None, None, 3), (None, 4), (None,))


def get_padding_values():
    """Mirror of the reference's ``data_utils.get_padding_values``: image 0,
    boxes 0.0, labels -1, the pads every source uses."""
    return (0, 0.0, -1)


def get_dataset(name: str = "synthetic", split: str = "train", **kwargs):
    """Dataset factory mirroring the reference's data_utils.get_dataset.

    name="synthetic"  -> SyntheticVOC (split selects a disjoint seed: train
                         0, validation 1, test 2, any other crc32 % 1000);
    name="voc/2007"   -> TfdsVOC (needs tensorflow_datasets);
    name=<x.json>     -> CocoJson (the split is the file's);
    name=<path>       -> VOC directory on disk.
    """
    if name.endswith(".json"):
        kwargs.pop("split", None)
        return CocoJson(ann_file=name, **kwargs)
    if name == "synthetic":
        # a stable hash for unknown splits: str hash is randomized per process
        import zlib

        seed = {"train": 0, "validation": 1, "test": 2}.get(
            split, zlib.crc32(split.encode()) % 1000
        )
        return SyntheticVOC(seed=seed, **kwargs)
    if name == "voc" or name.startswith("voc/"):
        return TfdsVOC(name=name, split=split, **kwargs)
    return load_voc_directory(name, split=split, **kwargs)
