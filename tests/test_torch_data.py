"""Datasets and the native batch generator of the port held against
``tpurpn.data`` / ``tpurpn.native``: the same bytes for the same seeds and
indices, the same defaults, the same walks, and the same samples from the
on-disk VOC and COCO fixtures and a stubbed tensorflow_datasets."""

import json
import os
import sys
import types
import zlib

import numpy as np
import pytest

import tpurpn.data as j_data
from tpurpn import native as j_native
from tpurpn_torch import data, native

# crc32 of tpurpn.native.generate_batch(seed 1, indices 0-7, 375x500, 8
# boxes, at least 1, 20 classes): images, boxes and labels, chained.
# chip_smoke.py holds the card's g++ build of the port's copy to it.
NATIVE_CRC_SEED1 = 0x1C68A8F8


def batch_crc(batch) -> int:
    crc = 0
    for a in batch:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


def assert_batches_equal(got, ref):
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_native_builds_into_the_build_directory():
    assert native.available()
    so = native.library_path()
    assert so.exists() and so.parent.name == "tpurpn_torch" and so.parent.parent.name == "build"
    assert not list(native.SRC.parent.glob("*.so"))
    assert native.SRC.read_bytes() == open(j_native._SRC, "rb").read()


@pytest.mark.parametrize("seed,indices,shape", [
    (0, np.arange(4), (375, 500, 8, 1)),
    (1, np.arange(8), (375, 500, 8, 1)),
    (7, np.array([5, 0, 123, 2**33]), (96, 128, 4, 1)),
    (2, np.arange(250, 256), (64, 48, 64, 0)),
])
def test_native_batches_equal_tpurpn(seed, indices, shape):
    h, w, max_boxes, min_boxes = shape
    got = native.generate_batch(seed, indices, h, w, max_boxes, min_boxes, 20)
    ref = j_native.generate_batch(seed, indices, h, w, max_boxes, min_boxes, 20)
    assert_batches_equal(got, ref)
    again = native.generate_batch(seed, indices, h, w, max_boxes, min_boxes, 20)
    assert_batches_equal(again, got)


def test_native_crc_constant():
    ref = j_native.generate_batch(1, np.arange(8), 375, 500, 8, 1, 20)
    assert batch_crc(ref) == NATIVE_CRC_SEED1
    assert batch_crc(native.generate_batch(1, np.arange(8), 375, 500, 8, 1, 20)) == NATIVE_CRC_SEED1
    with pytest.raises(ValueError):
        native.generate_batch(1, np.arange(2), 0, 500, 8, 1, 20)


@pytest.mark.parametrize("kwargs,batch_kw", [
    ({}, {}),
    ({"seed": 2, "num_samples": 12, "raw_h": 40, "raw_w": 56}, {"shuffle": 3}),
    ({"seed": 1, "num_samples": 10, "raw_h": 30, "raw_w": 20, "max_boxes": 3},
     {"drop_remainder": False}),
    ({"seed": 5, "num_samples": 6, "raw_h": 40, "raw_w": 56}, {"native": False}),
])
def test_synthetic_batches_equal_tpurpn_with_its_defaults(kwargs, batch_kw):
    got = list(data.SyntheticVOC(**kwargs).batches(4, **batch_kw))
    ref = list(j_data.SyntheticVOC(**kwargs).batches(4, **batch_kw))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert_batches_equal(g, r)


def test_sharded_batch_index_iter_equals_tpurpn():
    for args, kw in (((16, 8, 2), {"repeat": True}), ((24, 6, 3), {"shuffle": 4, "repeat": True})):
        it = data.sharded_batch_index_iter(*args, **kw)
        ref = j_data.sharded_batch_index_iter(*args, **kw)
        for _ in range(7):  # past the end of the first epoch
            np.testing.assert_array_equal(next(it), next(ref))
    assert len(list(data.sharded_batch_index_iter(16, 8, 2))) == 2
    for bad in ((10, 8, 4), (12, 8, 4)):
        with pytest.raises(ValueError):
            next(data.sharded_batch_index_iter(*bad))


def test_get_dataset_splits_and_api_mirrors():
    for split in ("train", "validation", "test", "myweirdsplit"):
        got, ref = data.get_dataset("synthetic", split, num_samples=2), j_data.get_dataset(
            "synthetic", split, num_samples=2)
        assert got.seed == ref.seed and type(got).__name__ == "SyntheticVOC"
    assert data.get_dataset("synthetic", "myweirdsplit").seed == zlib.crc32(b"myweirdsplit") % 1000
    seeds = [data.get_dataset("synthetic", s).seed for s in ("train", "validation", "test")]
    assert seeds == [0, 1, 2]
    assert data.get_data_types() == j_data.get_data_types()
    assert data.get_data_shapes() == j_data.get_data_shapes()
    assert data.get_padding_values() == j_data.get_padding_values()
    assert data.VOC_CLASSES == j_data.VOC_CLASSES


def _write_voc_fixture(root, n=3, split="train"):
    """Tiny VOCdevkit-style fixture: JPEGImages + Annotations + split."""
    from PIL import Image

    os.makedirs(os.path.join(root, "JPEGImages"))
    os.makedirs(os.path.join(root, "Annotations"))
    os.makedirs(os.path.join(root, "ImageSets", "Main"))
    rng = np.random.default_rng(0)
    ids = []
    for i in range(n):
        img_id = f"{i:06d}"
        ids.append(img_id)
        arr = rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "JPEGImages", img_id + ".jpg"))
        xml = f"""<annotation>
  <size><width>80</width><height>60</height><depth>3</depth></size>
  <object><name>dog</name>
    <bndbox><xmin>{9 + i}</xmin><ymin>7</ymin><xmax>40</xmax><ymax>30</ymax></bndbox>
  </object>
  <object><name>unknownclass</name>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>10</xmax><ymax>10</ymax></bndbox>
  </object>
  <object><name>person</name>
    <bndbox><xmin>50</xmin><ymin>20</ymin><xmax>80</xmax><ymax>60</ymax></bndbox>
  </object>
</annotation>"""
        with open(os.path.join(root, "Annotations", img_id + ".xml"), "w") as f:
            f.write(xml)
    with open(os.path.join(root, "ImageSets", "Main", split + ".txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return ids


@pytest.mark.parametrize("split,file", [("train", "train"), ("validation", "val"),
                                        ("train+validation", "trainval")])
def test_voc_directory_equals_tpurpn(tmp_path, split, file):
    root = str(tmp_path / "VOC2007")
    _write_voc_fixture(root, n=3, split=file)
    got = data.get_dataset(root, split, max_boxes=4)
    ref = j_data.get_dataset(root, split, max_boxes=4)
    assert isinstance(got, data.VOCDirectory) and len(got) == len(ref) == 3
    g_batches = list(got.batches(2, drop_remainder=False))
    r_batches = list(ref.batches(2, drop_remainder=False))
    assert len(g_batches) == 2
    for g, r in zip(g_batches, r_batches):
        assert_batches_equal(g, r)
    imgs, boxes, labels = g_batches[0]
    assert imgs.shape == (2, 500, 500, 3)
    np.testing.assert_allclose(boxes[0, 0], [6 / 60, 8 / 80, 30 / 60, 40 / 80])
    assert labels[0, :3].tolist() == [data.VOC_CLASSES.index("dog") + 1,
                                      data.VOC_CLASSES.index("person") + 1, -1]
    one_box = data._parse_voc_xml(os.path.join(root, "Annotations", "000000.xml"), 1)
    assert one_box[1].tolist() == [12]


def test_coco_json_equals_tpurpn(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "val"
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    for name, (w, h) in (("a.jpg", (40, 20)), ("b.jpg", (30, 30))):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(img_dir / name)
    coco = {
        "images": [
            {"id": 7, "file_name": "a.jpg", "width": 40, "height": 20},
            {"id": 3, "file_name": "b.jpg", "width": 30, "height": 30},
        ],
        "categories": [{"id": 18}, {"id": 2}],  # sparse ids, like real COCO
        "annotations": [
            {"image_id": 7, "bbox": [10, 5, 20, 10], "category_id": 18},
            {"image_id": 7, "bbox": [0, 0, 4, 4], "category_id": 2, "iscrowd": 1},
            {"image_id": 7, "bbox": [1, 1, 4, 4], "category_id": 99},  # unknown: skipped
            {"image_id": 3, "bbox": [3, 6, 9, 12], "category_id": 2},
        ],
    }
    ann = tmp_path / "annotations" / "instances_val.json"
    ann.parent.mkdir()
    ann.write_text(json.dumps(coco))
    got = data.get_dataset(str(ann), "train", max_boxes=4, raw_size=(16, 16))
    ref = j_data.get_dataset(str(ann), "train", max_boxes=4, raw_size=(16, 16))
    assert isinstance(got, data.CocoJson) and len(got) == len(ref) == 2
    assert got.images_dir == str(img_dir)
    for i in range(2):
        assert_batches_equal(got.sample(i), ref.sample(i))
    assert_batches_equal(next(got.batches(2)), next(ref.batches(2, native=False)))
    _, boxes, labels = got.sample(1)
    np.testing.assert_allclose(boxes[0], [5 / 20, 10 / 40, 15 / 20, 30 / 40], atol=1e-6)
    assert labels.tolist() == [2, -1, -1, -1]


def _tfds_stub(split_name="train"):
    h, w = 30, 45
    examples = [
        {"image": np.full((h, w, 3), 7, np.uint8),
         "objects": {"bbox": np.array([[0.1, 0.2, 0.5, 0.6]], np.float32),
                     "label": np.array([3], np.int64)}},
        {"image": np.arange(h * 2 * w * 3, dtype=np.int64).reshape(h * 2, w, 3).astype(np.uint8),
         "objects": {"bbox": np.zeros((0, 4), np.float32), "label": np.zeros((0,), np.int64)}},
    ]

    class _Split:
        num_examples = len(examples)

    class _Builder:
        info = types.SimpleNamespace(splits={split_name: _Split()})

        def download_and_prepare(self):
            pass

        def as_dataset(self, split, shuffle_files=False):
            assert split == split_name
            return examples

    return types.SimpleNamespace(builder=lambda name: _Builder(), as_numpy=lambda ds: ds)


def test_tfds_voc_with_a_stub_equals_tpurpn(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", _tfds_stub())
    got = data.get_dataset("voc/2007", "train", max_boxes=4, raw_size=(16, 16))
    ref = j_data.get_dataset("voc/2007", "train", max_boxes=4, raw_size=(16, 16))
    assert isinstance(got, data.TfdsVOC) and len(got) == len(ref) == 2
    g, r = next(got.batches(2)), next(ref.batches(2, native=False))
    assert_batches_equal(g, r)
    assert g[2][0].tolist() == [4, -1, -1, -1] and (g[2][1] == -1).all()


def test_tfds_voc_without_tfds_raises(monkeypatch):
    import builtins

    monkeypatch.delitem(sys.modules, "tensorflow_datasets", raising=False)
    real_import = builtins.__import__

    def blocked(name, *a, **kw):
        if name == "tensorflow_datasets":
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", blocked)
    with pytest.raises(ImportError, match="tensorflow_datasets"):
        data.get_dataset("voc/2007", "train")


def test_prefetcher_yields_all_items_and_reraises():
    ds = data.SyntheticVOC(num_samples=12, raw_h=32, raw_w=32)
    items = list(data.Prefetcher(ds.batches(4), depth=2))
    ref = list(ds.batches(4))
    assert len(items) == 3
    for g, r in zip(items, ref):
        assert_batches_equal(g, r)

    def bad_iter():
        yield 1
        raise ValueError("corrupt sample")

    it = data.Prefetcher(bad_iter(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="pipeline worker failed") as ei:
        next(it)
    assert isinstance(ei.value.__cause__, ValueError)
    with pytest.raises(RuntimeError):  # raised again, not a hang
        next(it)
