"""Drawing of the port held against ``tpurpn.drawing`` (PIL): the same
pixels, on float and uint8 images, boxes that leave the image, boxes lower
or narrower than the 2-pixel outline, and padding rows; the PNG the port
writes without PIL reads back in PIL as the drawn array."""

import numpy as np
import pytest
from PIL import Image

from tpurpn import drawing as j_drawing
from tpurpn.data import VOC_CLASSES
from tpurpn_torch import drawing


def _boxes(rng, kind, n):
    if kind == "anywhere":  # corners outside [0, 1] too
        b = rng.uniform(-0.3, 1.3, (n, 4))
    elif kind == "tiny":  # under 2-3 pixels: the outline's lines run backwards
        yx = rng.uniform(0, 1, (n, 2))
        b = np.concatenate([yx, yx + rng.uniform(0, 0.06, (n, 2))], 1)
    elif kind == "grid":  # corners on pixel edges (exact products)
        b = np.round(rng.uniform(0, 1, (n, 4)) * 10) / 10
    else:  # proposals, partly past the left and top edges
        yx = rng.uniform(-0.1, 1, (n, 2))
        b = np.concatenate([yx, yx + rng.uniform(0, 0.3, (n, 2))], 1)
    return b.astype(np.float32)


@pytest.mark.parametrize("kind", ["anywhere", "tiny", "grid", "proposals"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_draw_bboxes_matches_pil_pixel_for_pixel(kind, dtype):
    rng = np.random.default_rng(len(kind) * 7 + len(dtype))
    for _ in range(150):
        h, w = rng.integers(1, 60, 2)
        img = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if dtype == "uint8"
               else rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32))
        b = _boxes(rng, kind, int(rng.integers(0, 6)))
        got = drawing.draw_bboxes(img, b)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, np.asarray(j_drawing.draw_bboxes(img, b)))


def test_degenerate_and_padding_rows_draw_nothing():
    img = np.full((32, 40, 3), 9, np.uint8)
    boxes = np.array([[0, 0, 0, 0], [0.5, 0.5, 0.5, 0.9], [0.5, 0.5, 0.9, 0.4],
                      [0.9, 0.1, 0.2, 0.3]], np.float32)
    got = drawing.draw_bboxes(img, boxes)
    np.testing.assert_array_equal(got, np.asarray(j_drawing.draw_bboxes(img, boxes)))
    np.testing.assert_array_equal(got, img)
    assert (img == 9).all()  # the input is not drawn on


def test_draw_bboxes_to_file_writes_a_png_pil_reads(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (50, 70, 3)).astype(np.float32)
    boxes = np.array([[0.1, 0.1, 0.6, 0.8], [0.2, 0.5, 0.9, 0.95], [0, 0, 0, 0]], np.float32)
    path = str(tmp_path / "p.png")
    drawing.draw_bboxes_to_file(img, boxes, path)
    back = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(back, drawing.draw_bboxes(img, boxes))
    ref = str(tmp_path / "ref.png")
    j_drawing.draw_bboxes_to_file(img, boxes, ref)
    np.testing.assert_array_equal(back, np.asarray(Image.open(ref)))
    with pytest.raises(ValueError):
        drawing.encode_png(np.zeros((4, 4), np.uint8))


def test_labels_and_grid_match_pil():
    img = np.zeros((64, 64, 3), np.uint8)
    boxes = np.array([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9], [0.2, 0.6, 0.4, 0.9]],
                     np.float32)
    for labels, names in (([1, len(VOC_CLASSES), 0], VOC_CLASSES), ([1, 3, -1], None)):
        np.testing.assert_array_equal(
            np.asarray(drawing.draw_bboxes_with_labels(img, boxes, labels, names)),
            np.asarray(j_drawing.draw_bboxes_with_labels(img, boxes, labels, names)))
    grid = np.stack(np.meshgrid(np.linspace(0.1, 0.9, 4), np.linspace(0.1, 0.9, 4)),
                    -1).reshape(-1, 2)
    got = np.asarray(drawing.draw_grid_map(img, grid))
    np.testing.assert_array_equal(got, np.asarray(j_drawing.draw_grid_map(img, grid)))
    assert (got[:, :, 1] > 200).any()
