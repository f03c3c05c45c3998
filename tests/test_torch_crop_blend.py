"""Parity of the port's crop re-compositing (``core/crop_engine.py``
``reverse_xy_mapping``, ``get_blend_mask``, ``blend_in`` and
``crop(..., return_mapping=True)``) with the JAX package's, and of its
two cv2 copies in ``utils/resize.py`` with cv2 5.0.0, on the CPU.

- ``resize_linear_up_f32`` against ``cv2.resize(fx=s, fy=s,
  INTER_LINEAR)`` on float32 images of many shapes (one row or column
  too), s = 2, 4 and 8: bit-equal.
- ``remap_linear_transparent`` against ``cv2.remap(INTER_LINEAR,
  BORDER_TRANSPARENT, dst=...)`` on uint8 images of 1 and 3 channels,
  with maps off the image on every side, integer and -1 coordinates:
  bit-equal.
- ``resize_linear_u8_to`` (``convert_torchscript distill``'s image
  resize) against ``cv2.resize(img, (w, h))`` on uint8 images of 1 and 3
  channels, up and down, to odd sizes: bit-equal.
- The crop, mapping, offset and blended page against the JAX engine on
  straight and curved lines, poly 0 and 2, blend borders 2 and 4, lines
  inside the page and at its bottom, left and right edges: equal arrays.
"""

import cv2
import numpy as np
import pytest

from pero_ocr_tpu.core.crop_engine import EngineLineCropper as JaxCropper
from pero_ocr_tpu_torch.core.crop_engine import EngineLineCropper
from pero_ocr_tpu_torch.utils.resize import (
    remap_linear_transparent,
    resize_linear_u8_to,
    resize_linear_up_f32,
)


@pytest.mark.parametrize("up", [2, 4, 8])
def test_resize_linear_up_f32_equals_cv2(up):
    rng = np.random.default_rng(up)
    shapes = [tuple(s) for s in rng.integers(2, 40, (12, 2))] + [
        (1, 1), (1, 17), (23, 1), (16, 700), (2, 2)]
    for h, w in shapes:
        img = rng.normal(0, 800, (int(h), int(w))).astype(np.float32)
        want = cv2.resize(img, (0, 0), fx=up, fy=up, interpolation=cv2.INTER_LINEAR)
        got = resize_linear_up_f32(img, up)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want), (h, w)


def test_resize_linear_up_f32_refuses():
    for up in (3, 0, 2.5, True):
        with pytest.raises(ValueError):
            resize_linear_up_f32(np.zeros((2, 2), np.float32), up)
    with pytest.raises(ValueError):
        resize_linear_up_f32(np.zeros((2, 2), np.float64), 4)


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_u8_to_equals_cv2(channels):
    rng = np.random.default_rng(20 + channels)
    sizes = [tuple(int(v) for v in rng.integers(1, 300, 4)) for _ in range(12)] + [
        (100, 100, 50, 50), (64, 64, 64, 64), (300, 500, 256, 320), (40, 700, 32, 512)]
    for h, w, oh, ow in sizes:
        img = rng.integers(0, 256, (h, w) if channels == 1 else (h, w, channels),
                           dtype=np.uint8)
        want = cv2.resize(img, (ow, oh))
        got = resize_linear_u8_to(img, (ow, oh))
        assert got.shape == want.shape and np.array_equal(got, want), (h, w, oh, ow)


@pytest.mark.parametrize("channels", [1, 3])
def test_remap_transparent_equals_cv2(channels):
    rng = np.random.default_rng(10 + channels)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        oh, ow = (int(v) for v in rng.integers(1, 90, 2))
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        mx = rng.uniform(-3, w + 2, (oh, ow)).astype(np.float32)
        my = rng.uniform(-3, h + 2, (oh, ow)).astype(np.float32)
        whole = rng.random((oh, ow)) < 0.2
        mx[whole], my[whole] = np.round(mx[whole]), np.round(my[whole])
        mx[rng.random((oh, ow)) < 0.1] = -1
        dst = rng.integers(0, 256, (oh, ow) + shape[2:], dtype=np.uint8)
        want = dst.copy()
        cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR,
                  borderMode=cv2.BORDER_TRANSPARENT, dst=want)
        got = dst.copy()
        assert remap_linear_transparent(img, mx, my, got) is got
        assert np.array_equal(got, want)


def _baselines(rng, h, w):
    straight = np.array([[20.0, 60.0], [w - 30.0, 64.0]])
    x = np.sort(rng.uniform(15, w - 15, 6))
    curved = np.stack([x, 120 + 4 * np.sin(x / 35.0) + rng.uniform(-1, 1, 6)], axis=1)
    bottom = np.array([[40.0, h - 3.0], [w - 60.0, h - 1.0]])
    left = np.array([[0.0, 90.0], [w / 2, 95.0]])
    right = np.array([[w / 2, 160.0], [w - 1.0, 150.0]])
    return {"straight": straight, "curved": curved, "bottom_edge": bottom,
            "left_edge": left, "right_edge": right}


@pytest.mark.parametrize("blend_border", [2, 4])
@pytest.mark.parametrize("poly", [0, 2])
def test_mapping_and_blend_equal_jax(poly, blend_border):
    rng = np.random.default_rng(poly * 10 + blend_border)
    h, w = 200, 320
    page = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    ours = EngineLineCropper(24, poly, 1.25, blend_border=blend_border)
    theirs = JaxCropper(line_height=24, poly=poly, scale=1.25, blend_border=blend_border)
    for name, baseline in _baselines(rng, h, w).items():
        heights = [14.0, 5.0]
        crop, mapping, offset = ours.crop(page, baseline, heights, return_mapping=True)
        jcrop, jmapping, joffset = theirs.crop(page, baseline, heights, return_mapping=True)
        assert np.array_equal(crop, jcrop), name
        assert mapping.dtype == jmapping.dtype == np.float32
        assert np.array_equal(mapping, jmapping), name
        assert offset == joffset and all(type(v) is int for v in offset), name
        assert np.array_equal(ours.get_blend_mask(mapping), theirs.get_blend_mask(jmapping))
        processed = (255 - crop).astype(np.uint8)  # a crop changed by some filter
        got = ours.blend_in(page.copy(), processed, mapping, offset)
        want = theirs.blend_in(page.copy(), processed, jmapping, joffset)
        assert np.array_equal(got, want), name
        assert not np.array_equal(got, page), name  # the crop went back in
