"""Numpy/scipy copies of the OpenCV 5 binary-image steps of
``REGION_SIMPLE_THRESHOLD`` (JAX ``layout_engines/simple_region_engine.py``),
bit-equal to cv2 5.0.0:

- :func:`close_u8`: ``cv2.morphologyEx(img, MORPH_CLOSE, np.ones((k, k)))``;
- :func:`near_ink_mask`: ``cv2.distanceTransform(255 - closed, DIST_L2,
  DIST_MASK_PRECISE) < limit``;
- :func:`connected_components_cv`: ``cv2.connectedComponents(mask,
  connectivity=8)``, labels numbered as OpenCV numbers them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def close_u8(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.morphologyEx(img, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8))``
    on a 2-D uint8 image: a k x k box dilation, then erosion, anchored at
    ``k // 2``.  OpenCV's default morphology border takes no part in a
    maximum or minimum, which repeating the edge pixels gives as well
    (scipy's ``nearest``; a zero border would erode the page's edges)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"close_u8 takes a 2-D uint8 image, got {img.shape} {img.dtype}")
    if k < 1:
        raise ValueError(f"close_u8: kernel size {k} < 1")
    dilated = ndimage.maximum_filter(img, size=k, mode="nearest")
    return ndimage.minimum_filter(dilated, size=k, mode="nearest")


def near_ink_mask(closed: np.ndarray, limit: float) -> np.ndarray:
    """``(cv2.distanceTransform(255 - closed, DIST_L2, DIST_MASK_PRECISE)
    < limit)`` as uint8, for a 0/255 image: 1 where the Euclidean
    distance to the nearest 255 pixel of ``closed`` is below ``limit``.
    Squared distances are integers, so the exact transform decides every
    pixel alike.  Without any 255 pixel OpenCV's distances are all about
    1.8e19 and the mask is empty."""
    ink = np.asarray(closed) == 255
    if not ink.any():
        return np.zeros(ink.shape, np.uint8)
    return (ndimage.distance_transform_edt(~ink) < limit).astype(np.uint8)


def connected_components_cv(mask: np.ndarray) -> Tuple[int, np.ndarray]:
    """``cv2.connectedComponents(mask, connectivity=8)``: (the number of
    labels with the background's 0, int32 labels).  OpenCV's 8-connected
    labelling scans 2x2 blocks in raster order, so it numbers the
    components by the first block (rows 2i..2i+1, columns 2j..2j+1) that
    holds a pixel of theirs; the set pixels of one block are all
    8-adjacent, so no two components share that block.  scipy labels
    them and they are renumbered by that key."""
    mask = np.asarray(mask)
    labels, num = ndimage.label(mask != 0, structure=np.ones((3, 3), int))
    if num == 0:
        return 1, labels.astype(np.int32)
    ys, xs = np.nonzero(labels)
    key = (ys // 2).astype(np.int64) * ((mask.shape[1] + 1) // 2) + xs // 2
    first = np.full(num + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, labels[ys, xs], key)
    renumber = np.zeros(num + 1, np.int32)
    renumber[np.argsort(first[1:], kind="stable") + 1] = np.arange(1, num + 1, dtype=np.int32)
    return num + 1, renumber[labels]
