"""Read and write folders of line-crop images (port of
pero_ocr_tpu/line_images_io.py): the port's own image codecs
(:mod:`pero_ocr_tpu_torch.utils.image_io`) in place of cv2's."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from pero_ocr_tpu_torch import UnreadableImage
from pero_ocr_tpu_torch.utils.image_io import imread, imwrite_jpeg

_IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
# cv2.imwrite's default JPEG quality.
JPEG_QUALITY = 95


def read_images(path: str) -> Tuple[List[np.ndarray], List[str]]:
    """(images, names without extension), sorted by name.  A file that
    ``cv2.imread`` returns None for is left out of the images (its name
    stays); one that cv2 reads and the port does not raises item 15's
    refusal."""
    names = sorted(f for f in os.listdir(path) if f.lower().endswith(_IMAGE_EXTENSIONS))
    images = []
    for name in names:
        try:
            images.append(imread(os.path.join(path, name)))
        except (UnreadableImage, OSError):
            continue
    return images, [os.path.splitext(n)[0] for n in names]


def write_images(path: str, images, names, extension: str = ".jpg") -> None:
    """Each image as ``<name><extension>``: JPEG at cv2.imwrite's default
    quality, byte-equal to it; other formats raise ValueError."""
    if extension.lower() not in (".jpg", ".jpeg"):
        raise ValueError(f"line images as {extension!r}: the port writes JPEG only")
    os.makedirs(path, exist_ok=True)
    for img, name in zip(images, names):
        imwrite_jpeg(os.path.join(path, name + extension), img, JPEG_QUALITY)
