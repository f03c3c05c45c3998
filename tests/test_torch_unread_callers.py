"""The callers that skip what cv2 cannot read tell it apart from what the
port does not read: they catch ``UnreadableImage`` ("Unable to read
image", cv2's None) and let item 15's refusal (a plain ``ValueError``
naming ROADMAP.md's item) propagate.  Each site is fed a GIF page, which
cv2 reads and the port refuses; ``line_images_io.read_images`` is also
held to the JAX one on a folder of TIFF pages the port once refused
(CIELab, JPEG 2000 compression, int16 samples), which cv2 reads.
"""

import cv2
import numpy as np
import pytest

from pero_ocr_tpu_torch import IMAGES, UnreadableImage
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document import pdf
from pero_ocr_tpu_torch.line_images_io import read_images
from pero_ocr_tpu_torch.scripts import convert_torchscript, select_embed_id
from tests.data.tiff.make_fixtures import base_tags, smooth, write_tiff


def _gif(path) -> str:
    """A GIF page at ``path`` (whatever its name says), which cv2 reads."""
    img = smooth(16, 16, 3, seed=1)
    ok, data = cv2.imencode(".gif", img)
    assert ok
    path.write_bytes(data.tobytes())
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is not None
    return str(path)


def _formerly_refused(folder) -> None:
    """The roadmap's folder: a CIELab, a JPEG 2000-compressed and an int16
    TIFF, each of which cv2 reads."""
    lab = smooth(9, 11, 3, seed=2)
    (folder / "a_cielab.tif").write_bytes(write_tiff(base_tags(9, 11, 8, 3, 8, 1), [lab.tobytes()]))
    (folder / "b_jpeg2000.tif").write_bytes(write_tiff(base_tags(9, 11, 8, 3, 2, 34712),
                                                       [lab.tobytes()]))
    int16 = np.arange(-4000, 4000, 81, dtype="<i2")[:99]
    (folder / "c_int16.tif").write_bytes(write_tiff(base_tags(9, 11, 16, 1, 1, 1, t339=(3, [2])),
                                                    [int16.tobytes()]))


def test_read_images_equals_jax_on_formerly_refused_tiffs(tmp_path):
    from pero_ocr_tpu import line_images_io as jax_line_images_io

    _formerly_refused(tmp_path)
    got, got_names = read_images(str(tmp_path))
    want, want_names = jax_line_images_io.read_images(str(tmp_path))
    assert got_names == want_names == ["a_cielab", "b_jpeg2000", "c_int16"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_read_images_skips_cv2_none_and_raises_the_refusal(tmp_path):
    (tmp_path / "none.tif").write_bytes(write_tiff(base_tags(9, 11, 8, 3, 2, 34925), [b"\0" * 297]))
    images, names = read_images(str(tmp_path))
    assert images == [] and names == ["none"]
    _gif(tmp_path / "page.png")
    with pytest.raises(ValueError, match=IMAGES) as e:
        read_images(str(tmp_path))
    assert not isinstance(e.value, UnreadableImage)


def test_select_embed_id_raises_the_refusal(tmp_path):
    (tmp_path / "images").mkdir()
    (tmp_path / "xml").mkdir()
    _gif(tmp_path / "images" / "page.png")
    (tmp_path / "xml" / "page.xml").write_text("<not read/>")
    with pytest.raises(ValueError, match=IMAGES) as e:
        select_embed_id.crops_from_images_and_xmls(None, str(tmp_path / "images"),
                                                    str(tmp_path / "xml"), 10)
    assert not isinstance(e.value, UnreadableImage)


def test_pdf_merger_raises_the_refusal(tmp_path):
    xml = tmp_path / "page.xml"
    xml.write_text(PageLayout(id="page", page_size=(16, 16)).to_pagexml_string())
    image = _gif(tmp_path / "page.png")
    with pytest.raises(ValueError, match=IMAGES) as e:
        pdf.Merger().merge(str(xml), image, str(tmp_path / "out.pdf"))
    assert "Unable to read image" not in str(e.value)
    none = tmp_path / "none.tif"
    none.write_bytes(write_tiff(base_tags(9, 11, 8, 3, 2, 34925), [b"\0" * 297]))
    with pytest.raises(ValueError, match="Unable to read image"):
        pdf.Merger().merge(str(xml), str(none), str(tmp_path / "out.pdf"))


def test_convert_torchscript_load_images_raises_the_refusal(tmp_path):
    _formerly_refused(tmp_path)
    (tmp_path / "d_none.tif").write_bytes(write_tiff(base_tags(9, 11, 8, 3, 2, 34925),
                                                     [b"\0" * 297]))
    assert len(convert_torchscript.load_images(str(tmp_path / "*.tif"), 10, (8, 8))) == 3
    _gif(tmp_path / "e_page.tif")
    with pytest.raises(ValueError, match=IMAGES) as e:
        convert_torchscript.load_images(str(tmp_path / "*.tif"), 10, (8, 8))
    assert not isinstance(e.value, UnreadableImage)
