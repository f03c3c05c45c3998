"""Searchable two-layer PDFs from page images and their Page XML or ALTO
files: the port of scripts/produce_2layer_pdf.py, with its arguments and
files.

    python3 -m pero_ocr_tpu_torch.scripts.produce_2layer_pdf xml_dir/ image_dir/ out_dir/ \\
        [--xml-drop-suffix _alto] [--font DejaVuSans.ttf]
    python3 -m pero_ocr_tpu_torch.scripts.produce_2layer_pdf --single-file page.xml \\
        page.jpg page.pdf

Files pair by name without suffix (after ``--xml-drop-suffix``); each
pair becomes ``<name>.pdf`` (:class:`pero_ocr_tpu_torch.document.pdf.Merger`).
``--font`` names the text layer's TrueType font; without it,
``find_unicode_font`` searches the system's fonts.
"""

from __future__ import annotations

import argparse
import logging
import os
import re

from pero_ocr_tpu_torch.document.pdf import Merger

IMG_EXTENSIONS = ["jpg", "jpeg", "png"]
IMG_REGEX = re.compile(f'.*\\.({"|".join(IMG_EXTENSIONS)})', re.IGNORECASE)


def drop_suffix(fn):
    return fn.rsplit(".", maxsplit=1)[0]


def discover_files(folder, is_relevant, key_postprocess=lambda x: x):
    fns = [fn for fn in os.listdir(folder)
           if os.path.isfile(os.path.join(folder, fn)) and is_relevant(fn)]
    return {key_postprocess(drop_suffix(fn)): os.path.join(folder, fn) for fn in fns}


def intersect_keys(dict_a, dict_b):
    intersection = [k for k in dict_a if k in dict_b]
    if len(dict_a) != len(intersection) or len(dict_b) != len(intersection):
        unmatched = [v for k, v in dict_a.items() if k not in intersection]
        unmatched += [v for k, v in dict_b.items() if k not in intersection]
        logging.warning("Not matched: %s", unmatched)
    return intersection


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--single-file", action="store_true",
                        help="Interpret paths as single files instead of folders")
    parser.add_argument("--xml-drop-suffix", default="",
                        help='String to drop from xml filename, e.g. "_alto"')
    parser.add_argument("--font", help="TrueType font of the text layer (default: the "
                                       "system's DejaVu Sans, find_unicode_font)")
    parser.add_argument("xml")
    parser.add_argument("image")
    parser.add_argument("out")
    args = parser.parse_args(argv)

    merger = Merger(args.font)
    if args.single_file:
        merger.merge(args.xml, args.image, args.out)
        return

    xml_dict = discover_files(args.xml, lambda fn: fn.endswith(".xml"),
                              lambda fn: fn.removesuffix(args.xml_drop_suffix))
    img_dict = discover_files(args.image, lambda fn: IMG_REGEX.fullmatch(fn) is not None)
    os.makedirs(args.out, exist_ok=True)
    for key in intersect_keys(xml_dict, img_dict):
        logging.info("Merging %s", key)
        merger.merge(xml_dict[key], img_dict[key], os.path.join(args.out, f"{key}.pdf"))


if __name__ == "__main__":
    main()
