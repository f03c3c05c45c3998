"""Merge the Page XML and logits of N OCR engines by each line's mean
confidence: the port of scripts/merge_ocr_results.py, with its
arguments, output and files.

    python3 -m pero_ocr_tpu_torch.scripts.merge_ocr_results --output-path out/ \
        engine_a/ engine_b/ [--filter-list ids.txt] [--min-confidence 0.5] \
        [--fix-arabic-order]

Every input folder holds ``<page>.xml`` and ``<page>.logits`` with the
same line ids; for each line the transcription with the highest mean
character confidence (``core/confidence_estimation.get_line_confidence``)
wins, with its logits.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

import numpy as np

from pero_ocr_tpu_torch.core.arabic import ArabicHelper
from pero_ocr_tpu_torch.core.confidence_estimation import get_line_confidence
from pero_ocr_tpu_torch.core.layout import PageLayout


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge results of multiple OCR engines by picking the "
                    "most confident transcription for each text line. Input "
                    "directories must contain matching Page XML + logits "
                    "files with identical line IDs."
    )
    parser.add_argument("--output-path", required=True)
    parser.add_argument("--filter-list", help="Only process IDs in this file")
    parser.add_argument("input_paths", metavar="input_paths", type=str,
                        nargs="+")
    parser.add_argument("--min-confidence", type=float, default=0,
                        help="Remove lines below this confidence.")
    parser.add_argument("--fix-arabic-order", action="store_true",
                        help="Export sequential order of Arabic text.")
    return parser.parse_args(argv)


def get_confidences(line):
    if line.transcription:
        char_map = {c: i for i, c in enumerate(line.characters)}
        labels = np.asarray([char_map.get(c, 0) for c in line.transcription])
        try:
            return get_line_confidence(line, labels)
        except ValueError:
            print("ERROR: zero-length logit slice in get_line_confidence().")
            return np.ones(len(line.transcription)) * 0.5
    return np.asarray([])


def merge_layouts(page_layouts):
    merged_layout = page_layouts[0]
    all_lines = [layout.lines_iterator() for layout in page_layouts]
    for lines in zip(*all_lines):
        merged_line = lines[0]
        for line in lines:
            if line.id != merged_line.id:
                print(f"ERROR: Line ID mismatch in layout {merged_layout.id}.")
                sys.exit(-1)
        best_confidence = 0
        for line in lines:
            confidences = get_confidences(line)
            line_confidence = confidences.mean() if confidences.size else -10
            if line_confidence > best_confidence:
                best_confidence = line_confidence
                merged_line.transcription = line.transcription
                merged_line.logits = line.logits
                merged_line.characters = line.characters
                merged_line.transcription_confidence = line_confidence
    return merged_layout


def main(argv=None):
    args = parse_arguments(argv)
    os.makedirs(args.output_path, exist_ok=True)

    files = [
        f for f in os.listdir(args.input_paths[0])
        if os.path.splitext(f)[1].lower() == ".xml"
    ]
    if args.filter_list:
        with open(args.filter_list) as f:
            wanted = set(f.read().split())
        files = [f for f in files if os.path.splitext(f)[0] in wanted]

    arabic_helper = ArabicHelper()

    for xml_file in sorted(files):
        print(xml_file)
        layouts = []
        for input_path in args.input_paths:
            try:
                layout = PageLayout(file=os.path.join(input_path, xml_file))
                layout.load_logits(
                    os.path.join(
                        input_path, os.path.splitext(xml_file)[0] + ".logits"
                    )
                )
                layouts.append(layout)
            except KeyboardInterrupt:
                traceback.print_exc()
                print("Terminated by user.")
                sys.exit()
            except Exception as e:
                print(
                    f'ERROR: Failed to load "{xml_file}" from "{input_path}".'
                )
                print(e)
                traceback.print_exc()
        if not layouts:
            continue

        merged = merge_layouts(layouts)

        if args.min_confidence > 0:
            for region in merged.regions:
                region.lines = [
                    l for l in region.lines
                    if l.transcription_confidence
                    and l.transcription_confidence > args.min_confidence
                ]

        if args.fix_arabic_order:
            for line in merged.lines_iterator():
                if line.transcription and arabic_helper.is_arabic_line(
                    line.transcription
                ):
                    line.transcription = arabic_helper.label_form_to_string(
                        line.transcription
                    )

        merged.to_pagexml(os.path.join(args.output_path, xml_file))
        merged.save_logits(
            os.path.join(
                args.output_path, os.path.splitext(xml_file)[0] + ".logits"
            ),
            missing_line_logits_ok=True,
        )


if __name__ == "__main__":
    main()
