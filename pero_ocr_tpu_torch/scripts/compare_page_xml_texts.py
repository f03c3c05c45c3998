"""Per-line-id CER between hypothesis and reference Page XML folders: the
port of scripts/compare_page_xml_texts.py, with its arguments and
output.

    python3 -m pero_ocr_tpu_torch.scripts.compare_page_xml_texts \\
        --hyp hyp_xml/ --ref ref_xml/ [--print-all]

Each page's lines go to the host C++ edit distance in one call
(``levenshtein_batch_i32``); the totals are the per-line sums.
"""

from __future__ import annotations

import argparse
import os
import sys

from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.sequence_alignment import levenshtein_batch


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--print-all", action="store_true",
                        help="Report CER per page xml")
    parser.add_argument("--hyp", required=True,
                        help="Folder with page xmls whose CER will be computed")
    parser.add_argument("--ref", required=True,
                        help="Folder with reference page xml")
    return parser.parse_args(argv)


def read_page_xml(path):
    try:
        return PageLayout(file=path)
    except Exception:
        print(f'Warning: unable to load page xml "{path}"')
        return None


def compare_page_layouts(hyp_fn, ref_fn):
    hyp_page = read_page_xml(hyp_fn)
    ref_page = read_page_xml(ref_fn)
    if hyp_page is None or ref_page is None:
        return None

    hyp_lines = {line.id: line.transcription or "" for line in hyp_page.lines_iterator()}
    ref_lines = {line.id: line.transcription or "" for line in ref_page.lines_iterator()}

    pairs = []
    for line_id in set(hyp_lines) | set(ref_lines):
        if line_id not in hyp_lines:
            sys.stderr.write(f'Warning: Line "{line_id}" missing in "{hyp_fn}"\n')
            continue
        if line_id not in ref_lines:
            continue
        pairs.append((list(ref_lines[line_id].strip()), list(hyp_lines[line_id].strip())))
    char_sum = sum(len(ref) for ref, _ in pairs)
    char_dist = int(levenshtein_batch(pairs).sum())
    return char_sum, char_dist


def print_result(name, nb_errors, ref_len):
    if ref_len > 0:
        print(f"{name} {100.0 * nb_errors / ref_len:.2f} % CER [ {nb_errors} / {ref_len} ]")
    else:
        print(f"{name} N/A % CER [ {nb_errors} / {ref_len} ]")


def main(argv=None):
    args = parse_arguments(argv)
    xml_files = set(f for f in os.listdir(args.ref) if os.path.splitext(f)[1] == ".xml")
    xml_files |= set(f for f in os.listdir(args.hyp) if os.path.splitext(f)[1] == ".xml")

    total_sum = 0
    total_dist = 0
    for xml_file in sorted(xml_files):
        result = compare_page_layouts(
            os.path.join(args.hyp, xml_file), os.path.join(args.ref, xml_file))
        if result is None:
            continue
        char_sum, char_dist = result
        if args.print_all:
            print_result(xml_file, char_dist, char_sum)
        total_sum += char_sum
        total_dist += char_dist

    print_result("summary", total_dist, total_sum)


if __name__ == "__main__":
    main()
