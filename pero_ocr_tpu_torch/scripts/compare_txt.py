"""CER and WER between ground-truth and hypothesis text folders, into a
CSV: the port of scripts/compare_txt.py, with its arguments, output and
file.

    python3 -m pero_ocr_tpu_torch.scripts.compare_txt --gt gt/ --hyp hyp/ \\
        --output scores.csv [--encoding utf-8]

A file's character and word distances go to the host C++ edit distance
in one call (``levenshtein_batch_i32``).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

from pero_ocr_tpu_torch.sequence_alignment import levenshtein_batch


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description="Compute CER and WER between GT and hypothesis txt files."
    )
    parser.add_argument("--gt", required=True, help="GT txt directory.")
    parser.add_argument("--hyp", required=True, help="Hypothesis txt directory.")
    parser.add_argument("--output", required=True, help="Output CSV path.")
    parser.add_argument("--encoding", default="utf-8")
    return parser.parse_args(argv)


def read_text(path, encoding):
    try:
        with open(path, "r", encoding=encoding) as f:
            return f.read()
    except Exception as e:
        print(f"Warning: could not read '{path}': {e}", file=sys.stderr)
        return None


def normalize_whitespace(text):
    return " ".join(text.split())


def error_rates(gt_text, hyp_text):
    """((CER, GT characters), (WER, GT words)) of one file; a rate is
    0.0 where the GT is empty."""
    gt, hyp = normalize_whitespace(gt_text), normalize_whitespace(hyp_text)
    gt_words, hyp_words = gt.split(), hyp.split()
    chars, words = levenshtein_batch([(list(gt), list(hyp)), (gt_words, hyp_words)])
    return ((float(chars) / len(gt) if gt else 0.0, len(gt)),
            (float(words) / len(gt_words) if gt_words else 0.0, len(gt_words)))


def main(argv=None):
    args = parse_arguments(argv)
    gt_files = {f for f in os.listdir(args.gt) if f.lower().endswith(".txt")}
    hyp_files = {f for f in os.listdir(args.hyp) if f.lower().endswith(".txt")}
    all_files = sorted(gt_files | hyp_files)
    if not all_files:
        print("No txt files found in the provided directories.", file=sys.stderr)
        sys.exit(1)

    rows = []
    for filename in all_files:
        gt_path = os.path.join(args.gt, filename)
        hyp_path = os.path.join(args.hyp, filename)
        if not os.path.exists(gt_path):
            print(f"Warning: '{filename}' missing in GT directory, skipping.",
                  file=sys.stderr)
            continue
        if not os.path.exists(hyp_path):
            print(f"Warning: '{filename}' missing in hypothesis directory, "
                  f"skipping.", file=sys.stderr)
            continue
        gt_text = read_text(gt_path, args.encoding)
        hyp_text = read_text(hyp_path, args.encoding)
        if gt_text is None or hyp_text is None:
            continue
        (cer, n_chars), (wer, n_words) = error_rates(gt_text, hyp_text)
        rows.append({
            "file_name": filename,
            "cer": f"{cer:.6f}",
            "wer": f"{wer:.6f}",
            "number_of_gt_characters": n_chars,
            "number_of_gt_words": n_words,
        })

    with open(args.output, "w", newline="", encoding="utf-8") as csvfile:
        writer = csv.DictWriter(csvfile, fieldnames=[
            "file_name", "cer", "wer",
            "number_of_gt_characters", "number_of_gt_words",
        ])
        writer.writeheader()
        writer.writerows(rows)

    print(f"\nResults written to '{args.output}' ({len(rows)} files processed).")

    total_chars = sum(int(r["number_of_gt_characters"]) for r in rows)
    total_words = sum(int(r["number_of_gt_words"]) for r in rows)
    if total_chars > 0:
        avg_cer = sum(
            float(r["cer"]) * int(r["number_of_gt_characters"]) for r in rows
        ) / total_chars
        print(f"Overall CER (weighted): {avg_cer * 100:.2f} %")
    if total_words > 0:
        avg_wer = sum(
            float(r["wer"]) * int(r["number_of_gt_words"]) for r in rows
        ) / total_words
        print(f"Overall WER (weighted): {avg_wer * 100:.2f} %")


if __name__ == "__main__":
    main()
