"""CER-parity harness: one engine's Page XML outputs against another's,
per benchmark config (the port of scripts/eval_parity.py, with its
arguments, output and exit codes): the BASELINE.md acceptance gate
(<= 0.1 % absolute CER delta against the reference engine) as one
command.

Per page, lines pair by id (the per-line-id CER of
``user_scripts/compare_page_xml_texts.py``), falling back to the
reading-order page text when fewer than half of the reference's ids
are in the hypothesis (two engines that detect their own layout number
their lines apart); the report says which mode each config used.  A
page's line pairs go to the host C++ edit distance in one call
(``levenshtein_batch_i32``).

Layout of the roots: flat XML folders (one config) or one subfolder a
config present in both:

  ref_root/config-1/*.xml   hyp_root/config-1/*.xml
  ref_root/config-5/*.xml   hyp_root/config-5/*.xml

Usage:
  python3 -m pero_ocr_tpu_torch.scripts.eval_parity --ref-root REF --hyp-root HYP \
      [--threshold 0.1] [--match auto|id|page]
  python3 -m pero_ocr_tpu_torch.scripts.eval_parity --self-test
"""

from __future__ import annotations

import argparse
import os
import sys

from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.sequence_alignment import levenshtein_batch


def _cer_pairs(pairs):
    """(reference characters, edit distance) summed over (ref, hyp) text
    pairs, stripped, in one call."""
    pairs = [(ref.strip(), hyp.strip()) for ref, hyp in pairs]
    distances = levenshtein_batch([(list(ref), list(hyp)) for ref, hyp in pairs])
    return sum(len(ref) for ref, _ in pairs), int(distances.sum())


def _page_text(page: PageLayout) -> str:
    """Transcriptions in reading order, newline-joined (the engine's
    region/line iteration order IS its reading order)."""
    return "\n".join(
        (line.transcription or "").strip()
        for line in page.lines_iterator()
    )


def compare_pages(ref_page, hyp_page, match: str):
    """(chars, distance, mode) for one page pair."""
    ref_lines = {
        ln.id: ln.transcription or "" for ln in ref_page.lines_iterator()
    }
    hyp_lines = {
        ln.id: ln.transcription or "" for ln in hyp_page.lines_iterator()
    }
    shared = set(ref_lines) & set(hyp_lines)
    id_overlap = len(shared) / max(len(ref_lines), 1)
    use_ids = match == "id" or (match == "auto" and id_overlap >= 0.5)
    if use_ids:
        chars, dist = _cer_pairs([(ref_lines[lid], hyp_lines[lid]) for lid in shared])
        # Reference lines the hypothesis missed entirely count as full
        # deletions (compare_page_xml_texts.py warns; a parity gate must
        # charge them).
        for lid in set(ref_lines) - shared:
            t = ref_lines[lid].strip()
            chars += len(t)
            dist += len(t)
        return chars, dist, "id"
    c, d = _cer_pairs([(_page_text(ref_page), _page_text(hyp_page))])
    return c, d, "page"


def compare_dirs(ref_dir: str, hyp_dir: str, match: str):
    """Aggregate (chars, distance, modes, n_pages, missing) over the
    XML files shared by both dirs."""
    ref_files = {
        f for f in os.listdir(ref_dir) if f.endswith(".xml")
    }
    hyp_files = {
        f for f in os.listdir(hyp_dir) if f.endswith(".xml")
    }
    chars = dist = 0
    modes = set()
    missing = sorted(ref_files - hyp_files)
    n_pages = 0
    for fn in sorted(ref_files & hyp_files):
        try:
            ref_page = PageLayout(file=os.path.join(ref_dir, fn))
            hyp_page = PageLayout(file=os.path.join(hyp_dir, fn))
        except Exception as e:  # noqa: BLE001 - report, keep evaluating
            print(f"warning: cannot load {fn}: {e}", file=sys.stderr)
            continue
        c, d, mode = compare_pages(ref_page, hyp_page, match)
        chars += c
        dist += d
        modes.add(mode)
        n_pages += 1
    return chars, dist, modes, n_pages, missing


def discover_configs(ref_root: str, hyp_root: str):
    """Per-config (name, ref_dir, hyp_dir); flat XML dirs count as one
    config named '.'."""

    def subdirs(root):
        return {
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        }

    def has_xml(root):
        return any(f.endswith(".xml") for f in os.listdir(root))

    if has_xml(ref_root) or not subdirs(ref_root):
        return [(".", ref_root, hyp_root)]
    shared = sorted(subdirs(ref_root) & subdirs(hyp_root))
    skipped = sorted(subdirs(ref_root) - subdirs(hyp_root))
    for name in skipped:
        print(
            f"warning: config '{name}' present in ref root only — skipped",
            file=sys.stderr,
        )
    return [
        (name, os.path.join(ref_root, name), os.path.join(hyp_root, name))
        for name in shared
    ]


def run(ref_root: str, hyp_root: str, threshold: float, match: str) -> int:
    rows = []
    all_pass = True
    for name, ref_dir, hyp_dir in discover_configs(ref_root, hyp_root):
        chars, dist, modes, n_pages, missing = compare_dirs(
            ref_dir, hyp_dir, match
        )
        cer = 100.0 * dist / max(chars, 1)
        ok = cer <= threshold and not missing and n_pages > 0
        all_pass = all_pass and ok
        rows.append((name, n_pages, chars, cer,
                     "+".join(sorted(modes)) or "-",
                     len(missing), "PASS" if ok else "FAIL"))

    print(f"{'config':<16} {'pages':>5} {'ref chars':>9} "
          f"{'CER delta %':>11} {'match':>7} {'missing':>7}  verdict")
    for name, n_pages, chars, cer, mode, n_missing, verdict in rows:
        print(f"{name:<16} {n_pages:>5} {chars:>9} {cer:>11.3f} "
              f"{mode:>7} {n_missing:>7}  {verdict}")
    print(
        f"acceptance: CER delta <= {threshold}% per config "
        f"(BASELINE.md north-star gate)"
    )
    return 0 if all_pass else 1


# ----------------------------------------------------------------------
def self_test() -> int:
    """Synthetic end-to-end check of the harness math: builds ref/hyp
    roots with a known injected error rate and asserts the reported CER
    (no model or device needed)."""
    import tempfile

    import numpy as np

    from pero_ocr_tpu_torch.core.layout import RegionLayout, TextLine

    def make_page(page_id, texts):
        page = PageLayout(id=page_id, page_size=(800, 600))
        region = RegionLayout(
            "r000",
            np.array([[0, 0], [600, 0], [600, 800], [0, 800]]),
        )
        for i, text in enumerate(texts):
            y = 40 + 30 * i
            line = TextLine(
                id=f"r000-l{i + 1:03d}",
                baseline=np.array([[10, y], [590, y]], float),
                heights=[20.0, 6.0],
                polygon=np.array(
                    [[10, y - 20], [590, y - 20], [590, y + 6], [10, y + 6]],
                    float,
                ),
            )
            line.transcription = text
            region.lines.append(line)
        page.regions.append(region)
        return page

    root = tempfile.mkdtemp(prefix="eval_parity_selftest_")
    ref_root = os.path.join(root, "ref")
    hyp_root = os.path.join(root, "hyp")
    texts = ["abcdefghij" * 4, "klmnopqrst" * 4]  # 40 chars each

    # Config 'exact': identical outputs -> 0.000 CER, PASS.
    # Config 'drift': one substitution per 40-char line -> 2.5 CER, FAIL
    # at the 0.1 threshold.
    for cfg, mangle in (("exact", False), ("drift", True)):
        os.makedirs(os.path.join(ref_root, cfg))
        os.makedirs(os.path.join(hyp_root, cfg))
        for p in range(3):
            ref_page = make_page(f"page{p}", texts)
            ref_page.to_pagexml(
                os.path.join(ref_root, cfg, f"page{p}.xml")
            )
            hyp_texts = [
                ("X" + t[1:]) if mangle else t for t in texts
            ]
            hyp_page = make_page(f"page{p}", hyp_texts)
            hyp_page.to_pagexml(
                os.path.join(hyp_root, cfg, f"page{p}.xml")
            )

    for name, ref_dir, hyp_dir in discover_configs(ref_root, hyp_root):
        chars, dist, modes, n_pages, missing = compare_dirs(
            ref_dir, hyp_dir, "auto"
        )
        cer = 100.0 * dist / max(chars, 1)
        expected = 0.0 if name == "exact" else 2.5
        assert abs(cer - expected) < 1e-9, (name, cer)
        assert modes == {"id"} and n_pages == 3 and not missing

    # Page-concat fallback: same text, line ids renamed -> id overlap 0,
    # auto mode must fall back to reading-order page text and report 0.
    ref_page = make_page("p", texts)
    hyp_page = make_page("p", texts)
    for ln in hyp_page.lines_iterator():
        ln.id = "renamed-" + ln.id
    c, d, mode = compare_pages(ref_page, hyp_page, "auto")
    assert mode == "page" and d == 0, (mode, d)

    rc = run(ref_root, hyp_root, threshold=0.1, match="auto")
    assert rc == 1, "drift config must fail the gate"
    print("self-test PASSED (exact=0.000 CER, drift=2.500 CER, "
          "page-mode fallback OK)")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ref-root", help="reference engine Page XML root")
    parser.add_argument("--hyp-root", help="this repo's Page XML root")
    parser.add_argument("--threshold", type=float, default=0.1,
                        help="max absolute CER delta %% (BASELINE.md gate)")
    parser.add_argument("--match", choices=["auto", "id", "page"],
                        default="auto",
                        help="line pairing: by line id, by reading-order "
                             "page text, or auto (id when >=50%% of ids "
                             "overlap)")
    parser.add_argument("--self-test", action="store_true",
                        help="run the synthetic harness check and exit")
    args = parser.parse_args(argv)

    if args.self_test:
        sys.exit(self_test())
    if not args.ref_root or not args.hyp_root:
        parser.error("--ref-root and --hyp-root are required")
    sys.exit(run(args.ref_root, args.hyp_root, args.threshold, args.match))


if __name__ == "__main__":
    main()
