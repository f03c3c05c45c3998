"""Time paragraph clustering's close-pair test both ways on the config-2
pages, on the host of the machine that holds the card.

    python3 cluster_ab.py

Runs ``chip_smoke.py``'s page pipeline (bench widths, CNN detection on
the card) once over 8 of its two-column pages and keeps the arguments of
every page's ``ParagraphClusterer.make_clusters``.  Then times
``make_clusters`` on each page with its close-pair test as shipped,
``geometry.polygons_close`` (a bounding-box reject and a vertex accept
before the segment distance: A), and with
``geometry.polygon_min_distance_batch(...) <= thresholds`` alone (B), in
the order A B B A, and counts the pages whose clusters differ.  Prints
the card's nvidia-smi line, then one JSON line with the times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from pero_ocr_tpu_torch.core import geometry


def segment_distance_only(polys, pairs, thresholds):
    return geometry.polygon_min_distance_batch(polys, pairs) <= thresholds


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    pipe = cs.bench_pipeline()
    pages, _ = cs.synthetic_pages(np.random.default_rng(0), cs.PAGE_BATCH, cs.TWO_COLUMNS)
    calls = []
    clusterer = pipe._clusterer
    clusterer.native = False  # A and B are numpy pair tests
    make_clusters = clusterer.make_clusters

    def kept(*args, **kwargs):
        calls.append((args, kwargs))
        return make_clusters(*args, **kwargs)

    clusterer.make_clusters = kept
    list(pipe.run(pages, page_batch=cs.PAGE_BATCH))
    clusterer.make_clusters = make_clusters
    n_lines = [len(args[0]) for args, _ in calls]

    shipped = geometry.polygons_close
    variants = {"A_polygons_close": shipped, "B_segment_distance_only": segment_distance_only}
    times = {name: [] for name in variants}
    clusters = {}
    for name in (*variants, *reversed(variants)):
        geometry.polygons_close = variants[name]
        try:
            out, per_page = [], []
            for args, kwargs in calls:
                t0 = time.perf_counter()
                out.append(np.asarray(make_clusters(*args, **kwargs)))
                per_page.append(1e3 * (time.perf_counter() - t0))
        finally:
            geometry.polygons_close = shipped
        times[name].append(float(np.mean(per_page)))
        clusters[name] = out
        print(f"{name}: {np.mean(per_page):.3f} ms a page (mean of {len(per_page)})", flush=True)
    differ = sum(not np.array_equal(a, b) for a, b in zip(*clusters.values()))
    print(smi)
    print(json.dumps({"pages": len(calls), "lines_per_page": n_lines,
                      "make_clusters_ms_per_page": times, "pages_whose_clusters_differ": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
