"""Where the port's ``convex_hull`` and OpenCV 5's ``cv2.convexHull``
part on near-collinear float32 points (ROADMAP.md section 3), and
whether a rule of "midpoint band plus relative cross product" explains
OpenCV's choice.

    python3 hull_probe.py [--sets 60000]

Needs cv2 (the JAX package's test dependency; the port does not use it).  Two
seeded families of point sets on y = 2x + 1, x uniform in [0, 100):
``triples`` (3 points, float32) and ``clouds`` (1 to 40 points, the
distribution of tests/test_torch_layout.py's
test_convex_hull_near_collinear_float32).  For each vertex that one hull
keeps and the other drops it takes, from its hull neighbours, the ratio
|d1| / |d2| of the two edges and the exact cross product over
|d1| |d2|, and reports whether any threshold on the latter, inside the
band 0.982 <= |d1| / |d2| <= 1.012 or outside it, separates OpenCV's
keeps from its drops.

Then the start-vertex lead (``--lead-sets``, clouds, seed 11): where the
hulls differ, whether cv2's hull is the port's with vertices dropped
(never the other way), whether the port's own last step
(``geometry.monotone_start``) on the port's hull without them gives
cv2's order (its other start vertex), where the dropped vertices fall in
x order, and how many hulls differ if a pass after the scan drops every
vertex whose cross product with its hull neighbours is 0 in float32
arithmetic.
"""

from __future__ import annotations

import argparse
from fractions import Fraction

import cv2
import numpy as np

from pero_ocr_tpu_torch.core import geometry


def exact_turn(p0, p1, p2):
    """(|d1| / |d2|, |exact cross| / (|d1| |d2|)) at p1."""
    f = [(Fraction(float(p[0])), Fraction(float(p[1]))) for p in (p0, p1, p2)]
    ax, ay = f[1][0] - f[0][0], f[1][1] - f[0][1]
    bx, by = f[2][0] - f[1][0], f[2][1] - f[1][1]
    d1, d2 = np.hypot(float(ax), float(ay)), np.hypot(float(bx), float(by))
    return d1 / d2, abs(float(ax * by - ay * bx)) / (d1 * d2)


def differing_vertices(rng, n_sets, sizes):
    """Per differing vertex: (kept by cv2, ratio, relative cross)."""
    out, differ = [], 0
    for _ in range(n_sets):
        x = rng.uniform(0, 100, int(rng.integers(*sizes)))
        pts = np.stack([x, 2 * x + 1], 1).astype(np.float32)
        want = cv2.convexHull(pts).reshape(-1, 2)
        got = geometry.convex_hull(pts)
        if want.shape == got.shape and np.array_equal(want, got):
            continue
        differ += 1
        for hull, other, by_cv2 in ((want, got, True), (got, want, False)):
            others = {tuple(p) for p in other}
            for k, p in enumerate(hull):
                if tuple(p) not in others:
                    out.append((by_cv2,) + exact_turn(hull[k - 1], p, hull[(k + 1) % len(hull)]))
    return differ, np.asarray(out, float).reshape(-1, 3)


def f32_cross_zero(pts, a, b, c) -> bool:
    """Whether (b - a) x (c - b) is 0 with float32 differences and
    products."""
    d1, d2 = pts[b] - pts[a], pts[c] - pts[b]
    return np.float32(d1[0] * d2[1]) - np.float32(d1[1] * d2[0]) == 0


def start_vertex_lead(rng, n_sets) -> None:
    differ = subset = explained = collinear_pass = 0
    ranks = []
    for _ in range(n_sets):
        x = rng.uniform(0, 100, int(rng.integers(1, 40)))
        pts = np.stack([x, 2 * x + 1], 1).astype(np.float32)
        want = [int(i) for i in cv2.convexHull(pts.reshape(-1, 1, 2),
                                               returnPoints=False).reshape(-1)]
        got = geometry._convex_hull_indices(pts)
        n = len(got)
        kept = [got[k] for k in range(n) if n < 3 or not f32_cross_zero(
            pts, got[k - 1], got[k], got[(k + 1) % n])]
        collinear_pass += geometry.monotone_start(kept) != want
        if got == want:
            continue
        differ += 1
        if set(want) < set(got):
            subset += 1
            explained += geometry.monotone_start([i for i in got if i in want]) == want
            rank = {int(i): r for r, i in enumerate(np.lexsort((pts[:, 1], pts[:, 0])))}
            ranks += [rank[i] for i in got if i not in want]
    print(f"lead, clouds: {differ} of {n_sets} hulls differ; in {subset} cv2's hull is the "
          f"port's without {len(ranks)} vertices, and in {explained} the port's start-vertex "
          f"step on that smaller hull gives cv2's order; x ranks of the dropped vertices "
          f"{min(ranks, default=None)}-{max(ranks, default=None)}, "
          f"{sum(r == 1 for r in ranks)} next to the leftmost point")
    print(f"  a pass dropping float32-collinear hull vertices: {collinear_pass} of {n_sets} "
          "hulls differ from cv2's")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sets", type=int, default=60000)
    parser.add_argument("--lead-sets", type=int, default=20000)
    args = parser.parse_args()
    for name, sizes, seed in (("triples", (3, 4), 2026), ("clouds", (1, 40), 11)):
        differ, v = differing_vertices(np.random.default_rng(seed), args.sets, sizes)
        print(f"{name}: {differ} of {args.sets} hulls differ, {len(v)} vertices in one hull only "
              f"({int(v[:, 0].sum()) if len(v) else 0} kept by cv2 alone)")
        if not len(v):
            continue
        band = (v[:, 1] >= 0.982) & (v[:, 1] <= 1.012)
        cv2_keeps = v[:, 0] > 0
        print(f"  in the midpoint band: {int(band.sum())}; relative cross of cv2's keeps "
              f"{np.sort(v[cv2_keeps, 2])[:3]}, of its drops (the port keeps them) up to "
              f"{v[~cv2_keeps, 2].max() if (~cv2_keeps).any() else None}")
        for region, sel in (("band", band), ("all", np.ones(len(v), bool))):
            keeps, drops = v[sel & cv2_keeps, 2], v[sel & ~cv2_keeps, 2]
            separable = not len(keeps) or not len(drops) or keeps.min() > drops.max()
            print(f"  {region}: a relative-cross threshold separates cv2's keeps from its "
                  f"drops: {separable}")
    start_vertex_lead(np.random.default_rng(11), args.lead_sets)


if __name__ == "__main__":
    main()
