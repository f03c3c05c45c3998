"""Naive reading order of a page's regions (port of
pero_ocr_tpu/layout_engines/naive_sorter.py, ``REGION_SORTER_NAIVE``):
the regions are clustered by their top edge, the clusters ordered top to
bottom by their first member and the members of each cluster top to
bottom.

The JAX package clusters with sklearn's ``DBSCAN(eps, min_samples=1)``;
:func:`dbscan_1d` is its copy for one dimension.
"""

from __future__ import annotations

from typing import List

import numpy as np

from pero_ocr_tpu_torch.core.layout import PageLayout


def dbscan_1d(values: np.ndarray, eps: float) -> np.ndarray:
    """``DBSCAN(eps=eps, min_samples=1).fit_predict(values[:, None])``:
    every point is a core point, so a cluster is a run of sorted values
    whose neighbours lie within ``eps``; clusters are numbered in the
    order of their first member, as sklearn numbers them."""
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    if values.size == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(values, kind="stable")
    runs = np.concatenate([[0], np.cumsum(np.diff(values[order]) > eps)])
    component = np.empty(values.size, np.int64)
    component[order] = runs
    _, first = np.unique(component, return_index=True)
    rank = np.empty(first.size, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(first.size)
    return rank[component]


class NaiveRegionSorter:
    def __init__(self, config=None, config_path: str = ""):
        if config is not None and hasattr(config, "getint"):
            self.width_denom = config.getint("ImageWidthDenominator", fallback=10)
        else:
            self.width_denom = 10

    def process_page(self, image, page_layout: PageLayout) -> PageLayout:
        if len(page_layout.regions) < 2:
            return page_layout
        eps = image.shape[1] // self.width_denom
        y_min = np.asarray([np.asarray(r.polygon)[:, 1].min() for r in page_layout.regions])
        order = self.sort_regions(y_min, eps)
        page_layout.regions = [page_layout.regions[i] for i in order]
        return page_layout

    @staticmethod
    def sort_regions(y_min: np.ndarray, eps: float) -> List[int]:
        """Region indices in reading order."""
        labels = dbscan_1d(y_min, max(eps, 1))
        clusters, first_member = np.unique(labels, return_index=True)
        cluster_order = sorted(clusters, key=lambda c: y_min[first_member[c]])
        order: List[int] = []
        for cluster in cluster_order:
            members = np.argwhere(labels == cluster).reshape(-1)
            order.extend(sorted(members, key=lambda i: y_min[i]))
        return order
