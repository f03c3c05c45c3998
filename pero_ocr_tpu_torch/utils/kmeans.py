"""K-means, a numpy copy of scikit-learn 1.9.0's
``KMeans(n_clusters, random_state=...).fit(X)`` at its defaults, which
select_embed_id uses to pick representative writer embeddings:

- the data in its own float type (float32 stays float32, else float64),
  centred on its column means; ``tol`` = 1e-4 times the mean column
  variance of the uncentred data;
- one k-means++ initialization (``n_init="auto"``), ``2 + int(log(k))``
  local trials a centre, drawn from ``np.random.RandomState(seed)`` in
  sklearn's order (``choice`` for the first, ``uniform`` for the
  trials), squared distances as sklearn's ``_euclidean_distances``
  (float32 data upcast to float64, the result stored as float32);
- Lloyd iterations (at most 300): labels by ``|c|^2 - 2 x.c`` (the first
  of equals), centres as the running weighted sums in sample order,
  empty clusters relocated to the samples farthest from their centres
  (``np.argpartition``, as sklearn), the shift of each centre summed
  four squared terms at a time as sklearn's C loop does; stop when the
  labels repeat, or when the squared shift is within ``tol`` and then
  relabel once (the final E-step);
- the inertia, and the centres moved back by the column means.

Being a copy, it keeps sklearn's labels on the same data; its float sums
may differ from BLAS's in the last bits.
"""

from __future__ import annotations

import numpy as np

CHUNK_SIZE = 256  # sklearn's rows a Lloyd chunk (the sums run in sample order)


def row_norms_sq(x: np.ndarray) -> np.ndarray:
    """Squared row norms, as ``sklearn.utils.extmath.row_norms``."""
    return np.einsum("ij,ij->i", x, x)


def squared_distances(x: np.ndarray, y: np.ndarray, y_norm_sq=None) -> np.ndarray:
    """(len(x), len(y)) squared Euclidean distances as sklearn's
    ``_euclidean_distances(x, y, Y_norm_squared=y_norm_sq, squared=True)``."""
    if x.dtype == np.float32 or y.dtype == np.float32:
        # Upcast to float64 (sklearn's chunks hold all rows of these sizes);
        # float32 norms are not used.
        x64, y64 = x.astype(np.float64), y.astype(np.float64)
        yy = (y_norm_sq.reshape(1, -1) if y_norm_sq is not None and y_norm_sq.dtype != np.float32
              else row_norms_sq(y64)[None, :])
        d = -2 * (x64 @ y64.T)
        d += row_norms_sq(x64)[:, None]
        d += yy
        d = d.astype(np.float32)
    else:
        yy = y_norm_sq.reshape(1, -1) if y_norm_sq is not None else row_norms_sq(y)[None, :]
        d = -2 * (x @ y.T)
        d += row_norms_sq(x)[:, None]
        d += yy
    np.maximum(d, 0, out=d)
    return d


def kmeans_plusplus(x: np.ndarray, n_clusters: int, x_norm_sq: np.ndarray, weights: np.ndarray,
                    random_state: np.random.RandomState) -> np.ndarray:
    """sklearn's ``_kmeans_plusplus``: the initial centres."""
    n_samples = x.shape[0]
    centers = np.empty((n_clusters, x.shape[1]), dtype=x.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))
    center_id = random_state.choice(n_samples, p=weights / weights.sum())
    centers[0] = x[center_id]
    closest_dist_sq = squared_distances(centers[0, np.newaxis], x, x_norm_sq)
    current_pot = closest_dist_sq @ weights
    for c in range(1, n_clusters):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(weights * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1, out=candidate_ids)
        distance_to_candidates = squared_distances(x[candidate_ids], x, x_norm_sq)
        np.minimum(closest_dist_sq, distance_to_candidates, out=distance_to_candidates)
        candidates_pot = distance_to_candidates @ weights.reshape(-1, 1)
        best = np.argmin(candidates_pot)
        current_pot = candidates_pot[best]
        closest_dist_sq = distance_to_candidates[best]
        centers[c] = x[candidate_ids[best]]
    return centers


def _unrolled_sq_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise squared distances summed as sklearn's
    ``_euclidean_dense_dense``: four squared terms at a time, then the
    remainder, in the data's float type."""
    d = (a - b) * (a - b)
    n4 = d.shape[1] // 4 * 4
    result = np.zeros(d.shape[0], dtype=d.dtype)
    for k in range(0, n4, 4):
        result += ((d[:, k] + d[:, k + 1]) + d[:, k + 2]) + d[:, k + 3]
    for k in range(n4, d.shape[1]):
        result += d[:, k]
    return result


def _labels(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Each sample's nearest centre by ``|c|^2 - 2 x.c``, the first of
    equals."""
    labels = np.empty(x.shape[0], np.int32)
    norms = row_norms_sq(centers)
    for start in range(0, x.shape[0], CHUNK_SIZE):
        chunk = x[start: start + CHUNK_SIZE]
        dist = norms[None, :] + x.dtype.type(-2.0) * (chunk @ centers.T)
        labels[start: start + CHUNK_SIZE] = np.argmin(dist, axis=1)
    return labels


def _lloyd_step(x, weights, centers):
    """One E step and M step: (labels, new centres, centre shifts)."""
    n_clusters = centers.shape[0]
    labels = _labels(x, centers)
    sums = np.zeros_like(centers)
    weight_in = np.zeros(n_clusters, dtype=x.dtype)
    np.add.at(weight_in, labels, weights)
    np.add.at(sums, labels, x * weights[:, None])

    empty = np.where(np.equal(weight_in, 0))[0].astype(np.int32)
    if len(empty):
        distances = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(distances, -len(empty))[:-len(empty) - 1:-1].astype(np.int32)
        if np.max(distances) != 0:
            for new_id, far_idx in zip(empty, far):
                old_id = labels[far_idx]
                sums[old_id] -= x[far_idx] * weights[far_idx]
                sums[new_id] = x[far_idx] * weights[far_idx]
                weight_in[new_id] = weights[far_idx]
                weight_in[old_id] -= weights[far_idx]

    heaviest = np.argmax(weight_in)
    new = sums
    for j in range(n_clusters):
        if weight_in[j] > 0:
            new[j] *= x.dtype.type(1.0) / weight_in[j]
        else:
            new[j] = new[heaviest]
    shift = np.sqrt(_unrolled_sq_dist(new, centers))
    return labels, new, shift


class KMeans:
    """``sklearn.cluster.KMeans(n_clusters, random_state=...)`` at its
    other defaults (k-means++, one init, Lloyd, ``max_iter`` 300, ``tol``
    1e-4).  After :meth:`fit`: ``labels_``, ``cluster_centers_``,
    ``inertia_`` and ``n_iter_``."""

    def __init__(self, n_clusters: int = 8, random_state: int = 0, max_iter: int = 300,
                 tol: float = 1e-4):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.max_iter = max_iter
        self.tol = tol

    def fit(self, x) -> "KMeans":
        x = np.asarray(x)
        x = np.array(x, dtype=x.dtype if x.dtype in (np.float32, np.float64) else np.float64,
                     order="C", copy=True)
        if x.ndim != 2 or x.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={x.shape[0] if x.ndim == 2 else x.shape} should be "
                             f">= n_clusters={self.n_clusters}.")
        random_state = np.random.RandomState(self.random_state)
        weights = np.ones(x.shape[0], dtype=x.dtype)
        tol = np.mean(np.var(x, axis=0)) * self.tol if self.tol else 0
        x_mean = x.mean(axis=0)
        x -= x_mean
        x_norm_sq = row_norms_sq(x)
        centers = kmeans_plusplus(x, self.n_clusters, x_norm_sq, weights, random_state)

        labels_old = np.full(x.shape[0], -1, dtype=np.int32)
        strict = False
        for i in range(self.max_iter):
            labels, centers_new, shift = _lloyd_step(x, weights, centers)
            centers = centers_new
            if np.array_equal(labels, labels_old):
                strict = True
                break
            if (shift ** 2).sum() <= tol:
                break
            labels_old[:] = labels
        if not strict:  # the E step again, so that the labels match the centres
            labels = _labels(x, centers)
        inertia = float((_unrolled_sq_dist(x, centers[labels]) * weights).sum())

        self.labels_ = labels
        self.cluster_centers_ = centers + x_mean
        self.inertia_ = inertia
        self.n_iter_ = i + 1
        return self
