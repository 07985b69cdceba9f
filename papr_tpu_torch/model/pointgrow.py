"""Point-cloud growing by kNN interpolation, host-side
(``papr_tpu/model/pointgrow.py``; numpy + scipy, no device code).

Behavioral spec: reference models/utils.py:9-109 (``add_points_knn``): pick
growth sites (random / sparsity ranked by kNN-distance statistics / influence
score extremes), then synthesize each new point from its k nearest neighbours
(duplicate with a shared random offset, or mean / random-convex /
random-softmax / inverse-distance-weighted blends). Influence scores and
per-point features are interpolated with the same weights.

Runs on host numpy + scipy KDTree between training steps, like the
reference (its growth also runs on CPU, models/model.py:360-376). The rng is
explicit for reproducibility.
"""

from __future__ import annotations

import numpy as np
import scipy.special
from scipy.spatial import KDTree


def add_points_knn(coords: np.ndarray, influ_scores: np.ndarray, add_num: int,
                   k: int, comb_type: str = "mean", sample_type: str = "random",
                   sample_k: int = 10, point_features: np.ndarray | None = None,
                   rng: np.random.Generator | None = None):
    """Returns (new_coords, n_new, new_influ_scores, new_features)."""
    rng = rng or np.random.default_rng()
    pc = KDTree(coords)
    N = coords.shape[0]

    # Step 1: growth sites.
    if N <= add_num and "random" in comb_type:
        inds = rng.choice(N, add_num, replace=True)
    elif N <= add_num:
        inds = np.arange(N)
    elif sample_type == "random":
        inds = rng.choice(N, add_num, replace=False)
    elif sample_type.startswith("top-knn-"):
        assert k >= 2
        stat = sample_type.split("-")[-1]
        nns_dists, _ = pc.query(coords, k=sample_k)
        reducer = {"std": np.std, "mean": np.mean,
                   "max": np.max, "min": np.min}[stat]
        inds = np.argsort(reducer(nns_dists, axis=-1))[-add_num:]
    elif sample_type == "influ-scores-max":
        inds = np.argsort(influ_scores.squeeze(-1))[-add_num:]
    elif sample_type == "influ-scores-min":
        inds = np.argsort(influ_scores.squeeze(-1))[:add_num]
    else:
        raise NotImplementedError(sample_type)
    query_coords = coords[inds, :]

    # Step 2: synthesize new points.
    new_features = None
    if comb_type == "duplicate":
        noise = rng.standard_normal(3).astype(np.float32)
        noise = noise / np.linalg.norm(noise) * k
        new_coords = query_coords + noise
        new_influ = influ_scores[inds, :]
        if point_features is not None:
            new_features = point_features[inds, :]
        return new_coords, len(new_coords), new_influ, new_features

    nns_dists, nns_inds = pc.query(query_coords, k=k + 1)
    nns_dists = nns_dists.astype(np.float32)[:, 1:]  # drop self
    nns_inds = nns_inds[:, 1:]

    if comb_type == "mean":
        w = np.full((len(inds), k), 1.0 / k, np.float32)
    elif comb_type == "random":
        w = rng.uniform(0, 1, (len(inds), k)).astype(np.float32)
        w /= w.sum(axis=-1, keepdims=True)
    elif comb_type == "random-softmax":
        w = scipy.special.softmax(
            rng.standard_normal((len(inds), k)).astype(np.float32), axis=-1)
    elif comb_type == "weighted":
        inv = 1.0 / (nns_dists + 1e-6)
        w = inv / inv.sum(axis=-1, keepdims=True)
    else:
        raise NotImplementedError(comb_type)

    blend = lambda arr: np.einsum("qk,qkd->qd", w, arr[nns_inds, :])
    new_coords = blend(coords)
    new_influ = blend(influ_scores)
    if point_features is not None:
        new_features = blend(point_features)
    return new_coords, len(new_coords), new_influ, new_features
