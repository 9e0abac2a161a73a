"""k-means for HuBERT pseudo-labels, host-side numpy (port of
espnet_tpu/ops/kmeans.py).

`kmeans_fit` seeds with k-means++ from `np.random.RandomState(seed)`, then
runs Lloyd's algorithm; `kmeans_assign` gives each row its nearest
centroid. The same inputs give the JAX package's centroids and labels: the
code is a copy, numpy on the host in both.
"""

from __future__ import annotations

import numpy as np


def kmeans_fit(x: np.ndarray, k: int, n_iter: int = 20,
               seed: int = 0) -> np.ndarray:
    """x (N, D) -> centroids (k, D), Lloyd's algorithm with k-means++ init."""
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    centroids = [x[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((x[:, None] - np.asarray(centroids)[None]) ** 2).sum(-1), axis=1)
        probs = d2 / max(d2.sum(), 1e-12)
        centroids.append(x[rng.choice(n, p=probs)])
    c = np.asarray(centroids)
    for _ in range(n_iter):
        labels = kmeans_assign(x, c)
        for j in range(k):
            pts = x[labels == j]
            if len(pts):
                c[j] = pts.mean(0)
    return c


def kmeans_assign(x: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """x (N, D), centroids (k, D) -> (N,) nearest-centroid ids (int32)."""
    # |x - c|^2 = |x|^2 - 2 x.c + |c|^2; |x|^2 does not change the argmin
    d = -2.0 * x @ centroids.T + (centroids ** 2).sum(-1)[None, :]
    return np.argmin(d, axis=1).astype(np.int32)
