"""k-means on the port's primitives.

Counterpart of ``ramba_tpu/models/kmeans.py``: the pairwise distances'
cross term is one matmul, the assignment an ``argmin``, and the centroid
update a 2-D groupby sum (the generic lowering, group after group).
"""

from __future__ import annotations

import numpy as np


def kmeans(points, k: int, iters: int = 10, seed: int = 0):
    """Lloyd's algorithm.  ``points`` is (n, d) array-like.

    Returns (centroids (k, d) numpy array, labels (n,) numpy array)."""
    import ramba_tpu_torch as rt

    x = rt.asarray(points)
    n, d = x.shape
    rng = np.random.RandomState(seed)
    # the reference's draw, gathered on the card
    centroids = x[rng.choice(n, size=k, replace=False)]

    x_sq = (x * x).sum(1)  # (n,)
    labels = None
    for _ in range(iters):
        # ||x - c||^2 = |x|^2 - 2 x.c + |c|^2: the cross term is a matmul,
        # the rest broadcasts
        c_sq = (centroids * centroids).sum(1)  # (k,)
        cross = x @ centroids.T  # (n, k)
        dist = x_sq[:, None] - 2.0 * cross + c_sq[None, :]
        labels = rt.argmin(dist, axis=1)

        # the centroid update: per-cluster means through the segment sum
        lab_host = np.asarray(labels)
        gb = x.groupby(0, lab_host, num_groups=k)
        sums = gb.sum()  # (k, d)
        counts = np.maximum(np.bincount(lab_host, minlength=k), 1).astype(float)
        centroids = sums / rt.fromarray(counts)[:, None]

    return np.asarray(centroids), np.asarray(labels)
