"""Host-side NumPy sampling (the port's own copy of
ws3d_tpu/utils/sampling_np.py): weighted sampling without replacement and
the O(N k) greedy furthest-point sample the GT-database augmentation uses.
The device FPS is ws3d_tpu_torch.ops.sampling."""
from __future__ import annotations

import numpy as np


def weighted_sample(weights: np.ndarray, k: int,
                    rng: np.random.RandomState | None = None) -> np.ndarray:
    """k distinct indices drawn with probability proportional to the
    (clipped at 0) weights; fewer when fewer weights are positive."""
    rng = rng or np.random.RandomState()
    w = np.clip(np.asarray(weights, np.float64), 0, None)
    n = w.shape[0]
    k = min(k, int((w > 0).sum()))
    if k == 0:
        return np.zeros(0, np.int64)
    return rng.choice(n, size=k, replace=False, p=w / w.sum())


def greedy_furthest_point_sample(points: np.ndarray, k: int,
                                 start: int = 0) -> np.ndarray:
    """FPS on the host: the first pick is `start`, each next one the point
    furthest from those picked (the lowest index on a tie)."""
    n = points.shape[0]
    k = min(k, n)
    out = np.empty(k, np.int64)
    out[0] = start
    d2 = np.full(n, np.inf)
    last = start
    for i in range(1, k):
        diff = points - points[last]
        d2 = np.minimum(d2, np.einsum("nd,nd->n", diff, diff))
        last = int(d2.argmax())
        out[i] = last
    return out
