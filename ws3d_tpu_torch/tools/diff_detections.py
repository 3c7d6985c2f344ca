"""Detection-level diff of two KITTI result directories (port of
tools/diff_detections.py): greedy centre matching between the two dumps,
then the max and mean deltas of centre, dims, ry and score over the matched
pairs, and the unmatched counts, as one JSON line.

It bounds the bf16 compute dtype against f32 at the detection level:

    python -m ws3d_tpu_torch.tools.eval_auto --synthetic --scenes 16 \\
        --bench_weights --set TPU.COMPUTE_DTYPE=bfloat16 \\
        --output_dir /tmp/eval_bf16
    python -m ws3d_tpu_torch.tools.eval_auto --synthetic --scenes 16 \\
        --bench_weights --output_dir /tmp/eval_f32
    python -m ws3d_tpu_torch.tools.diff_detections \\
        /tmp/eval_bf16/final_result/data /tmp/eval_f32/final_result/data

A txt file with no detection counts as zero rows (the JAX tool's loader
raises on one: np.array([]).reshape(0, -1) cannot infer a width).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

# KITTI result columns after the class, truncation, occlusion and alpha:
# bbox (4), h w l (3), x y z (3), ry, score
N_COLS = 12


def load_txt(path: str) -> np.ndarray:
    """(N, 12) float64 rows of one KITTI result file (N may be 0)."""
    with open(path) as f:
        rows = [[float(v) for v in line.split()[4:]] for line in f
                if line.split()]
    return np.array(rows, np.float64).reshape(len(rows), N_COLS)


def load_dir(d: str) -> dict:
    """{file name: load_txt rows} of every *.txt file in `d`."""
    return {os.path.basename(p): load_txt(p)
            for p in sorted(glob.glob(os.path.join(d, "*.txt")))}


def match(a: np.ndarray, b: np.ndarray, tol: float = 2.0) -> list:
    """Greedy global-argmin centre matching within `tol` metres: repeatedly
    pair the closest remaining (i, j) over the masked distance matrix."""
    if not len(a) or not len(b):
        return []
    d = np.linalg.norm(a[:, None, 7:10] - b[None, :, 7:10], axis=-1)
    pairs = []
    for _ in range(min(len(a), len(b))):
        i, j = np.unravel_index(np.argmin(d), d.shape)
        if d[i, j] > tol:
            break
        pairs.append((int(i), int(j)))
        d[i, :] = np.inf
        d[:, j] = np.inf
    return pairs


def diff(dir_a: str, dir_b: str, tol: float = 2.0) -> dict:
    """The JSON record of the JAX tool: detection counts, matched and
    unmatched, and max/mean deltas (centre m, dims m, ry rad, score)."""
    A, B = load_dir(dir_a), load_dir(dir_b)
    n_a = n_b = n_match = 0
    dc, dd, dry, ds = [], [], [], []
    for k in sorted(set(A) | set(B)):
        a = A.get(k, np.zeros((0, N_COLS)))
        b = B.get(k, np.zeros((0, N_COLS)))
        n_a += len(a)
        n_b += len(b)
        for i, j in match(a, b, tol):
            n_match += 1
            dc.append(float(np.linalg.norm(a[i, 7:10] - b[j, 7:10])))
            dd.append(float(np.max(np.abs(a[i, 4:7] - b[j, 4:7]))))
            r = abs(a[i, 10] - b[j, 10]) % (2 * np.pi)
            dry.append(float(min(r, 2 * np.pi - r)))
            ds.append(float(abs(a[i, 11] - b[j, 11])))

    def stats(v):
        v = np.asarray(v) if v else np.zeros(1)
        return {"max": round(float(v.max()), 4),
                "mean": round(float(v.mean()), 4)}

    return {"detections_a": n_a, "detections_b": n_b, "matched": n_match,
            "only_a": n_a - n_match, "only_b": n_b - n_match,
            "center_m": stats(dc), "dims_m": stats(dd),
            "ry_rad": stats(dry), "score": stats(ds)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("dir_a")
    p.add_argument("dir_b")
    p.add_argument("--tol", type=float, default=2.0)
    args = p.parse_args(argv)
    print(json.dumps(diff(args.dir_a, args.dir_b, args.tol)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
