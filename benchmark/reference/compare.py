"""The comparison that decides `correct`: the numbers read from a run's
outputs beside the reference's, each held to a limit that the cell's
traffic file states.

Inference (the checked batches' scenes, pooled). A detection pairs with
the other side's nearest one within 1 m in BEV, taken greedily from the
reference's highest score down. Compared:
- det_centre_median_m: the median 3-D centre distance of the pairs;
- det_score_median: the median |score difference| of the pairs;
- det_unmatched: the detections of either side without a partner, over
  the reference's count (a detection that stage 2 or finalize leaves out,
  or adds, enters no pair and shows here alone);
- proposal_unmatched_q75: a scene's proposal centres of either side with
  no partner within 0.1 m, over the reference's count, and of these shares
  the 75th percentile over the scenes (stage 1 and the proposal layer; a
  scene left out reads 1).
Detection sets are compared through the matcher, never slot for slot: in
a lower precision a box may move a little or a near-threshold one flip.
Printed, not compared: the pooled proposal share, the mean gaps and
live_gap (n_live's relative gap): the float8 control does not read three
times what sound runs read on them, and no fault that they alone would
catch is known.

Training (the set-up's first steps, before the window):
- batch_mismatch: elements of the loader's batches that differ from the
  reference loader's (exact);
- loss1_gap: |loss - reference loss| / |reference loss| of the first
  step (the later steps' gaps are printed: Adam's first updates turn the
  rounding of near-zero gradients into sign flips, so those gaps swing
  from seed to seed);
- grad_gap: the worst leaf's |norm of the program's first gradient -
  the reference's| over the larger of the reference's leaf norm and the
  median leaf's;
- grad_median_gap: the same gap of the median leaf (steady from seed to
  seed, where the worst leaf is one small leaf's noise: it separates the
  TF32 control, whose rounding reaches every leaf);
- change_gap: the same for the change of the parameters over the steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

MATCH_M = 1.0
PROPOSAL_M = 0.1


def match(ref: np.ndarray, prog: np.ndarray, radius: float):
    """Greedy pairs of rows (x, ., z, ...) within `radius` in BEV, ref
    rows taken in the order given -> (pairs [(i, j)], unmatched ref,
    unmatched prog)."""
    pairs, used = [], np.zeros(len(prog), bool)
    for i, r in enumerate(ref):
        if len(prog) == 0:
            break
        d = np.hypot(prog[:, 0] - r[0], prog[:, 2] - r[2])
        d[used] = np.inf
        j = int(np.argmin(d))
        if d[j] < radius:
            pairs.append((i, j))
            used[j] = True
    return pairs, len(ref) - len(pairs), int((~used).sum())


def detection_numbers(ref_scenes: List[np.ndarray],
                      prog_scenes: List[np.ndarray]) -> Dict[str, float]:
    """Rows (n, 8) [x, y, z, h, w, l, ry, score] a scene on each side."""
    n_ref = unmatched = 0
    dc, ds = [], []
    for ref, prog in zip(ref_scenes, prog_scenes):
        ref = ref[np.argsort(-ref[:, 7], kind="stable")]
        pairs, a, b = match(ref, prog, MATCH_M)
        n_ref += len(ref)
        unmatched += a + b
        for i, j in pairs:
            dc.append(float(np.linalg.norm(ref[i, 0:3] - prog[j, 0:3])))
            ds.append(abs(float(ref[i, 7] - prog[j, 7])))
    def stat(f, v):
        return float(f(v)) if v else 0.0
    return {"det_unmatched": unmatched / max(n_ref, 1),
            "det_centre_m": stat(np.mean, dc),
            "det_score": stat(np.mean, ds),
            "det_centre_median_m": stat(np.median, dc),
            "det_score_median": stat(np.median, ds),
            "det_centre_p90_m": stat(lambda v: np.percentile(v, 90), dc),
            "det_pairs": float(len(dc))}


def proposal_numbers(ref_centers, ref_valid, prog_centers,
                     prog_valid) -> Dict[str, float]:
    """Centres (B, K, 2) and validity (B, K) a side: the pooled share of
    unmatched proposals, and the 75th percentile over the scenes of each
    scene's share (a scene the program left without proposals reads 1)."""
    n_ref = unmatched = 0
    shares = []
    for rc, rv, pc, pv in zip(ref_centers, ref_valid, prog_centers,
                              prog_valid):
        r = np.stack([rc[rv][:, 0], np.zeros(int(rv.sum())), rc[rv][:, 1]],
                     axis=1)
        p = np.stack([pc[pv][:, 0], np.zeros(int(pv.sum())), pc[pv][:, 1]],
                     axis=1)
        _, a, b = match(r, p, PROPOSAL_M)
        n_ref += len(r)
        unmatched += a + b
        shares.append((a + b) / max(len(r), 1))
    return {"proposal_unmatched": unmatched / max(n_ref, 1),
            "proposal_unmatched_q75": float(np.percentile(shares, 75)),
            "proposal_shares": shares}


def count_gap(prog: float, ref: float) -> float:
    return abs(float(prog) - float(ref)) / max(abs(float(ref)), 1.0)


def read_kitti_txt(path: str) -> np.ndarray:
    """A KITTI result file -> (n, 8) [x, y, z, h, w, l, ry, score]."""
    rows = []
    with open(path) as f:
        for line in f:
            v = line.split()
            if not v:
                continue
            h, w, l, x, y, z, ry, s = (float(t) for t in v[8:16])
            rows.append([x, y, z, h, w, l, ry, s])
    return np.asarray(rows, np.float64).reshape(-1, 8)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median of ref)."""
    names = list(ref) if leaves is None else list(leaves)
    if not names:
        return 0.0
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def leaf_median_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """median over leaves of |prog - ref| / max(ref, median of ref)."""
    med = float(np.median([ref[k] for k in ref]))
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                            for k in ref]))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} and whether every number is within its
    limit; a number that is not finite fails."""
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"checks": checks, "correct": ok}
