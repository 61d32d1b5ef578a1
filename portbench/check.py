"""What decides `correct`: the numbers that hold the program's first
train steps against the reference's, and the check of the data layer's
batches against the blocks the benchmark wrote.

Numbers (each a share, 0 where the two sides agree):

- `data_rows_off`: rows of the recorded batches that are not rows of the
  block they were sampled from (with its label), or padding that is not
  zero. Exact: its limit is 0.
- `loss1_gap`, `loss2_gap`, `loss3_gap`: |L_program - L_reference| / |L_reference|
  of each of the first three steps.
- `logit_gap`: the first step's widest logit gap over the reference's
  largest |logit|.
- `logit_median_gap`: the median of the first step's logit gaps over the
  median |logit| of the reference: steady where a few points' logits
  swing (a near-tie among a point's neighbours resolved the other way),
  while a lower precision moves every point's.
- `grad_gap`: the worst leaf's gap between the norms of the first gradient
  (the program's as Adam holds it after one step: exp_avg / (1 - beta1)),
  over the larger of the reference leaf's norm and the median leaf's.
- `update_gap`: the same for the parameters' change over three steps,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (a bias before a BatchNorm: Adam moves it by
  round-off alone).

A cell's limits file names the numbers it compares and their limits; a
number without an entry is printed and not compared.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's reference gradient norm
_HASH = np.array([0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                  0x27D4EB2F165667C5, 0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53,
                  0x94D049BB133111EB, 0xBF58476D1CE4E5B9, 0x2545F4914F6CDD1D,
                  0xD6E8FEB86659FD93], np.uint64)


def _row_hash(points: np.ndarray, codes: np.ndarray) -> np.ndarray:
    words = np.concatenate([points.astype(np.float32).view(np.uint32),
                            codes.astype(np.uint32)[:, None]], axis=1).astype(np.uint64)
    return (words * _HASH[: words.shape[1]]).sum(axis=1, dtype=np.uint64)


class BlockIndex:
    """The written blocks by centre, for finding where a sample came from."""

    def __init__(self, data_dir: Path, manifest: dict):
        self.dir = data_dir
        rows = manifest["blocks"]
        self.keys = [(r[0], r[1], r[2]) for r in rows]
        self.centers = np.array([r[4:7] for r in rows], np.float64)
        self._hashes: dict = {}

    def hashes(self, i: int) -> np.ndarray:
        if i not in self._hashes:
            a, r, b = self.keys[i]
            with np.load(self.dir / f"area_{a}" / f"room{r:02d}_block{b:03d}.npz") as z:
                self._hashes[i] = np.sort(_row_hash(z["points"], z["labels"].argmax(axis=1)))
        return self._hashes[i]

    def rows_off(self, points: np.ndarray, onehot: np.ndarray, lengths: np.ndarray) -> int:
        """Rows of one (B, N, 9) batch that its blocks do not hold."""
        off = 0
        for p, y, n in zip(points, onehot, lengths.astype(np.int64)):
            off += int(np.count_nonzero(p[n:])) + int(np.count_nonzero(y[n:]))
            if n == 0:
                continue
            p, y = p[:n], y[:n]
            good_label = y.sum(axis=1) == 1
            center = np.median(p[:, :3].astype(np.float64) - p[:, 6:9], axis=0)
            d = np.abs(self.centers - center).max(axis=1)
            i = int(d.argmin())
            if d[i] > 1e-3:
                off += n
                continue
            table = self.hashes(i)
            h = _row_hash(p, y.argmax(axis=1))
            pos = np.clip(np.searchsorted(table, h), 0, len(table) - 1)
            off += int(np.count_nonzero((table[pos] != h) | ~good_label))
        return off


def _gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == 0 else math.inf)


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict[str, float]:
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), median leaf's norm)}."""
    names = [n for n in ref if keep is None or n in keep]
    norms = {n: float(ref[n].double().norm()) for n in names}
    median = float(np.median(list(norms.values()))) if names else 0.0
    out = {}
    for n in names:
        if n not in prog or prog[n].shape != ref[n].shape:
            out[n] = math.inf
        else:
            out[n] = abs(float(prog[n].double().norm()) - norms[n]) / max(norms[n], median)
    return out


def _worst(gaps: dict[str, float]) -> float:
    return max(gaps.values()) if gaps else math.nan


def numbers(prog: dict, ref: dict, weights: dict, rows_off: int) -> dict[str, float]:
    """The compared numbers of one run. `prog` and `ref` hold `losses`
    (three floats), `logits` (the first step's), `grads` (the first
    gradient by leaf) and `params` (after three steps); `weights` the
    starting parameters."""
    out = {"data_rows_off": float(rows_off)}
    for t in range(3):
        out[f"loss{t + 1}_gap"] = (_gap(prog["losses"][t], ref["losses"][t])
                                   if t < len(prog["losses"]) else math.inf)
    lp, lr = prog.get("logits"), ref["logits"]
    out["logit_gap"] = (float((lp.double() - lr.double()).abs().max() / lr.abs().max())
                        if lp is not None and lp.shape == lr.shape else math.inf)
    out["logit_median_gap"] = (float((lp.double() - lr.double()).abs().median()
                                     / lr.double().abs().median())
                               if lp is not None and lp.shape == lr.shape else math.inf)
    out["grad_gap"] = _worst(leaf_gaps(prog["grads"], ref["grads"]))
    out["update_gap"] = _worst(leaf_gaps(*deltas(prog, ref, weights), moved_leaves(ref)))
    return out


def moved_leaves(ref: dict) -> set[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    gnorm = {n: float(g.double().norm()) for n, g in ref["grads"].items()}
    floor = NEGLIGIBLE_GRAD * float(np.median(list(gnorm.values())))
    return {n for n, g in gnorm.items() if g >= floor}


def deltas(prog: dict, ref: dict, weights: dict) -> tuple[dict, dict]:
    """Each side's change of the parameters over the compared steps."""
    return ({n: prog["params"][n] - weights[n] for n in weights if n in prog["params"]},
            {n: ref["params"][n] - weights[n] for n in weights})


def judge(values: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that the
    limits name. A number that is not finite fails."""
    checks, ok = {}, True
    for name, entry in limits.get("numbers", {}).items():
        v = values.get(name, math.nan)
        checks[name] = {"value": v, "limit": entry["limit"]}
        if not (math.isfinite(v) and v <= entry["limit"]):
            ok = False
    if not checks:
        ok = False
    return ok, checks
