"""Judge a run's answers against the reference's :class:`Accumulator`.

Every number compared is a count of answers outside what the reference
admits (limit 0) or a widest gap (limit from the readings kept in
``ldbench/limits/<cell>.json``):

- ``missing``: pairs the reference keeps, for certain, above the query's
  threshold (by more than ``ld_ref.BAND``) that an answer lacks;
- ``extra``: records of an answer that the reference has below the
  threshold for certain, or not at all, and records given twice;
- ``count_excess``: the summed distance of every count of a summary (pairs,
  pairs over a threshold, histogram bins, LD-decay bins) from the interval
  the reference admits, [certain, certain + uncertain];
- ``r2_gap``, ``d_gap``: the widest absolute gap of a record's r2 or D, or
  of a summary's r2 maximum, from the reference's;
- ``text_flips``: in a text answer at ``decimals`` digits, the values (D,
  D', r2) whose text differs from the reference's value rounded to as many
  digits, where the reference lies more than ``TEXT_BAND`` from a rounding
  boundary (a float32 program may round a value on the boundary either
  way);
- ``dp_gap``: the widest gap of D' over max(1, |reference D'|), infinite
  where one side is infinite and the other not;
- ``sum_gap``: the widest distance of a sum (r2 over a threshold, r2 and
  |D'| per decay bin) from the interval the reference admits, over the
  certain sum;
- ``prune_diff``: the sites a pruning answer keeps or drops otherwise than
  the reference's greedy sweep (``ld_ref.prune``), and positions it names
  that are no site; where a pair lies within the band of the threshold,
  only the kept pairs above it for certain count.
"""

from __future__ import annotations

import numpy as np

from ..reference import ld_ref
from ..reference.ld_ref import BAND, Accumulator

NUMBERS = ("missing", "extra", "count_excess", "text_flips", "r2_gap",
           "d_gap", "dp_gap", "sum_gap", "prune_diff")
# A float32 value of D, D' or r2 lies within a few 1e-7 of the float64 one
# (the session cells' r2_gap); 5e-6 leaves an order to spare.
TEXT_BAND = 5e-6


def _dist(x: float, lo: float, hi: float) -> float:
    return max(0.0, lo - x, x - hi)


class Judge:
    """Compares answers with one reference accumulator; ``site_pos`` maps
    answer positions to the reference's site indices, ``maf`` is the
    reference's minor fraction per site (for pruning)."""

    def __init__(self, acc: Accumulator, site_pos: np.ndarray,
                 maf: np.ndarray | None = None):
        self.acc = acc
        self.maf = maf
        self.pos = np.asarray(site_pos, dtype=np.int64)
        self.s = len(self.pos)
        rec = acc.records()
        key = rec["i"] * self.s + rec["j"]
        order = np.argsort(key)
        self.key = key[order]
        self.rec = {k: v[order] for k, v in rec.items()}
        self.out = dict.fromkeys(NUMBERS, 0.0)

    def _gap(self, name: str, value: float) -> None:
        self.out[name] = max(self.out[name], float(value))

    def _index(self, pos_a, pos_b) -> np.ndarray:
        """Reference record index of each answer pair, -1 where absent."""
        ia = np.searchsorted(self.pos, pos_a)
        ib = np.searchsorted(self.pos, pos_b)
        ok = (ia < self.s) & (ib < self.s)
        ok &= self.pos[np.minimum(ia, self.s - 1)] == pos_a
        ok &= self.pos[np.minimum(ib, self.s - 1)] == pos_b
        lo, hi = np.minimum(ia, ib), np.maximum(ia, ib)
        key = lo * self.s + hi
        at = np.searchsorted(self.key, key)
        at_c = np.minimum(at, max(len(self.key) - 1, 0))
        found = ok & (len(self.key) > 0)
        if len(self.key):
            found &= self.key[at_c] == key
        return np.where(found, at_c, -1)

    def records(self, ans: dict, threshold: float,
                decimals: int | None = None) -> None:
        """An answer of records (``pos_a``, ``pos_b``, ``d``, ``dp``,
        ``r2``) due complete above ``threshold``; ``decimals`` where it was
        text at that many digits."""
        pa = np.asarray(ans["pos_a"], dtype=np.int64)
        pb = np.asarray(ans["pos_b"], dtype=np.int64)
        idx = self._index(pa, pb)
        hit = idx >= 0
        extra = int((~hit).sum())
        if hit.any():
            _u, cnt = np.unique(idx[hit], return_counts=True)
            extra += int((cnt - 1).sum())
            j = idx[hit]
            r2_ref = self.rec["r2"][j]
            extra += int((r2_ref <= threshold - BAND).sum())
            self._gap("r2_gap", np.abs(np.asarray(ans["r2"], np.float64)[hit]
                                       - r2_ref).max())
            self._gap("d_gap", np.abs(np.asarray(ans["d"], np.float64)[hit]
                                      - self.rec["d"][j]).max())
            self._gap("dp_gap", _dp_gap(np.asarray(ans["dp"], np.float64)[hit],
                                        self.rec["dp"][j]))
            if decimals is not None:
                for f in ("d", "dp", "r2"):
                    self.out["text_flips"] += _flips(
                        np.asarray(ans[f], np.float64)[hit], self.rec[f][j],
                        decimals)
        due = (~self.rec["unc"]) & (self.rec["r2"] > threshold + BAND)
        got = np.zeros(len(self.key), dtype=bool)
        got[idx[hit]] = True
        self.out["missing"] += float((due & ~got).sum())
        self.out["extra"] += float(extra)

    def top_pairs(self, ans: dict, k: int) -> None:
        """The k strongest pairs: each judged as a record; complete above
        the weakest returned r2."""
        r2 = np.asarray(ans["r2"], np.float64)
        if len(r2) < k:
            # Fewer than k pairs is right only where the reference keeps
            # no more than that many.
            self.out["missing"] += float(max(
                0, int(self.acc.kept_sure) - len(r2)))
        floor = float(r2.min()) if len(r2) else np.inf
        lowest = min(self.acc.spec.thresholds) - BAND
        if floor <= lowest + BAND:
            # The reference collected records above its lowest threshold
            # only: a top-k reaching below it cannot be judged complete.
            self.out["missing"] += 1.0
        self.records(ans, floor)

    def summarize(self, ans: dict, threshold: float) -> None:
        a = self.acc
        self.out["count_excess"] += _dist(float(ans["n_pairs"]), a.kept_sure,
                                          a.kept_sure + a.kept_unc)
        n_s, n_u, s_s, s_u = a.summ[threshold]
        self.out["count_excess"] += _dist(float(ans["n_over_threshold"]),
                                          n_s, n_s + n_u)
        self._gap("sum_gap", _dist(float(ans["r2_sum_over_threshold"]),
                                   s_s, s_s + s_u) / max(abs(s_s), 1e-300))
        hi = max(a.r2_max_sure, a.r2_max_unc)
        got = ans["r2_max"]
        self._gap("r2_gap", np.inf if got is None
                  else _dist(float(got), a.r2_max_sure, hi))

    def histogram(self, ans: dict) -> None:
        a = self.acc
        for b, n in enumerate(ans["n_pairs"]):
            self.out["count_excess"] += _dist(
                float(n), a.hist_sure[b], a.hist_sure[b] + a.hist_unc[b])

    def decay(self, ans: dict) -> None:
        a = self.acc
        for b in range(len(ans["n_pairs"])):
            sure, unc = a.decay_sure[b], a.decay_unc[b]
            got = (ans["n_pairs"][b], ans["r2_sum"][b],
                   ans["abs_d_prime_sum"][b], ans["n_d_prime_finite"][b])
            for c in (0, 3):
                self.out["count_excess"] += _dist(float(got[c]), sure[c],
                                                  sure[c] + unc[c])
            for c in (1, 2):
                d = _dist(float(got[c]), sure[c], sure[c] + unc[c])
                self._gap("sum_gap", d / max(abs(sure[c]), 1e-300)
                          if d else 0.0)


    def prune(self, ans: np.ndarray, threshold: float) -> None:
        """A pruning answer: the positions of the sites it keeps."""
        kept_ref, exact = ld_ref.prune(self.acc, self.maf, threshold)
        got_pos = np.asarray(ans, dtype=np.int64)
        at = np.searchsorted(self.pos, got_pos)
        known = (at < self.s) & (self.pos[np.minimum(at, self.s - 1)]
                                 == got_pos)
        got = np.zeros(self.s, dtype=bool)
        got[at[known]] = True
        diff = float((~known).sum())
        if exact:
            diff += float((got != kept_ref).sum())
        else:
            rec = self.acc.records()
            over = (rec["r2"] > threshold + BAND) & ~rec["unc"]
            diff += float((over & got[rec["i"]] & got[rec["j"]]).sum())
        self.out["prune_diff"] += diff


def _flips(text: np.ndarray, ref: np.ndarray, decimals: int) -> float:
    """Values whose text differs from ``ref`` rounded to ``decimals``
    digits, ``ref`` clear of the rounding boundary by ``TEXT_BAND``."""
    fin = np.isfinite(ref) & np.isfinite(text)
    q = ref[fin] * 10.0 ** decimals
    clear = np.abs(q - np.floor(q) - 0.5) > TEXT_BAND * 10.0 ** decimals
    want = np.round(q) / 10.0 ** decimals
    off = np.abs(text[fin] - want) > 0.01 * 10.0 ** -decimals
    return float((clear & off).sum())


def _dp_gap(got: np.ndarray, ref: np.ndarray) -> float:
    both_inf = np.isinf(got) & np.isinf(ref) & (np.sign(got) == np.sign(ref))
    fin = np.isfinite(got) & np.isfinite(ref)
    bad = ~(both_inf | fin)
    if bad.any():
        return float("inf")
    if not fin.any():
        return 0.0
    return float((np.abs(got[fin] - ref[fin])
                  / np.maximum(1.0, np.abs(ref[fin]))).max())


def verdict(numbers: dict[str, float], limits: dict[str, float]
            ) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers the
    cell's limits name: every one within its limit."""
    out, ok = {}, True
    for name, lim in limits.items():
        value = numbers[name]
        out[name] = {"value": value, "limit": float(lim)}
        if not value <= lim:      # NaN fails
            ok = False
    return ok, out
