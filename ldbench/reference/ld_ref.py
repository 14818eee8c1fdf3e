"""Plain PyTorch reference of weighted LD, for judging the program's answers.

The semantics are those of upstream ``WeightedLD.py`` (site masks
``:44-98``, Henikoff weights ``:100-140``, per-pair LD ``:180-285``),
written here from that description in vectorized float64 torch: no kernel,
plan, cache or module of the program is used, and nothing the program
computed (masks, weights, packing) is read.  The reference is handed the
generated code matrix and works everything out again.

Codes: 0..3 = A C G T (a VCF's REF/ALT alleles 0/1 land on codes 0/1),
4 = gap / missing allele, 5 = UNKNOWN (ambiguity codes), which drops a
sequence out of every per-site and per-pair computation.

:func:`scan` walks the upper triangle of site pairs in square blocks, so
that it fits the card after the program has been freed, and folds each
block into an :class:`Accumulator` that holds what the benchmark compares:
the records above the lowest threshold asked for, the summaries per
threshold, the r2 histogram and the LD-decay bins.  Every decision that
rests on a float comparison (the reference's ``round(PA, 1) == 1.0`` skip,
``r2 > threshold``, a histogram edge) is made in float64 here and is marked
*uncertain* where the value lies within ``band`` of the boundary, since a
float32 program can rightly decide such a pair either way: the comparison
then admits either side for that pair and no other.

``precision="bf16"`` is the control: the weights rounded to bfloat16 and
the weighted products taken from bfloat16 operands into float32 sums, then
the pair algebra in float32 -- the arithmetic of a kernel that had traded
the exact weights for the bfloat16 tensor cores.  It must fail the
comparison.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

UNKNOWN = 5
N_ALLELES = 5

# Width of the uncertain zone around a float decision boundary (absolute,
# on PA / PB against 0.95 and on r2 against a threshold or an edge).  The
# program computes in float32 (relative error ~1e-7 per operation, a few
# times that through the pair algebra); 1e-5 is two orders above that and
# three below what a bfloat16 computation moves.
BAND = 1e-5


def site_masks(codes: torch.Tensor, min_acgt: float, min_variability: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hk_mask, ld_mask)`` of ``WeightedLD.py:44-98`` in float64:
    coverage = share of codes < 4 over all sequences, ``> min_acgt``;
    minor share over codes 0..4 = (total - major) / total, ``>=
    min_variability`` (0 where there is no minor)."""
    n = codes.shape[0]
    counts = torch.stack([(codes == s).sum(0) for s in range(N_ALLELES)]
                         ).to(torch.float64)                     # [5, S]
    concrete = (codes < 4).sum(0).to(torch.float64)
    hk = concrete / n > min_acgt
    total = counts.sum(0)
    major = counts.max(0).values
    minor = total - major
    frac = torch.where(minor > 0, minor / total.clamp(min=1), 0.0)
    return hk, hk & (frac >= min_variability)


def henikoff(codes: torch.Tensor, site_chunk: int = 8192) -> torch.Tensor:
    """``[N]`` float64 max-normalized weights (``WeightedLD.py:100-140``):
    a concrete cell adds ``1 / (unique_base * count of its code)``, where
    ``unique_base`` is the number of distinct rows among the five per-code
    count vectors; an UNKNOWN cell adds its site's mean contribution over
    the site's concrete (codes 0..4) cells."""
    n, s = codes.shape
    dev = codes.device
    counts = torch.stack([(codes == c).sum(0) for c in range(6)]
                         ).to(torch.float64)                     # [6, S]
    unique_base = float(torch.unique(counts[:N_ALLELES], dim=0).shape[0])
    present = (counts[:N_ALLELES] > 0).sum(0).to(torch.float64)
    concrete = counts[:N_ALLELES].sum(0)
    site_mean = torch.where(concrete > 0,
                            (present / unique_base) / concrete.clamp(min=1),
                            0.0)
    # Per site, the contribution of each code: [S, 6].
    table = torch.zeros((s, 6), dtype=torch.float64, device=dev)
    c5 = counts[:N_ALLELES].T
    table[:, :N_ALLELES] = torch.where(c5 > 0,
                                       1.0 / (unique_base * c5.clamp(min=1)),
                                       0.0)
    table[:, UNKNOWN] = site_mean
    w = torch.zeros(n, dtype=torch.float64, device=dev)
    for lo in range(0, s, site_chunk):
        hi = min(s, lo + site_chunk)
        blk = codes[:, lo:hi].to(torch.int64)                    # [N, B]
        tab = table[lo:hi]                                       # [B, 6]
        w += tab.T.reshape(-1)[blk * (hi - lo)
                               + torch.arange(hi - lo, device=dev)].sum(1)
    return w / w.max()


@dataclass
class Spec:
    """What the accumulator collects: the record thresholds asked for, the
    histogram edges (compared as float32 by the program, so given here as
    the float32 values) and the distance-bin edges of LD decay."""

    thresholds: tuple[float, ...] = (0.1,)
    hist_edges: tuple[float, ...] = ()
    decay_edges: tuple[int, ...] = ()


@dataclass
class Accumulator:
    spec: Spec
    n_sites: int
    band: float = BAND
    # Records: every kept-or-uncertain pair with r2 above the lowest
    # threshold less BAND, as site indices in the caller's order.
    rec_i: list = field(default_factory=list)
    rec_j: list = field(default_factory=list)
    rec_vals: list = field(default_factory=list)   # [n, 3] d, d', r2
    rec_unc: list = field(default_factory=list)    # skip decision uncertain
    # Summaries per threshold: "sure" sums and counts, and what the
    # uncertain pairs may add on top.
    summ: dict = field(default_factory=dict)
    hist_sure: np.ndarray | None = None
    hist_unc: np.ndarray | None = None
    decay_sure: np.ndarray | None = None           # [B, 4]
    decay_unc: np.ndarray | None = None
    kept_sure: float = 0.0
    kept_unc: float = 0.0
    r2_max_sure: float = -np.inf
    r2_max_unc: float = -np.inf

    def __post_init__(self):
        for t in self.spec.thresholds:
            self.summ[t] = np.zeros(4)   # n_sure, n_unc, sum_sure, sum_unc
        nb = max(0, len(self.spec.hist_edges) - 1)
        self.hist_sure = np.zeros(nb)
        self.hist_unc = np.zeros(nb)
        nd = max(0, len(self.spec.decay_edges) - 1)
        self.decay_sure = np.zeros((nd, 4))
        self.decay_unc = np.zeros((nd, 4))

    def records(self) -> dict[str, np.ndarray]:
        """The collected records: ``i``, ``j`` (site indices, i < j),
        ``d``, ``dp``, ``r2`` (float64) and ``unc`` (bool)."""
        if not self.rec_i:
            e = np.zeros(0)
            return {"i": e.astype(np.int64), "j": e.astype(np.int64),
                    "d": e, "dp": e, "r2": e, "unc": e.astype(bool)}
        vals = np.concatenate(self.rec_vals)
        return {"i": np.concatenate(self.rec_i),
                "j": np.concatenate(self.rec_j),
                "d": vals[:, 0], "dp": vals[:, 1], "r2": vals[:, 2],
                "unc": np.concatenate(self.rec_unc)}


def _onehot(codes: torch.Tensor, planes: torch.Tensor, dtype) -> torch.Tensor:
    """``[N, B, P]`` one-hot of ``codes`` [N, B] over ``planes``."""
    return (codes[:, :, None] == planes[None, None, :]).to(dtype)


def _pair_block(ca: torch.Tensor, cb: torch.Tensor, w: torch.Tensor,
                planes: torch.Tensor, dtype, band: float
                ) -> dict[str, torch.Tensor]:
    """Per-pair statistics of every pair (a in block A, b in block B):
    ``valid`` (the reference returns a value or the pair is uncertain),
    ``skip`` (the float ``round(PA, 1) == 1.0`` rule), ``unc`` (that rule's
    verdict within BAND), and ``d``, ``dp``, ``r2``."""
    n, ba = ca.shape
    bb = cb.shape[1]
    p = planes.numel()
    f64 = torch.float64
    oa = _onehot(ca, planes, f64)
    ob = _onehot(cb, planes, f64)
    ua = (ca == UNKNOWN).to(f64)
    ub = (cb == UNKNOWN).to(f64)
    # Per-pair allele counts at a over the sequences concrete-or-gap at b,
    # and at b over those at a: the column counts less the sequences the
    # partner's UNKNOWN cells drop.
    cnt_a = oa.sum(0)[:, None, :].expand(ba, bb, p)            # [Ba, Bb, P]
    cnt_b = ob.sum(0)[None, :, :].expand(ba, bb, p)
    if bool(ub.any()):
        cnt_a = cnt_a - (oa.reshape(n, ba * p).T @ ub).reshape(
            ba, p, bb).permute(0, 2, 1)
    if bool(ua.any()):
        cnt_b = cnt_b - (ob.reshape(n, bb * p).T @ ua).reshape(
            bb, p, ba).permute(2, 0, 1)

    def maj_dmin(cnt):
        # np.unique orders codes ascending and the reference sorts by count
        # with a stable sort: ties go to the lower code, which argmax's
        # first maximum gives over ascending planes.
        maj = cnt.argmax(-1)
        rest = cnt.scatter(-1, maj[..., None], -1.0)
        dmin = rest.argmax(-1)
        has2 = rest.gather(-1, dmin[..., None])[..., 0] > 0
        return maj, dmin, has2

    maj_a, dmin_a, has2_a = maj_dmin(cnt_a)
    maj_b, dmin_b, has2_b = maj_dmin(cnt_b)
    del cnt_a, cnt_b

    # Weighted joint table over every (allele at a, allele at b): [Ba, P,
    # Bb, P]; the four cells of each pair's {major, dominant minor}.
    if dtype == torch.float64:
        wa = (oa * w[:, None, None]).reshape(n, ba * p)
        joint = (wa.T @ ob.reshape(n, bb * p))
    else:   # the control: bfloat16 operands, float32 sums
        wb = w.to(torch.bfloat16)
        wa = (oa.to(torch.bfloat16) * wb[:, None, None]).reshape(n, ba * p)
        joint = torch.matmul(wa.T.float(), ob.reshape(n, bb * p).to(
            torch.bfloat16).float())
    joint = joint.reshape(-1)
    ia = torch.arange(ba, device=ca.device)[:, None]
    jb = torch.arange(bb, device=ca.device)[None, :]

    def cell(x, y):
        return joint[((ia * p + x) * bb + jb) * p + y]

    mm, md = cell(maj_a, maj_b), cell(maj_a, dmin_b)
    dm, dd = cell(dmin_a, maj_b), cell(dmin_a, dmin_b)
    del joint
    total = mm + md + dm + dd
    valid = has2_a & has2_b & (total > 0) & (mm + md > 0) & (mm + dm > 0)
    tot = torch.where(total > 0, total, 1.0)
    pa_maj, pb_maj = (mm + md) / tot, (mm + dm) / tot
    pa_min, pb_min = (dm + dd) / tot, (md + dd) / tot
    # The reference's round(PA, 1) == 1.0 on a numpy float64: rint(10 PA).
    skip = (torch.round(pa_maj * 10) == 10) | (torch.round(pb_maj * 10) == 10)
    unc = ((pa_maj - 0.95).abs() < band) | ((pb_maj - 0.95).abs() < band)
    o_mm, o_md, o_dm, o_dd = mm / tot, md / tot, dm / tot, dd / tot
    t0 = pa_maj * pb_maj - o_mm
    t1 = pa_min * pb_min - o_dd
    t2 = -(pa_maj * pb_min - o_md)
    t3 = -(pa_min * pb_maj - o_dm)
    d = (t0 + t1 + t2 + t3) / 4.0
    neg = d < 0
    den_n = torch.maximum(-o_dd, -o_mm)
    den_n = torch.where(den_n == 0, torch.minimum(-o_dd, -o_mm), den_n)
    den_p = torch.minimum(o_dm, o_md)
    den_p = torch.where(den_p == 0, torch.maximum(o_dm, o_md), den_p)
    den = torch.where(neg, den_n, den_p)
    dp = torch.where(den != 0, d / torch.where(den != 0, den, 1.0),
                     torch.inf * torch.sign(d))
    r2 = d * d / torch.where(valid, pa_maj * pa_min * pb_maj * pb_min, 1.0)
    out_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    return {"valid": valid, "skip": skip, "unc": unc,
            "d": d.to(out_dtype), "dp": dp.to(out_dtype),
            "r2": r2.to(out_dtype)}


def _bins(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Index of the half-open bin ``edges[b] <= x < edges[b+1]``, -1 below
    the first edge and len(edges) - 1 at or above the last."""
    return torch.bucketize(x, edges, right=True) - 1


def _fold(acc: Accumulator, st: dict, pair: torch.Tensor, ia0: int, jb0: int,
          pos: torch.Tensor) -> None:
    """Fold one block's statistics into ``acc``.  ``pair`` marks the pairs
    of the block that belong to the triangle (i < j)."""
    spec, band = acc.spec, acc.band
    base = pair & st["valid"]
    sure = base & ~st["skip"] & ~st["unc"]        # kept, for certain
    unc = base & st["unc"]                        # kept or not: either
    r2 = st["r2"].to(torch.float64)
    f = torch.float64
    acc.kept_sure += float(sure.sum())
    acc.kept_unc += float(unc.sum())
    if bool(sure.any()):
        acc.r2_max_sure = max(acc.r2_max_sure, float(r2[sure].max()))
    if bool(unc.any()):
        acc.r2_max_unc = max(acc.r2_max_unc, float(r2[unc].max()))
    for t in spec.thresholds:
        over = r2 > t + band
        near = (r2 - t).abs() <= band
        s_sure = sure & over
        s_unc = (sure & near) | (unc & (r2 > t - band))
        row = acc.summ[t]
        row[0] += float(s_sure.sum())
        row[1] += float(s_unc.sum())
        row[2] += float(torch.where(s_sure, r2, 0.0).sum())
        row[3] += float(torch.where(s_unc, r2, 0.0).sum())
    # Records above the lowest threshold (less BAND), certain or not.
    lo = min(spec.thresholds) - band
    take = (sure | unc) & (r2 > lo)
    if bool(take.any()):
        ii, jj = torch.nonzero(take, as_tuple=True)
        vals = torch.stack([st["d"][ii, jj].to(f), st["dp"][ii, jj].to(f),
                            r2[ii, jj]], 1)
        acc.rec_i.append((ii + ia0).cpu().numpy())
        acc.rec_j.append((jj + jb0).cpu().numpy())
        acc.rec_vals.append(vals.cpu().numpy())
        acc.rec_unc.append(unc[ii, jj].cpu().numpy())
    if len(spec.hist_edges) > 1:
        edges = torch.tensor(spec.hist_edges, dtype=f, device=r2.device)
        nb = len(spec.hist_edges) - 1
        b_lo, b_hi = _bins(r2 - band, edges), _bins(r2 + band, edges)
        pool = sure | unc
        certain = sure & (b_lo == b_hi)
        for b in range(nb):
            acc.hist_sure[b] += float((certain & (b_lo == b)).sum())
            acc.hist_unc[b] += float(
                (pool & ~certain & (b_lo <= b) & (b_hi >= b)).sum())
    if len(spec.decay_edges) > 1:
        dist = (pos[jb0:jb0 + pair.shape[1]][None, :]
                - pos[ia0:ia0 + pair.shape[0]][:, None]).abs()
        dedges = torch.tensor(spec.decay_edges, dtype=dist.dtype,
                              device=dist.device)
        bidx = _bins(dist, dedges)
        adp = st["dp"].to(f).abs()
        fin = torch.isfinite(adp)
        for b in range(len(spec.decay_edges) - 1):
            inb = bidx == b
            for tgt, m in ((acc.decay_sure, sure & inb),
                           (acc.decay_unc, unc & inb)):
                mf = m & fin
                tgt[b] += (float(m.sum()),
                           float(torch.where(m, r2, 0.0).sum()),
                           float(torch.where(mf, adp, 0.0).sum()),
                           float(mf.sum()))


def scan(codes: np.ndarray | torch.Tensor, weights: torch.Tensor,
         positions: np.ndarray, spec: Spec, device: str | torch.device,
         block: int = 4096, precision: str = "f64",
         band: float = BAND) -> Accumulator:
    """Every pair ``i < j`` of the ``[N, S]`` code matrix (the kept sites,
    in the caller's order) under ``weights``, folded into an
    :class:`Accumulator`; ``positions`` are the sites' positions (VCF POS
    or FASTA column), the distances of LD decay.  ``band=0`` makes every
    decision on this computation's own values (the control's answers)."""
    dev = torch.device(device)
    codes_t = torch.as_tensor(codes).to(dev)
    n, s = codes_t.shape
    present = torch.unique(codes_t)
    planes = present[present < N_ALLELES].to(torch.int8)
    w = weights.to(dev, torch.float64)
    pos = torch.as_tensor(np.asarray(positions, dtype=np.int64)).to(dev)
    dtype = torch.float64 if precision == "f64" else torch.bfloat16
    acc = Accumulator(spec, s, band)
    starts = list(range(0, s, block))
    for a0 in starts:
        a1 = min(s, a0 + block)
        ca = codes_t[:, a0:a1]
        for b0 in starts:
            if b0 < a0:
                continue
            b1 = min(s, b0 + block)
            cb = codes_t[:, b0:b1]
            st = _pair_block(ca, cb, w, planes, dtype, band)
            gi = torch.arange(a0, a1, device=dev)[:, None]
            gj = torch.arange(b0, b1, device=dev)[None, :]
            _fold(acc, st, gi < gj, a0, b0, pos)
            del st
    return acc


def minor_fraction(codes: torch.Tensor) -> np.ndarray:
    """``[S]`` float64 share of the non-major codes among codes 0..4 at each
    site (the reference's all-minor definition, ``WeightedLD.py:79-87``),
    0 where a site has none."""
    counts = torch.stack([(codes == c).sum(0) for c in range(N_ALLELES)]
                         ).to(torch.float64)
    total = counts.sum(0)
    minor = total - counts.max(0).values
    return (minor / total.clamp(min=1)).cpu().numpy()


def prune(acc: Accumulator, maf: np.ndarray, threshold: float
          ) -> tuple[np.ndarray, bool]:
    """Greedy LD pruning in the PLINK ``--indep-pairwise`` manner: the pairs
    with r2 above ``threshold`` swept in (site a, site b) order, a < b, and
    where both are still kept, the one with the lower minor fraction
    dropped (ties: b).  Returns ``(kept [S] bool, exact)``: ``exact`` is
    false where a pair's r2 or skip decision lies within the band of its
    boundary, so that a float32 program may rightly sweep another set."""
    rec = acc.records()
    near = np.abs(rec["r2"] - threshold) <= acc.band
    over = rec["r2"] > threshold + acc.band
    exact = not bool((near | (rec["unc"] & (rec["r2"] > threshold
                                            - acc.band))).any())
    i, j = rec["i"][over & ~rec["unc"]], rec["j"][over & ~rec["unc"]]
    kept = np.ones(acc.n_sites, dtype=bool)
    for a, b in zip(*(x[np.lexsort((j, i))] for x in (i, j))):
        if kept[a] and kept[b]:
            if maf[a] < maf[b]:
                kept[a] = False
            else:
                kept[b] = False
    return kept, exact
