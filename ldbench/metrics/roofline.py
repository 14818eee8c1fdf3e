"""The least work of the LD problem, for the kernels' roofline shares.

The count reads only the problem's shapes: the true number of sequences
N, the site pairs a kernel class evaluated, and for the general class the
allele planes P present.  It does not depend on the weight mode, the tile,
the entry point or the padding the program chose, so a kernel that is
redesigned is measured against the same work.

Template: ``chip_smoke.py:960-975``'s least work with unit weights (one
weight pass), each input byte counted once and each output byte once:

- factorized class (per-site major / dominant minor, no UNKNOWN in the
  way): the four weighted {major, dominant minor} cells of a pair, N MACs
  each, so 8 N integer operations per pair;
- general class (major and dominant minor per pair): the 2 P per-pair
  allele counts and then the four cells, (2 P + 4) N MACs per pair;
- bytes: the int8 codes (N per site), float32 weights (4 N), and per pair
  the outputs D, D', r2 (float32) and keep (one byte).

Peak: 1,979 TOP/s (the H100 SXM's dense int8 rate, the highest the card
has for this arithmetic) and 3.35 TB/s of HBM, both at the card's full
700 W.
"""

from __future__ import annotations

import numpy as np

PEAK_OPS = 1979e12
PEAK_BYTES = 3.35e12
OUT_BYTES_PER_PAIR = 13


def least_work(kind: str, n_seqs: int, n_pairs: int, n_sites: int,
               planes: int = 2) -> tuple[float, float]:
    """``(operations, bytes)`` of ``n_pairs`` pairs over ``n_sites`` sites
    of class ``kind`` (``"majmin"`` or ``"general"``)."""
    if kind == "majmin":
        macs = 4 * n_seqs * n_pairs
    elif kind == "general":
        macs = (2 * planes + 4) * n_seqs * n_pairs
    else:
        raise ValueError(f"unknown kernel class {kind!r}")
    nbytes = (n_seqs * n_sites + 4 * n_seqs
              + OUT_BYTES_PER_PAIR * n_pairs)
    return 2.0 * macs, float(nbytes)


def least_seconds(kind: str, n_seqs: int, n_pairs: int, n_sites: int,
                  planes: int = 2) -> tuple[float, str]:
    """``(seconds, bound)``: the larger of operations over the peak rate
    and bytes over the HBM rate, and which of the two it is."""
    ops, nbytes = least_work(kind, n_seqs, n_pairs, n_sites, planes)
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def tile_pairs(n_sites: int, tile: int, tile_i, tile_j) -> int:
    """Real site pairs (i < j) of the plan's tile pairs: a diagonal tile
    pair holds n (n - 1) / 2, any other n_i n_j, where a tile holds the
    sites left of ``n_sites``."""
    ti = np.asarray(tile_i, dtype=np.int64)
    tj = np.asarray(tile_j, dtype=np.int64)
    ni = np.clip(n_sites - ti * tile, 0, tile)
    nj = np.clip(n_sites - tj * tile, 0, tile)
    return int(np.where(ti == tj, ni * (ni - 1) // 2, ni * nj).sum())


def session_work(sess, planes: int) -> dict:
    """Per kernel class, the pairs one scan of ``sess`` evaluates, from its
    plan and its factorized / general split: ``{class: {"n_seqs",
    "n_pairs", "n_sites", "planes"}}``."""
    plan = sess.plan
    ti, tj = np.asarray(plan.tile_i), np.asarray(plan.tile_j)
    tiles = sess.phase_tiles
    if sess.hybrid_safe is not None:
        sel = {"majmin": np.asarray(sess.hybrid_safe, dtype=bool)}
        sel["general"] = ~sel["majmin"]
    else:
        kind = "majmin" if tiles.get("majmin") else "general"
        sel = {kind: np.ones(len(ti), dtype=bool)}
    out = {}
    for kind, m in sel.items():
        if not m.any():
            continue
        out[kind] = {"n_seqs": int(sess.n_seqs),
                     "n_pairs": tile_pairs(sess.n_sites, sess.cfg.tile,
                                           ti[m], tj[m]),
                     "n_sites": int(sess.n_sites), "planes": int(planes)}
    return out
