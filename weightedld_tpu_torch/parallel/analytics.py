"""Per-batch analytics reductions over one dispatched batch of pair stats.

Counterpart of the XLA runners of ``weightedld_tpu/parallel/sharded.py:
301-478`` (``make_topk_runner``, ``make_decay_runner``,
``make_hist_runner``), as plain torch ops on the batch's ``[K, T, T]``
``PairStats``: they are glue around the LD kernels, not kernels.  Each
returns one small tensor on the stats' device, so the session copies one
tensor to the host per batch.

The top-k selection keeps the TPU runner's tile-max prefilter
(``sharded.py:334-343``), re-measured on the card: over one 2,520-tile
batch of the 1,000 x 49,152 headline, k = 1,000, selection and gather took
3.20-3.49 ms with the prefilter and 4.56-4.77 ms with one flat
``torch.topk``, beside a 41.9 ms kernel launch (H100 80GB HBM3, 700 W;
``chip_smoke.py --phases build,profile``).  Not carried over: the
row-gather one-hot column select (``:352-361``), TPU plumbing for slow
element gathers; here the winners are read by index (``pair_rows``).
"""

from __future__ import annotations

import torch

from ..core.paircore import PairStats


def topk_batch(st: PairStats, tile_i: torch.Tensor, tile_j: torch.Tensor, *,
               tile: int, k: int) -> torch.Tensor:
    """The batch's ``min(k, kept pairs)`` strongest kept pairs by r2,
    descending: :func:`pair_rows` of the winners.  Ties at the k-th value
    are broken arbitrarily, as in ``make_topk_runner``.

    Only the pairs of the ``k`` tiles with the largest kept r2 compete:
    a pair strictly above the k-th value lies in a tile whose maximum at
    most k - 1 other tiles outrank (each outranking tile holds a pair at
    least as large), and where a tile holding a tied pair falls outside,
    the k candidate tiles each hold a pair at least as large anyway."""
    t2 = tile * tile
    masked = torch.where(st.keep, st.r2, torch.full_like(st.r2, -torch.inf))
    kt_n = min(k, masked.shape[0])
    cand = torch.topk(masked.amax(dim=(1, 2)), kt_n).indices
    sub = masked[cand].reshape(-1)
    vals, idx = torch.topk(sub, min(k, sub.numel()))
    idx = idx[vals > -torch.inf]                      # drop unkept slots
    return pair_rows(st, tile_i, tile_j, cand[idx // t2], idx % t2,
                     tile=tile)


def pair_rows(st: PairStats, tile_i: torch.Tensor, tile_j: torch.Tensor,
              kt: torch.Tensor, rem: torch.Tensor, *,
              tile: int) -> torch.Tensor:
    """``[m, 5]`` float64 rows ``(i, j, D, D', r2)`` of the batch's pairs
    at tile slots ``kt`` and in-tile offsets ``rem`` (row * tile + col),
    with global site indices (exact in float64): a plain index gather."""
    li, lj = rem // tile, rem % tile
    gi = tile_i.to(torch.int64)[kt] * tile + li
    gj = tile_j.to(torch.int64)[kt] * tile + lj
    f64 = torch.float64
    return torch.stack([gi.to(f64), gj.to(f64), st.d[kt, li, lj].to(f64),
                        st.d_prime[kt, li, lj].to(f64),
                        st.r2[kt, li, lj].to(f64)], dim=1)


def decay_batch(st: PairStats, tile_i: torch.Tensor, tile_j: torch.Tensor,
                sm_pad: torch.Tensor, edges: tuple, *,
                tile: int) -> torch.Tensor:
    """Per distance bin ``edges[b] <= |pos_b - pos_a| < edges[b+1]``: the
    kept-pair count, the float32 r2 sum, the float32 |D'| sum over kept
    pairs with a finite D', and that finite count (``make_decay_runner``),
    as a ``[B, 4]`` float64 tensor (counts exact).  ``sm_pad`` is the
    ``[S_pad]`` int32 site map; |distance| is orientation-free, so a packed
    (permuted) session bins as genomic order does."""
    li = torch.arange(tile, device=sm_pad.device, dtype=torch.int64)
    sma = sm_pad[tile_i.to(torch.int64)[:, None] * tile + li[None, :]]
    smb = sm_pad[tile_j.to(torch.int64)[:, None] * tile + li[None, :]]
    dist = (smb[:, None, :] - sma[:, :, None]).abs()        # [K, T, T] int32
    adp = st.d_prime.abs()
    dp_ok = torch.isfinite(adp)
    zero = torch.zeros((), dtype=st.r2.dtype, device=st.r2.device)
    rows = []
    for lo, hi in zip(edges, edges[1:]):
        m = st.keep & (dist >= lo) & (dist < hi)
        mf = m & dp_ok
        rows.append(torch.stack([
            m.sum().to(torch.float64),
            torch.where(m, st.r2, zero).sum().to(torch.float64),
            torch.where(mf, adp, zero).sum().to(torch.float64),
            mf.sum().to(torch.float64)]))
    return torch.stack(rows)


def hist_batch(st: PairStats, edges: tuple) -> torch.Tensor:
    """Kept-pair counts per r2 bin ``edges[b] <= r2 < edges[b+1]``
    (``make_hist_runner``), ``[B]`` int64.  The edges are compared as
    float32, as the JAX runner compares its Python-float edges against
    float32 r2."""
    e = torch.tensor(edges, dtype=torch.float32, device=st.r2.device)
    nb = len(edges) - 1
    # bucketize(right=True) counts the edges <= r2: bin b is index b + 1.
    b = torch.bucketize(st.r2, e, out_int32=True, right=True) - 1
    b = torch.where(st.keep & (b >= 0) & (b < nb), b,
                    torch.full_like(b, nb))
    return torch.bincount(b.reshape(-1), minlength=nb + 1)[:nb]
