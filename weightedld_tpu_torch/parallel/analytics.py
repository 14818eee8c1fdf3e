"""Per-batch analytics reductions over one dispatched batch of pair stats.

Counterpart of the XLA runners of ``weightedld_tpu/parallel/sharded.py:
301-478`` (``make_topk_runner``, ``make_decay_runner``,
``make_hist_runner``) on the batch's ``[K, T, T]`` ``PairStats``.  Each
returns one small tensor on the stats' device, so the session copies one
tensor to the host per batch, and none reads anything back itself: a
session launches every shard's reduction before its first host read.

The LD-decay bins are a kernel: :func:`decay_batch` launches
``csrc/ld_reduce.cu`` (``ld_decay_bins``) for CUDA tensors, a pass per 8
bins that skips the tile pairs outside the bins' edges and reads each
other slot's keep, r2 and D' at most once, in place of the ~26 torch
passes over ``[K, T, T]`` of :func:`decay_batch_plain` (which XLA fuses
into one read in the JAX runner, and eager PyTorch cannot), and runs the
plain version for CPU tensors; any other device raises.  ``B`` bins take
``ceil(B / 8)`` launches, each counted in ``launches["ld_decay_bins"]``.  The top-k selection and the r2 histogram
are plain torch ops, glue around the LD kernels.

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

import numpy as np
import torch

from ..core.paircore import PairStats
from ..runtime.profiling import annotate

# Launches of the decay kernel: ceil(B / DECAY_CHUNK_BINS) a call of
# decay_batch on a card, B the bins.
launches = {"ld_decay_bins": 0}
DECAY_CHUNK_BINS = 8                # kChunkBins of csrc/ld_reduce.cu


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def topk_batch(st: PairStats, tile_i: torch.Tensor, tile_j: torch.Tensor, *,
               tile: int, k: int) -> torch.Tensor:
    """The batch's ``min(k, kept pairs)`` strongest kept pairs by r2,
    descending: :func:`pair_rows` of the winners, followed by ``-inf`` r2
    rows where the batch keeps fewer than k pairs, which the reader drops
    on the host (dropping them here would read their count back).  Ties at
    the k-th value are broken arbitrarily, as in ``make_topk_runner``.

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
    rows = pair_rows(st, tile_i, tile_j, cand[idx // t2], idx % t2,
                     tile=tile)
    rows[:, 4] = vals.to(torch.float64)      # a kept pair's r2; -inf unkept
    return rows


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


def decay_batch_plain(st: PairStats, tile_i: torch.Tensor,
                      tile_j: torch.Tensor, sm_pad: torch.Tensor,
                      edges: tuple, *, tile: int) -> torch.Tensor:
    """Per distance bin ``edges[b] <= |pos_b - pos_a| < edges[b+1]``: the
    kept-pair count, the float32 r2 sum, the float32 |D'| sum over kept
    pairs with a finite D', and that finite count (``make_decay_runner``),
    as a ``[B, 4]`` float64 tensor (counts exact).  ``sm_pad`` is the
    ``[S_pad]`` int32 site map; |distance| is orientation-free, so a packed
    (permuted) session bins as genomic order does.  The plain version of
    the ``ld_decay_bins`` kernel: :func:`decay_batch` runs it for CPU
    tensors."""
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


def decay_batch(st: PairStats, tile_i: torch.Tensor, tile_j: torch.Tensor,
                sm_pad: torch.Tensor, edges: tuple, *,
                tile: int) -> torch.Tensor:
    """:func:`decay_batch_plain`'s ``[B, 4]`` float64 bins: the
    ``ld_decay_bins`` kernel for CUDA stats, the plain version for CPU
    stats; any other device raises.  The open span (the batch loop's
    ``batch.reduce``) gets ``kernel`` and ``slots``, the pair slots read."""
    dev = st.r2.device
    annotate(kernel="ld_decay_bins" if dev.type == "cuda" else "plain",
             slots=st.r2.numel())
    if dev.type == "cpu":
        return decay_batch_plain(st, tile_i, tile_j, sm_pad, edges,
                                 tile=tile)
    if dev.type != "cuda":
        raise ValueError(f"decay_batch: unsupported device {dev}")
    return _decay_bins_cuda(st, tile_i, tile_j, sm_pad, edges, tile=tile)


def _decay_bins_cuda(st: PairStats, tile_i: torch.Tensor,
                     tile_j: torch.Tensor, sm_pad: torch.Tensor,
                     edges: tuple, *, tile: int) -> torch.Tensor:
    """Launch ``ld_decay_bins`` on the stats' device and its current
    stream.  The stats must be contiguous float32 ``[K, T, T]`` r2 and D'
    and bool keep (``d`` is not read): nothing is copied.  A tile index
    outside ``[0, S_pad / T)`` faults the kernel on the card, as the LD
    wrappers' ``torch._assert_async`` does, without an ATen launch."""
    from ..ops._build import load_library
    from ..ops.cuda_ld import _check
    from ..runtime.driver import validate_decay_edges

    dev = st.r2.device
    k = st.r2.shape[0] if st.r2.dim() == 3 else -1
    shape = (k, tile, tile)
    _check("r2", st.r2, torch.float32, shape, dev)
    _check("d_prime", st.d_prime, torch.float32, shape, dev)
    _check("keep", st.keep, torch.bool, shape, dev)
    _check("sm_pad", sm_pad, torch.int32, (None,), dev)
    if sm_pad.shape[0] % tile:
        raise ValueError(f"sm_pad has {sm_pad.shape[0]} entries, not a "
                         f"multiple of tile={tile}")
    for nm, t in (("tile_i", tile_i), ("tile_j", tile_j)):
        _check(nm, t, torch.int32, (k,), dev)
    e = np.asarray(validate_decay_edges(edges), dtype=np.int32)
    nb = e.size - 1
    out = torch.empty((nb, 4), dtype=torch.float64, device=dev)
    if k == 0:
        return out.zero_()
    vec = 4 if (tile % 4 == 0 and st.keep.data_ptr() % 4 == 0
                and all(t.data_ptr() % 16 == 0
                        for t in (st.r2, st.d_prime, sm_pad))) else 1
    max_grid = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    n_tiles = sm_pad.shape[0] // tile
    span = torch.empty((n_tiles, 2), dtype=torch.int32, device=dev)
    part = torch.empty((max_grid, min(nb, DECAY_CHUNK_BINS), 4),
                       dtype=torch.float64, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ld_decay_bins(
            st.keep.data_ptr(), st.r2.data_ptr(), st.d_prime.data_ptr(),
            sm_pad.data_ptr(), tile_i.data_ptr(), tile_j.data_ptr(),
            e.ctypes.data, span.data_ptr(), part.data_ptr(), out.data_ptr(),
            k, tile, n_tiles, nb, max_grid, vec, stream)
    if rc != 0:
        raise RuntimeError(f"ld_decay_bins launch failed with CUDA error {rc}")
    launches["ld_decay_bins"] += -(-nb // DECAY_CHUNK_BINS)
    return out


def hist_batch(st: PairStats, edges: torch.Tensor) -> torch.Tensor:
    """Kept-pair counts per r2 bin ``edges[b] <= r2 < edges[b+1]``
    (``make_hist_runner``), ``[B]`` int64.  ``edges`` is the float32 edge
    tensor on the stats' device, so the edges compare as float32, as the
    JAX runner compares its Python-float edges against float32 r2.

    One bucketize and one counting pass, whatever the number of bins.  On
    the card the count is ``torch.histc`` over the integer bucket with its
    range given, which reads nothing back; ``torch.bincount`` would read
    its input's maximum back to the host.  The CPU has no integer
    ``histc``, and there ``bincount`` reads nothing off a card."""
    n = edges.numel() + 1
    # bucketize(right=True) counts the edges <= r2: bin b is index b + 1,
    # and an unkept pair goes to index 0, below the first edge.
    idx = torch.where(st.keep, torch.bucketize(st.r2, edges, out_int32=True,
                                               right=True), 0)
    counts = (torch.histc(idx, n, 0, n) if idx.is_cuda
              else torch.bincount(idx.reshape(-1), minlength=n))
    return counts[1:-1].to(torch.int64)
