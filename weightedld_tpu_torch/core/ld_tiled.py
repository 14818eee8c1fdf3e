"""The XLA tile engine's batch function, and the device-side record
compaction over a batch of tiles.

:func:`pad_alignment` and :func:`tile_stats_batch` are the counterparts of
``weightedld_tpu/core/ld_tiled.py:27-76``, the tile function of
``DriverConfig(engine="xla")`` sessions: each tile pair's ``[N, T]`` column
slices become one-hot ``[N, 5T]`` operands, their joint tables come from two
batched float32 matrix products over N (``torch.bmm``, cuBLAS on the card,
in true float32 whatever the process's matmul precision), and the port's
``finalize_pair_tile`` turns them into the ``[K, T, T]`` stats.  No kernel
of this package runs: it is the JAX package's portable engine, and on the
card the whole-function library yardstick of the CUDA kernels.

The compaction is the counterpart of ``round_fixed_exact`` and
``compact_tile_stats`` (``ld_tiled.py:82-310``).  A batch's survivors are the
pairs of ``keep & (r2 > threshold)`` over the flattened ``[K, T, T]``
batch, gathered in (tile, row, col) order, the order of the JAX
compactions.  Two forms:

* :func:`compact_tile_stats`, the exact path: ``torch.nonzero``, which
  reads the survivor count back and so waits for the device;
* :func:`compact_fixed`, the speculative path: the survivors packed into a
  fixed ``capacity`` with no host read, the count left on the device.  The
  caller reads the count with the block and falls back to the exact path
  when it exceeds the capacity.  Its block is ``[capacity, 5]`` int32:
  global sites ``i, j`` and the float32 bits of D, D', r2.

Both take ``scale = 10^d`` to round D and r2 to d decimals on the device
(:func:`round_decimals`), as ``stream(decimals=d)`` yields them.  The JAX
package ships such records in a 12-byte fixed-point wire (word 0 the
tile-local pair, word 1 the D and r2 quanta); the port keeps the float32
block: on an H100 the wire saved no time (``PERF.md``).

The JAX slot search (mask rows bit-packed by an MXU dot, then a binary
search per slot) is TPU plumbing.  Here the flattened mask's bytes (0 or
1 each) are read as int64 words of 8 pairs, and ``word % 255`` is the
word's survivor count (256 = 1 mod 255, so the remainder sums the
bytes): one elementwise pass that casts nothing.  The counts' inclusive
prefix gives the batch's count (its last entry) and, by one
``searchsorted`` per slot, the word of the (s+1)-th survivor; a prefix
over that word's 8 flags finds its column.  On the H100 a reduction over
groups of the bool mask costs a cast of the whole mask to int32 and a
slow narrow reduction, 1.7 ms per 2,520-tile batch against the
4.6 ms kernel (``PERF.md``).  All are stream-ordered torch ops that read
nothing back.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import N_ALLELES, UNKNOWN
from .paircore import PairStats, f32_products, finalize_pair_tile


def pad_alignment(alignment: np.ndarray, tile: int) -> np.ndarray:
    """Pad ``[N, S]`` codes to ``[N, S_pad]`` with UNKNOWN columns (copy
    of ``ld_tiled.py:27-36``)."""
    n, s = alignment.shape
    s_pad = -(-s // tile) * tile
    if s_pad == s:
        return alignment
    out = np.full((n, s_pad), UNKNOWN, dtype=alignment.dtype)
    out[:, :s] = alignment
    return out


def _tile_one_hot(codes_pad: torch.Tensor, tiles: torch.Tensor,
                  tile: int) -> torch.Tensor:
    """``[K, N, 5T]`` float32 one-hot of each tile's ``[N, T]`` column slice
    (column ``5a + s`` is allele ``s`` at the tile's site ``a``; UNKNOWN is
    all-zero), a view of an ``[N, K, 5T]`` buffer."""
    n, k = codes_pad.shape[0], tiles.shape[0]
    lane = torch.arange(tile, device=codes_pad.device)
    cols = (tiles.to(torch.int64)[:, None] * tile + lane).reshape(-1)
    sl = codes_pad.index_select(1, cols)                   # [N, K * T]
    alleles = torch.arange(N_ALLELES, dtype=sl.dtype, device=sl.device)
    oh = (sl[:, :, None] == alleles).to(torch.float32)     # [N, K * T, 5]
    return oh.view(n, k, 5 * tile).transpose(0, 1)


def tile_stats_batch(codes_pad: torch.Tensor, weights: torch.Tensor,
                     tile_i: torch.Tensor, tile_j: torch.Tensor,
                     emit: torch.Tensor, *, tile: int, n_sites: int,
                     ) -> PairStats:
    """LD statistics for a batch of site-pair tiles (``ld_tiled.py:38-73``).

    ``codes_pad`` is ``[N, S_pad]`` int8 (site-padded with UNKNOWN,
    :func:`pad_alignment`), ``weights`` ``[N]`` float32, ``tile_i`` /
    ``tile_j`` ``[K]`` tile coordinates (``tile_i <= tile_j``) and ``emit``
    ``[K]`` (0 or False for padding tiles, whose pairs are dropped).
    Returns :class:`PairStats` of ``[K, T, T]`` tensors on the codes'
    device, ``keep`` already holding ``(gi < gj) & (gj < n_sites) & emit``.

    ``Ju`` and ``Jw`` are ``[K, 5T, 5T]`` products of the one-hot operands
    over N, the weighted one with each row scaled by its weight (exact:
    the one-hot cells are 0 or 1), both in true float32
    (:func:`~weightedld_tpu_torch.core.paircore.f32_products`); the GEMM's
    summation order is the library's, not XLA's.  Each is ``[K, T, 5, T,
    5]`` in memory, read by the finalize as a ``[K, T, T, 5, 5]`` view."""
    k = tile_i.shape[0]
    oh_a = _tile_one_hot(codes_pad, tile_i, tile)
    oh_b = _tile_one_hot(codes_pad, tile_j, tile)
    with f32_products():
        ju = torch.bmm(oh_a.transpose(1, 2), oh_b)
        oh_a *= weights.to(torch.float32)[:, None]
        jw = torch.bmm(oh_a.transpose(1, 2), oh_b)
    del oh_a, oh_b
    tables = [x.view(k, tile, N_ALLELES, tile, N_ALLELES).permute(0, 1, 3, 2, 4)
              for x in (jw, ju)]
    st = finalize_pair_tile(*tables)
    del tables, jw, ju
    lane = torch.arange(tile, device=codes_pad.device)
    gi = tile_i.to(torch.int64)[:, None] * tile + lane         # [K, T]
    gj = tile_j.to(torch.int64)[:, None] * tile + lane
    valid = ((gi[:, :, None] < gj[:, None, :]) & (gj < n_sites)[:, None, :]
             & (emit != 0)[:, None, None])
    return PairStats(st.d, st.d_prime, st.r2, st.keep & valid)


def threshold_mask(stats: PairStats, r2_threshold: float) -> torch.Tensor:
    """``[K, T, T]`` bool of the surviving pairs: ``keep & (r2 >
    threshold)``, strict ``>`` (``lib.rs:661``); pass ``-inf`` to keep
    every kept pair (kept pairs have non-NaN r2)."""
    return stats.keep & (stats.r2 > r2_threshold)


def _quanta(x: torch.Tensor, scale: int) -> torch.Tensor:
    """float64 ``round_half_even(x * scale)``, -0.0 and NaN kept."""
    return torch.round(x.to(torch.float64) * scale)


def round_fixed_exact(x: torch.Tensor, scale: int) -> torch.Tensor:
    """int32 ``round_half_even(x * scale)`` of the REAL product, for
    float32 ``x`` and ``scale = 10^d``, d <= 4 (JAX ``ld_tiled.py:82-135``).

    The float64 product of a float32 and ``10^d`` is exact (24 + 14
    mantissa bits < 53) and ``torch.round`` rounds half to even, so this is
    CPython's ``round(float(x), d)`` scaled by ``10^d``, the integer the
    JAX Dekker two-product computes in float32 on a TPU.  No fused
    multiply-add can enter: the product is one rounding-free multiply."""
    return _quanta(x, scale).to(torch.int32)


def round_decimals(x: torch.Tensor, scale: int | None) -> torch.Tensor:
    """float32 ``x`` rounded to ``log10(scale)`` decimals as CPython's
    ``round(float(x), d)`` rounds them, as float32: the quantum of
    :func:`round_fixed_exact` over ``scale`` in float64 (one correctly
    rounded division), ``-0.0`` where ``x`` is negative and rounds to zero,
    as Python prints it (JAX ``_quantize`` and ``_records_from_wire3``,
    ``driver.py:1117-1173``).  ``scale=None`` returns ``x``."""
    if scale is None:
        return x
    return (_quanta(x, scale) / scale).to(torch.float32)


def compact_tile_stats(stats: PairStats, tile_i: torch.Tensor,
                       tile_j: torch.Tensor, mask: torch.Tensor, *,
                       tile: int, scale: int | None = None,
                       ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """The exact path: ``(count, sites [count, 2] int64, values [count, 3]
    float32)`` of the pairs of ``mask`` (:func:`threshold_mask`), global
    site indices ``(i, j)`` and ``(D, D', r2)``, D and r2 rounded by
    :func:`round_decimals` at ``scale``, on the stats' device.  Waits for
    the device (``torch.nonzero`` reads the count)."""
    kt, i_loc, j_loc = torch.nonzero(mask, as_tuple=True)
    gi = tile_i.to(torch.int64)[kt] * tile + i_loc
    gj = tile_j.to(torch.int64)[kt] * tile + j_loc
    sites = torch.stack([gi, gj], dim=1)
    d, r2 = round_decimals(torch.stack([stats.d[kt, i_loc, j_loc],
                                        stats.r2[kt, i_loc, j_loc]]), scale)
    values = torch.stack([d, stats.d_prime[kt, i_loc, j_loc], r2], dim=1)
    return int(sites.shape[0]), sites, values


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def compact_fixed(stats: PairStats, tile_i: torch.Tensor,
                  tile_j: torch.Tensor, mask: torch.Tensor, *, tile: int,
                  capacity: int, scale: int | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The speculative path: ``(count, block)`` on the stats' device with
    no host read.  ``count`` is the int64 survivor count (it may exceed
    ``capacity``; the caller then takes the exact path); ``block`` is
    ``[capacity, 5]`` int32, the first ``min(count, capacity)`` survivors
    in (tile, row, col) order and zeros past them: the global sites ``(i,
    j)`` and the float32 bits of ``(D, D', r2)``, D and r2 rounded by
    :func:`round_decimals` at ``scale``."""
    t = tile
    flags = mask.reshape(-1)
    if flags.numel() % 8:
        flags = torch.cat([flags, flags.new_zeros(-flags.numel() % 8)])
    per = flags.view(torch.int64) % 255                # survivors per word
    cum = torch.cumsum(per, 0)                         # inclusive
    count = cum[-1]
    slot = torch.arange(capacity, device=cum.device)
    word = torch.searchsorted(cum, slot, right=True).clamp_(max=len(cum) - 1)
    rank = slot - (cum[word] - per[word])              # rank in its word
    # The (rank + 1)-th flag of the word is at the count of its positions
    # whose inclusive prefix is <= rank.
    pos = torch.cumsum(flags.view(-1, 8)[word], 1)
    src = (word * 8 + (pos <= rank[:, None]).sum(1)).clamp_(
        max=mask.numel() - 1)                          # dead slots in range
    live = (slot < count)[:, None]
    kt, within = src // (t * t), src % (t * t)
    i_loc, j_loc = within // t, within % t
    take = lambda x: x.reshape(-1)[src]
    gi = tile_i.to(torch.int64)[kt] * t + i_loc
    gj = tile_j.to(torch.int64)[kt] * t + j_loc
    d, r2 = round_decimals(torch.stack([take(stats.d), take(stats.r2)]),
                           scale)
    block = torch.stack([gi.to(torch.int32), gj.to(torch.int32), _bits(d),
                         _bits(take(stats.d_prime)), _bits(r2)], dim=1)
    return count, torch.where(live, block, 0)


def decode_block(block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host rows of a ``[n, 5]`` int32 block of :func:`compact_fixed`:
    ``(sites [n, 2] int64, values [n, 3] float32)``."""
    return (block[:, :2].astype(np.int64),
            np.ascontiguousarray(block[:, 2:]).view(np.float32))
