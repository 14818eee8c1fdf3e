"""Device-side record compaction over a batch of tiles.

Counterpart of ``compact_tile_stats`` (``weightedld_tpu/core/ld_tiled.py:
138-310``) in its plain form: filter ``keep & (r2 > threshold)`` over the
flattened ``[K, T, T]`` batch and gather the survivors in (tile, row, col)
order — the order the JAX slot compaction also produces.  PyTorch has no
static-shape constraint, so there is no fixed capacity and no overflow
protocol, and records travel as global site indices plus float32 values
(the 12-byte fixed-point wire is not ported).
"""

from __future__ import annotations

import torch

from .paircore import PairStats


def compact_tile_stats(stats: PairStats, tile_i: torch.Tensor,
                       tile_j: torch.Tensor, r2_threshold: float, *,
                       tile: int) -> tuple[int, torch.Tensor, torch.Tensor]:
    """``(count, sites [count, 2] int64, values [count, 3] float32)`` of the
    surviving pairs: global site indices ``(i, j)`` and ``(D, D', r2)``,
    on the stats' device.  Strict ``>`` threshold (``lib.rs:661``); pass
    ``-inf`` to emit every kept pair (kept pairs have non-NaN r2)."""
    mask = stats.keep & (stats.r2 > r2_threshold)
    kt, i_loc, j_loc = torch.nonzero(mask, as_tuple=True)
    gi = tile_i.to(torch.int64)[kt] * tile + i_loc
    gj = tile_j.to(torch.int64)[kt] * tile + j_loc
    sites = torch.stack([gi, gj], dim=1)
    values = torch.stack([stats.d[kt, i_loc, j_loc],
                          stats.d_prime[kt, i_loc, j_loc],
                          stats.r2[kt, i_loc, j_loc]], dim=1)
    return int(sites.shape[0]), sites, values
