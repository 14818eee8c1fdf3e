"""Site-pair upper-triangle tiling and striping (numpy).

Copies of ``cdiv``, ``TilePlan`` and ``plan_tiles`` (all-pairs branch only)
from ``weightedld_tpu/parallel/triangle.py:23-109``.  The S x S site-pair
triangle is cut into square tiles of side ``tile``, enumerated row-major
host-side (~S^2 / 2T^2 entries).  On one device the JAX ``stripe`` is the
identity on this order, which fixes the order records are emitted in; it
is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class TilePlan:
    """Static plan for one all-pairs run."""

    n_sites: int          # S: number of (kept) sites
    tile: int             # tile side T
    s_pad: int            # S padded to a multiple of T
    grid: int             # number of tile rows/cols = s_pad // T
    tile_i: np.ndarray    # [n_tiles] int32 tile-row indices (i <= j)
    tile_j: np.ndarray    # [n_tiles] int32 tile-col indices

    @property
    def n_tiles(self) -> int:
        return len(self.tile_i)

    @property
    def n_pairs(self) -> int:
        """True number of site pairs S(S-1)/2."""
        return self.n_sites * (self.n_sites - 1) // 2


def plan_tiles(n_sites: int, tile: int = 128) -> TilePlan:
    """Enumerate upper-triangle tiles (diagonal included) row-major."""
    if n_sites < 2:
        raise ValueError("need at least 2 sites")
    s_pad = cdiv(n_sites, tile) * tile
    grid = s_pad // tile
    ti, tj = np.triu_indices(grid)
    return TilePlan(n_sites=n_sites, tile=tile, s_pad=s_pad, grid=grid,
                    tile_i=ti.astype(np.int32), tile_j=tj.astype(np.int32))
