"""Site-pair upper-triangle tiling (numpy).

Copies of ``cdiv``, ``TilePlan``, ``plan_tiles`` (with the site-index and
bp window bands and the cross rectangle), ``_per_tile_minmax`` and
``plan_tiles_permuted`` from ``weightedld_tpu/parallel/triangle.py:23-178``.
The S x S site-pair triangle is cut into square tiles of side ``tile``,
enumerated row-major host-side (~S^2 / 2T^2 entries); windowed and cross
plans drop the tiles that cannot hold a pair of their set, and the engine
masks the in-tile remainder (``runtime/driver.py``).  On one device the
JAX ``stripe`` is the identity on this order, which fixes the order records
are emitted in; it is not ported, nor is ``pairs_per_shard``.
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


def plan_tiles(n_sites: int, tile: int = 128,
               max_site_distance: int | None = None,
               max_bp_distance: int | None = None,
               site_map=None,
               cross_split: int | None = None) -> TilePlan:
    """Enumerate upper-triangle tiles (diagonal included) row-major.

    ``max_site_distance``: drop tiles whose nearest pair is more than this
    many sites apart, an O(S*W) band.  ``max_bp_distance`` with a
    non-decreasing ``site_map``: the same band in site-map units (bp for a
    VCF); tile (i, j > i)'s nearest pair is (last site of row-tile i, first
    site of col-tile j).  The two compose (intersection).  ``cross_split``:
    keep only tiles that can hold a pair a < split <= b, the O(|A|*|B|)
    rectangle.  The engine masks the in-tile remainder."""
    if n_sites < 2:
        raise ValueError("need at least 2 sites")
    s_pad = cdiv(n_sites, tile) * tile
    grid = s_pad // tile
    ti, tj = np.triu_indices(grid)
    if max_site_distance is not None:
        # Closest pair of tile (i, j>i): site distance (j-i-1)*T + 1.
        near = (tj - ti - 1) * tile < max_site_distance
        ti, tj = ti[near], tj[near]
    if max_bp_distance is not None:
        sm = np.asarray(site_map)
        if sm.shape[0] != n_sites:
            raise ValueError("site_map length must equal n_sites")
        g = np.arange(grid)
        # Clamp to true sites: tiles fully in padding never contain kept
        # pairs, their positions only need to be finite.
        row_end = sm[np.minimum((g + 1) * tile, n_sites) - 1]
        col_start = sm[np.minimum(g * tile, n_sites - 1)]
        near = (ti == tj) | (col_start[tj] - row_end[ti] <= max_bp_distance)
        ti, tj = ti[near], tj[near]
    if cross_split is not None:
        if not 0 < cross_split < n_sites:
            raise ValueError(
                f"cross_split must be in 1..{n_sites - 1}, got {cross_split}")
        hit = (ti * tile < cross_split) & ((tj + 1) * tile > cross_split)
        ti, tj = ti[hit], tj[hit]
    return TilePlan(n_sites=n_sites, tile=tile, s_pad=s_pad, grid=grid,
                    tile_i=ti.astype(np.int32), tile_j=tj.astype(np.int32))


def _per_tile_minmax(vals: np.ndarray, n_sites: int, tile: int,
                     grid: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile (min, max) of a per-site value array under padding: pad
    sites get +inf/-inf sentinels so pad-only tiles match no interval."""
    v = np.asarray(vals, dtype=np.int64)
    lo = np.full(grid * tile, np.iinfo(np.int64).max // 2, dtype=np.int64)
    hi = np.full(grid * tile, np.iinfo(np.int64).min // 2, dtype=np.int64)
    lo[:n_sites] = v
    hi[:n_sites] = v
    return (lo.reshape(grid, tile).min(axis=1),
            hi.reshape(grid, tile).max(axis=1))


def plan_tiles_permuted(n_sites: int, tile: int,
                        max_site_distance: int | None = None,
                        max_bp_distance: int | None = None,
                        orig_idx=None, site_map=None) -> TilePlan:
    """Windowed tile plan for a PERMUTED site layout (the windowed
    unsafe-site packing).  A tile pair can hold an in-window pair only if
    the two tiles' original-position intervals come within the window:
    per-tile [min, max] of ``orig_idx`` (site-index windows) and/or
    ``site_map`` (bp windows) give a superset of the needed tile pairs,
    which the engine's per-pair lookup masks trim, and exactly the band
    plan when the permutation is the identity.  Under the class split
    (clean sites in input order, then dirty sites in input order) the
    clean block's intervals are contiguous and ascending, so its band is no
    wider than the unpermuted one."""
    if n_sites < 2:
        raise ValueError("need at least 2 sites")
    s_pad = cdiv(n_sites, tile) * tile
    grid = s_pad // tile
    ti, tj = np.triu_indices(grid)
    near = np.ones(len(ti), dtype=bool)
    if max_site_distance is not None:
        if orig_idx is None:
            raise ValueError("site-index window on a permuted layout "
                             "needs orig_idx")
        lo, hi = _per_tile_minmax(orig_idx, n_sites, tile, grid)
        near &= ((lo[tj] - hi[ti] <= max_site_distance)
                 & (lo[ti] - hi[tj] <= max_site_distance))
    if max_bp_distance is not None:
        sm = np.asarray(site_map)
        if sm.shape[0] != n_sites:
            raise ValueError("site_map length must equal n_sites")
        lo, hi = _per_tile_minmax(sm, n_sites, tile, grid)
        near &= ((lo[tj] - hi[ti] <= max_bp_distance)
                 & (lo[ti] - hi[tj] <= max_bp_distance))
    ti, tj = ti[near], tj[near]
    return TilePlan(n_sites=n_sites, tile=tile, s_pad=s_pad, grid=grid,
                    tile_i=ti.astype(np.int32), tile_j=tj.astype(np.int32))
