"""Site-pair upper-triangle tiling (numpy).

Copies of ``cdiv``, ``TilePlan``, ``plan_tiles`` (with the site-index and
bp window bands and the cross rectangle), ``_per_tile_minmax``,
``plan_tiles_permuted``, ``tile_pair_counts``, ``pairs_per_shard`` and
``stripe`` from ``weightedld_tpu/parallel/triangle.py:23-233``.  The S x S
site-pair triangle is cut into square tiles of side ``tile``, enumerated
row-major host-side (~S^2 / 2T^2 entries); windowed and cross plans drop
the tiles that cannot hold a pair of their set, and the engine masks the
in-tile remainder (``runtime/driver.py``).  ``stripe`` deals the plan's
tiles over G shards (shard d owns tiles d, d + G, d + 2G, ...); on one
shard it is the identity, and it fixes the order records are emitted in.
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


def tile_pair_counts(plan: TilePlan) -> np.ndarray:
    """True (in-triangle, padding-excluded) pair count of every tile:
    ``h * w`` off the diagonal, ``h (h - 1) / 2`` on it.  A windowed plan
    counts each tile's full in-triangle pairs (the in-tile window mask is
    not subtracted)."""
    t = plan.tile
    s = plan.n_sites
    i0 = plan.tile_i.astype(np.int64) * t
    j0 = plan.tile_j.astype(np.int64) * t
    h = np.clip(s - i0, 0, t)
    w = np.clip(s - j0, 0, t)
    return np.where(plan.tile_i == plan.tile_j, h * (h - 1) // 2, h * w)


def pairs_per_shard(plan: TilePlan, n_shards: int) -> np.ndarray:
    """True pair count each shard evaluates under :func:`stripe`; for an
    all-pairs plan the counts sum to ``plan.n_pairs``."""
    counts = tile_pair_counts(plan)
    n = plan.n_tiles
    per_shard = cdiv(n, n_shards)
    out = np.zeros(n_shards, dtype=np.int64)
    for d in range(n_shards):
        src = d + np.arange(per_shard) * n_shards
        out[d] = counts[src[src < n]].sum()
    return out


def stripe(plan: TilePlan,
           n_shards: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stripe tiles across shards: shard d owns tiles d, d + n, d + 2n, ...

    Returns ``(tile_i, tile_j, emit)`` of shape ``[n_shards * per_shard]``,
    shard-major (shard d's tiles are the block ``[d * per_shard, (d + 1) *
    per_shard)``), padded with non-emitting duplicates of the last tile so
    that every shard has equal work."""
    n = plan.n_tiles
    per_shard = cdiv(n, n_shards)
    idx = np.arange(per_shard * n_shards)
    src = idx // per_shard + (idx % per_shard) * n_shards
    emit = src < n
    src = np.minimum(src, n - 1)
    return (plan.tile_i[src].astype(np.int32),
            plan.tile_j[src].astype(np.int32), emit)
