"""The general kernel's live work items, counted on the host.

``csrc/ld_general.cu`` runs only the work items (``kSA x kSB`` site
blocks of a tile pair) that hold a pair it can keep, ``gi < gj <
n_sites`` in an emitting tile pair.  ``cuda_general.live_spans`` is the
host's copy of that test in closed form, and ``work_items`` counts what a
launch runs (the ``items`` and ``live_items`` of a general
``batch.kernel`` span).  Both are held here against a brute-force search
over every pair of every item, for the blocks of P = 1, 3 and 5 in int8x3
and under unit weights (the table at the top of the kernel's source)."""

from __future__ import annotations

import numpy as np
import pytest

from weightedld_tpu_torch.ops.cuda_general import live_spans, work_items
from weightedld_tpu_torch.parallel.triangle import plan_tiles

# (kSA, kSB) of the bodies: int8x3 and unit weights, P = 1, 3, 5.
BLOCKS = {"int8x3-p1": (128, 40), "int8x3-p3": (40, 8),
          "int8x3-p5": (24, 8), "unit-p1": (128, 96), "unit-p3": (40, 32),
          "unit-p5": (24, 16)}


def live_blocks(tile_i, tile_j, emit, *, tile, n_sites, block):
    """``[K, ceil(T / kSA), ceil(T / kSB)]`` bool: whether each work item
    holds some pair ``gi < gj < n_sites`` of an emitting tile pair, by
    testing every pair."""
    sa, sb = block
    na, nb = -(-tile // sa), -(-tile // sb)
    loc = np.arange(tile)
    gi = np.asarray(tile_i, np.int64)[:, None, None] * tile + loc[:, None]
    gj = np.asarray(tile_j, np.int64)[:, None, None] * tile + loc
    keep = (gi < gj) & (gj < n_sites) & (np.asarray(emit) != 0)[:, None,
                                                                 None]
    pad = np.zeros((len(keep), na * sa, nb * sb), bool)
    pad[:, :tile, :tile] = keep
    return pad.reshape(len(keep), na, sa, nb, sb).any(axis=(2, 4))


def _plan(tile, n_sites, emit_kind):
    plan = plan_tiles(n_sites, tile)
    ti, tj = np.asarray(plan.tile_i), np.asarray(plan.tile_j)
    emit = np.ones(len(ti), np.int32)
    if emit_kind == "off_diagonal":
        keep = ti != tj
        ti, tj, emit = ti[keep], tj[keep], emit[keep]
    elif emit_kind == "padding":
        emit[1::3] = 0
        # Padding rows as a sharded batch pads: repeats of tile pair 0.
        ti = np.concatenate([ti, np.zeros(3, ti.dtype)])
        tj = np.concatenate([tj, np.zeros(3, tj.dtype)])
        emit = np.concatenate([emit, np.zeros(3, np.int32)])
    return ti, tj, emit


# id -> (tile, n_sites, which tile pairs emit).
PLANS = {
    "multiple": (256, 768, "all"),
    "one-past": (256, 769, "all"),        # the last tile holds one site
    "one-short": (256, 767, "all"),
    "ragged-600": (256, 600, "all"),      # the last tile holds 88
    "off-diagonal": (256, 768, "off_diagonal"),
    "padding": (96, 300, "padding"),      # emit == 0 rows
    "small-tile": (48, 130, "all"),       # a block wider than the tile
}


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("plan", list(PLANS))
def test_live_items_are_those_that_hold_a_pair(plan, block):
    tile, n_sites, emit_kind = PLANS[plan]
    ti, tj, emit = _plan(tile, n_sites, emit_kind)
    kw = dict(tile=tile, n_sites=n_sites, block=BLOCKS[block])
    want = live_blocks(ti, tj, emit, **kw)
    lo, hi = live_spans(ti, tj, emit, **kw)
    bj = np.arange(want.shape[2])
    got = (lo[:, :, None] <= bj) & (bj <= hi[:, :, None])
    # No dead item holds a pair to keep, and every live item holds one.
    np.testing.assert_array_equal(got, want)
    assert work_items(ti, tj, emit, **kw) == (want.size, int(want.sum()))
    if plan == "off-diagonal":
        assert want.all()                 # full off-diagonal tiles: all live
    if plan == "one-past":
        # The last tile's diagonal pair holds one site: no pair at all.
        last = (ti == tj) & (ti == ti.max())
        assert not want[last].any()


def test_cell_plan_is_half_live():
    """The general batch of ``hiv_pol_iupac.session`` (the margin split's
    7 tile pairs of 256 after the stable tile, PR 23) at 862, 880 and 902
    kept sites, P = 5 in int8x3: 2,464 items, of which 53-61 % are live."""
    ti = np.array([0, 0, 1, 1, 2, 2, 3])
    tj = np.array([2, 3, 2, 3, 2, 3, 3])
    emit = np.ones(7, np.int32)
    for n_sites, live in ((862, 1317), (880, 1393), (902, 1509)):
        assert work_items(ti, tj, emit, tile=256, n_sites=n_sites,
                          block=BLOCKS["int8x3-p5"]) == (2464, live)
