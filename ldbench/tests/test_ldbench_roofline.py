"""The roofline's least work reads only the problem's shapes: the same
count for every weight mode, tile and entry point at fixed shapes, and
never above ``chip_smoke.py``'s least-work count for unit weights, which
counts whole tiles and the padded sequences."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from ldbench.harness.spec import load_module
from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

roofline = load_module(Path(__file__).resolve().parents[1] / "metrics"
                       / "roofline.py")

N, S = 40, 700


def _codes(general: bool) -> np.ndarray:
    rng = np.random.default_rng(3)
    if not general:
        return (rng.random((N, S)) < 0.3).astype(np.int8)
    codes = rng.integers(0, 5, size=(N, S)).astype(np.int8)
    codes[rng.integers(0, N, 30), rng.integers(0, S, 30)] = 5
    return codes


def _work(codes, **cfg) -> dict:
    sess = LdSession(codes, None, np.arange(S), DriverConfig(**cfg),
                     device="cpu")
    planes = int(np.unique(codes[codes < 5]).size)
    return sess, roofline.session_work(sess, planes)


VARIANTS = [dict(weight_quant=q, tile=t, preplaned=p)
            for q in ("none", "lo_int8", "split_bf16", "int8")
            for t in (32, 64) for p in ("on", "off")]


@pytest.mark.parametrize("general", (False, True))
def test_count_is_the_same_for_every_mode_tile_and_entry(general):
    codes = _codes(general)
    extra = {"kernel": "general"} if general else {}
    works = [_work(codes, **v, **extra)[1] for v in VARIANTS]
    kind = "general" if general else "majmin"
    assert all(w == works[0] for w in works)
    assert set(works[0]) == {kind}
    assert works[0][kind]["n_pairs"] == S * (S - 1) // 2
    ops = [roofline.least_work(kind, **w[kind]) for w in works]
    assert len(set(ops)) == 1


@pytest.mark.parametrize("general", (False, True))
@pytest.mark.parametrize("tile", (32, 64))
def test_count_is_at_most_the_unit_weight_count_of_chip_smoke(general, tile):
    """``chip_smoke.py:872-886`` (factorized: 4 cells x pairs x n_pad MACs,
    one pass for unit weights) and ``:962-973`` (general: (2P + 4) x pairs x
    n_pad MACs), with pairs = tile pairs x T^2 and n_pad the padded
    sequences; restated here, since nothing of the benchmark imports that
    script."""
    codes = _codes(general)
    extra = {"kernel": "general"} if general else {}
    sess, work = _work(codes, tile=tile, **extra)
    kind = "general" if general else "majmin"
    w = work[kind]
    n_pad = -(-N // sess.cfg.seq_chunk) * sess.cfg.seq_chunk
    pairs = sess.plan.n_tiles * tile * tile
    cells = 2 * w["planes"] + 4 if general else 4
    smoke_ops = 2 * pairs * n_pad * cells
    ops, _bytes = roofline.least_work(kind, **w)
    assert ops <= smoke_ops


def test_hybrid_split_counts_each_pair_once():
    """An input whose UNKNOWN cells sit in a few sites: the factorized and
    general classes of the hybrid plan hold every pair, once."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, size=(N, S)).astype(np.int8)
    codes[:2, 650:660] = 5
    sess, work = _work(codes, tile=64)
    assert sum(w["n_pairs"] for w in work.values()) == S * (S - 1) // 2


def test_least_seconds_names_its_bound():
    t, bound = roofline.least_seconds("majmin", 5008, 49152 * 49151 // 2,
                                      49152)
    assert bound == "operations"
    assert t == pytest.approx(8 * 5008 * (49152 * 49151 // 2) / 1979e12)
