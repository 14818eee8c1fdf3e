"""The session of the benchmark's ``hiv_pol_iupac`` configuration at a
small size on the CPU: an HIV-1 *pol*-shaped IUPAC alignment from
``ldbench/generators/iupac_fasta.py``, masked and loaded as the benchmark
loads it (``ldbench/harness/loops.py:build_session``).  Every kept site
holds mixtures (UNKNOWN), so under ``kernel="general"`` every tile pair
runs the general kernel; the default session packs the margin-stable
sites first and runs their tile pair on the factorized kernel.  Under
both, the records match the plain float64 reference
(``ldbench/reference/ld_ref.py``) within the cell's limits."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ldbench.harness import check, loops, spec
from ldbench.reference import ld_ref

REPO = Path(__file__).resolve().parents[1]
LB = REPO / "ldbench"
CELL = "hiv_pol_iupac.session"


def _config(n_seqs: int, n_sites: int) -> dict:
    cfg = json.loads((LB / "configs" / "hiv_pol_iupac.json").read_text())
    return {**cfg, "n_seqs": n_seqs, "n_sites": n_sites}


@pytest.fixture(scope="module", params=("general", "auto"))
def pol(request):
    """Ten thousand sequences over 1,400 columns: some 430 kept sites, two
    tiles of 256, a mixture at every kept site; the session under
    ``kernel=`` the parameter."""
    cfg = _config(10_000, 1400)
    gen = spec.load_module(LB / "generators" / "iupac_fasta.py")
    data = gen.generate(cfg, 2**31 + 41, "cpu")
    mix = json.loads((LB / "traffic" / "session.json").read_text())
    mix = {**mix, "driver": {**mix.get("driver", {}),
                             "kernel": request.param}}
    sess, pos, codes = loops.build_session(cfg, data, mix, "cpu")
    return cfg, mix, data, sess, pos, codes


def test_every_tile_pair_is_general(pol):
    """Every tile holds mixtures: under ``kernel="general"`` every tile
    pair runs the general kernel; by default the margin-stable sites fill
    the first tile, whose diagonal tile pair runs factorized."""
    _cfg, mix, _data, sess, _pos, codes = pol
    assert 256 < sess.n_sites <= 512 and sess.cfg.tile == 256
    ti, tj = np.asarray(sess.plan.tile_i), np.asarray(sess.plan.tile_j)
    assert (ti != tj).any()                  # an off-diagonal tile pair
    # Every tile holds mixtures (UNKNOWN) and trimmed ends (the gap plane).
    for t in range(int(ti.max()) + 1):
        block = codes[:, t * 256:(t + 1) * 256]
        assert (block == 5).any() and (block == 4).any()
    assert (codes == 5).any(axis=0).all()    # every kept site is dirty
    assert sess.planes == (0, 1, 2, 3, 4)
    if mix["driver"]["kernel"] == "general":
        assert sess.site_perm is None and sess.hybrid_safe is None
        assert sess.phase_tiles == {"majmin": 0,
                                    "general": sess.plan.n_tiles}
        return
    assert sess.site_perm is not None
    assert sess.phase_tiles["majmin"] >= 1
    assert sess.phase_tiles["majmin"] + sess.phase_tiles["general"] \
        == sess.plan.n_tiles
    assert sess.hybrid_safe[(ti == 0) & (tj == 0)].all()


def test_stream_matches_the_reference_within_the_cell_limits(pol):
    cfg, mix, data, sess, pos, codes = pol
    ans = loops.ask(sess, {"kind": "stream"})
    thr = mix["session_threshold"]
    assert len(ans["r2"]) > 0
    ref_codes = torch.from_numpy(codes)
    acc = ld_ref.scan(ref_codes, ld_ref.henikoff(ref_codes), pos,
                      ld_ref.Spec(thresholds=(thr,)), "cpu", block=1024)
    judge = check.Judge(acc, pos, ld_ref.minor_fraction(ref_codes))
    judge.records(ans, thr)
    limits = json.loads((LB / "limits" / f"{CELL}.json").read_text())
    for name in ("missing", "extra"):
        assert judge.out[name] == 0, name
    for name in ("r2_gap", "d_gap", "dp_gap"):
        assert judge.out[name] <= limits[name], (name, judge.out[name])
    # The session holds the sites the reference's mask keeps.
    _hk, keep = ld_ref.site_masks(torch.from_numpy(data["codes"]),
                                  cfg["min_acgt"], cfg["min_variability"])
    assert np.array_equal(pos, data["positions"][keep.numpy()])
