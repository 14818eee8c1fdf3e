"""Where the port's dense engine meets the JAX one, and where it cannot.

The dense engine (``core/ld_dense.py``, ``core/paircore.py``) contracts
one-hot ``[N, 5S]`` operands into the joint tables ``Jw`` (weighted) and
``Ju`` (counts) of every site pair, then finalizes D, D' and r2 from them.
The JAX ``pair_tables`` runs that contraction as an XLA:CPU f32 GEMM
(``weightedld_tpu/core/paircore.py:101-108``), whose accumulation order is
Eigen's blocking, not the program's; torch's GEMM sums in another order,
and no order a program can write reproduces Eigen's (a sequential f32 sum
over N, and the f64 sum rounded to f32, each miss hundreds of cells).  On
the card the order is cuBLAS's, on a TPU the MXU's.  So the boundary is
stated exactly, on random inputs with and without missing cells and on the
ambiguous FASTA of tests/test_torch_ambiguous.py (40 x 120, the known
case), with the JAX side run without FMA (``--xla_cpu_max_isa=AVX``):

* the algebra: the port's ``finalize_pair_tile`` fed the JAX tables gives
  the JAX ``finalize_pair_tile``'s D, D', r2 and keep bit for bit;
* the tables: ``Ju`` (integer counts) is equal, and ``Jw`` agrees within
  ``2e-7`` of each pair's table sum, inside the f32 summation bound over N
  (measured: at most 9.2e-8; 4-6 % of the cells differ);
* the TSVs: the dense TSVs of both packages agree row for row, a value may
  differ only where the two raw values straddle a 4-dp rounding tie and
  lie within 1e-6 of each other; such rows are counted, and on the
  ambiguous FASTA there are a few (the deviation this test documents).
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from weightedld_tpu_torch.core.paircore import finalize_pair_tile, pair_tables
from weightedld_tpu_torch.io.writer import write_pairs
from weightedld_tpu_torch.pipeline import run

from .test_torch_ambiguous import write_ambiguous_fasta

REPO = Path(__file__).resolve().parent.parent
TABLE_RTOL = 2e-7
TIE_GAP = 1e-6


def random_case(name: str):
    """``(alignment, weights)``: 40 x 120 over A/C/G/T codes, seed 1, with
    no missing cell (``clean``) or 10 % UNKNOWN cells (``missing``)."""
    rng = np.random.default_rng(1)
    aln = rng.integers(0, 4, size=(40, 120)).astype(np.int8)
    if name == "missing":
        aln[rng.random(aln.shape) < 0.1] = 5
    return aln, (rng.random(40) + 0.05).astype(np.float32)


CASES = ("clean", "missing", "fasta")


def _inputs(name: str, d: Path):
    if name == "fasta":
        res = run(d / "amb.fasta", device="cpu")
        return np.asarray(res.alignment), np.asarray(res.weights, np.float32)
    return random_case(name)


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX tables, finalize and dense TSV."""
    import jax.numpy as jnp

    from weightedld_tpu.core.paircore import finalize_pair_tile as jfin
    from weightedld_tpu.core.paircore import pair_tables as jtables
    from weightedld_tpu.io.writer import write_pairs as jwrite
    from weightedld_tpu.pipeline import run as jrun

    d = Path(out_dir)
    res = jrun(d / "amb.fasta")
    np.savez(d / "jax_fasta_input.npz", alignment=res.alignment,
             weights=res.weights)
    for name in CASES:
        if name == "fasta":
            aln, w = res.alignment, np.asarray(res.weights, np.float32)
        else:
            aln, w = random_case(name)
        a = jnp.asarray(aln)
        jw, ju = jtables(a, a, jnp.asarray(w))
        st = jfin(jw, ju)
        np.savez(d / f"jax_{name}.npz", jw=np.asarray(jw), ju=np.asarray(ju),
                 **{f: np.asarray(getattr(st, f)) for f in st._fields})
    buf = io.StringIO()
    jwrite(res.records, buf)
    (d / "jax_dense.tsv").write_text(buf.getvalue())
    rec = res.records
    np.savez(d / "jax_records.npz", d=np.asarray(rec.d),
             d_prime=np.asarray(rec.d_prime), r2=np.asarray(rec.r2))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    write_ambiguous_fasta(d / "amb.fasta")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_dense import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=600, cwd=REPO)
    return d


@pytest.mark.parametrize("name", CASES)
def test_finalize_on_jax_tables_is_bit_equal(jax_ref, name):
    want = np.load(jax_ref / f"jax_{name}.npz")
    st = finalize_pair_tile(torch.from_numpy(want["jw"]),
                            torch.from_numpy(want["ju"]))
    for f in ("d", "d_prime", "r2", "keep"):
        got = getattr(st, f).numpy()
        assert got.dtype == want[f].dtype, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    if name != "clean":
        assert (want["ju"].sum(axis=(2, 3)) < 40).any()   # cells missing


@pytest.mark.parametrize("name", CASES)
def test_tables_within_the_f32_summation_bound(jax_ref, name):
    want = np.load(jax_ref / f"jax_{name}.npz")
    if name == "fasta":
        inp = np.load(jax_ref / "jax_fasta_input.npz")
        aln, w = inp["alignment"], inp["weights"].astype(np.float32)
        got_aln, got_w = _inputs(name, jax_ref)
        np.testing.assert_array_equal(got_aln, aln)
        np.testing.assert_array_equal(got_w, w)
    else:
        aln, w = random_case(name)
    a = torch.from_numpy(aln)
    jw, ju = pair_tables(a, a, torch.from_numpy(w))
    np.testing.assert_array_equal(ju.numpy(), want["ju"])
    total = want["jw"].sum(axis=(2, 3), keepdims=True)
    err = np.abs(jw.numpy() - want["jw"])
    assert (err <= TABLE_RTOL * total).all(), float((err / total).max())


def _straddles_tie(x: float, y: float, ndigits: int = 4) -> bool:
    """Whether a ``ndigits`` rounding boundary (k + 1/2) 10^-ndigits lies
    between ``x`` and ``y``."""
    lo, hi = sorted((float(x), float(y)))
    q = 10.0 ** ndigits
    k = np.floor(lo * q - 0.5)
    return any(lo <= (kk + 0.5) / q <= hi for kk in (k, k + 1))


def test_dense_tsv_rows_differ_only_at_counted_ties(jax_ref):
    res = run(jax_ref / "amb.fasta", device="cpu")
    buf = io.StringIO()
    write_pairs(res.records, buf)
    got = buf.getvalue().splitlines()
    want = (jax_ref / "jax_dense.tsv").read_text().splitlines()
    raw = np.load(jax_ref / "jax_records.npz")
    assert len(got) == len(want) > 1000 and got[0] == want[0]
    cols = ("d", "d_prime", "r2")
    tie_rows = 0
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        if g == w:
            continue
        gf, wf = g.split("\t"), w.split("\t")
        assert gf[:2] == wf[:2], (g, w)
        for c, col in enumerate(cols, start=2):
            if gf[c] != wf[c]:
                x = getattr(res.records, col)[i]
                y = raw[col][i]
                assert abs(float(x) - float(y)) < TIE_GAP, (g, w)
                assert _straddles_tie(x, y), (g, w, float(x), float(y))
        tie_rows += 1
    # The known case has a few such rows; any more would be a fault.
    assert 0 < tie_rows <= 5, tie_rows
