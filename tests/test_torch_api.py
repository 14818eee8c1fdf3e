"""The port's top level (``import weightedld_tpu_torch as wld``) and the
functions it adds against the JAX package's, on the CPU.

* ``__all__`` is the JAX package's 24 names plus ``resolve_device`` and
  ``__version__``, each bound to a port object.
* ``site_histogram``, ``compute_variable_sites`` (``max_minor`` 1.0 and
  0.5) and ``compute_variable_sites_rust``: equal to the JAX device
  functions, on random columns and on hand-built columns whose fractions
  sit exactly on ``min_acgt`` or ``min_variability`` (N = 5, 10, 49, 50),
  where the float32 verdicts of both can differ from the float64 host
  masks.
* ``henikoff_weights``: within rtol 1e-5 of the JAX function (measured
  max 3.0e-7) and rtol 1e-6 of the float64 host twin (measured max
  3.7e-8), with an all-UNKNOWN row, an all-gap site and N = 1; NaN where
  no cell is concrete, as in JAX.
* ``fasta_names``: equal on plain and gzip inputs.
* ``LdSession.run_batch(b)``: the JAX session's ``run_batch(b)`` at G = 1
  (interpret-mode Pallas, one CPU device; same pairs in the same order,
  values within rtol 1e-5 / atol 1e-6, in process, where XLA's CPU
  backend fuses multiply-adds), and the port's own ``stream`` batch ``b``
  exactly at G = 1, 2 and 3.
"""

from __future__ import annotations

import gzip
import importlib
import inspect
import itertools
import pkgutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import weightedld_tpu
import weightedld_tpu_torch as wld
from weightedld_tpu.core import henikoff as jhk
from weightedld_tpu.core import sites as jsites
from weightedld_tpu.io.fasta import fasta_names as jfasta_names
from weightedld_tpu_torch.core import sites as tsites
from weightedld_tpu_torch.core.henikoff import henikoff_weights_host
from weightedld_tpu_torch.io.fasta import fasta_names
from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

REPO = Path(__file__).resolve().parents[1]
RTOL_JAX, RTOL_F64 = 1e-5, 1e-6
THRESHOLDS = list(itertools.product(
    (0.1, 0.3, 0.5, 0.6, 0.7, 0.8, 0.9, 0.98),       # min_acgt
    (0.02, 0.1, 0.2, 0.25, 1 / 3, 0.5)))             # min_variability


def test_top_level_names_are_the_jax_names():
    assert wld.__all__ == [*weightedld_tpu.__all__, "resolve_device",
                           "__version__"]
    assert wld.__version__ == weightedld_tpu.__version__
    for name in weightedld_tpu.__all__:
        obj = getattr(wld, name)
        assert obj is not getattr(weightedld_tpu, name), name
        assert obj.__module__.startswith("weightedld_tpu_torch."), name


def edge_alignment(n: int, seed: int = 0) -> np.ndarray:
    """``[n, S]`` int8: random columns over codes 0..5, then for every
    ``k`` in 0..n a column with ``k`` concrete cells (the rest gaps or
    UNKNOWN) and columns whose minor count is ``k`` (all-minor and
    dominant-minor edges), so every coverage and variability fraction
    k / n occurs."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 6, size=(n, 60)).astype(np.int8)]
    for k in range(n + 1):
        gap = np.full(n, 4, np.int8)
        gap[:k] = 0
        gap[:min(k, 1)] = 1
        unk = np.full(n, 5, np.int8)
        unk[:k] = rng.integers(0, 4, size=k)
        minor = np.zeros(n, np.int8)
        minor[:k] = 1
        two = np.zeros(n, np.int8)
        two[:k] = 2
        two[:k // 2] = 3
        cols.append(np.stack([gap, unk, minor, two], axis=1))
    return np.concatenate(cols, axis=1)


@pytest.mark.parametrize("n", (5, 10, 49, 50))
def test_site_masks_equal_jax_at_the_edges(n):
    aln = edge_alignment(n)
    np.testing.assert_array_equal(
        tsites.site_histogram(aln, device="cpu").numpy(),
        np.asarray(jsites.site_histogram(aln)))
    assert tsites.site_histogram(aln, device="cpu").dtype == torch.int32
    for (min_acgt, min_var), max_minor in itertools.product(
            THRESHOLDS, (1.0, 0.5)):
        hk, ld = tsites.compute_variable_sites(aln, min_acgt, min_var,
                                               max_minor, device="cpu")
        jhk_mask, jld_mask = jsites.compute_variable_sites(
            aln, min_acgt, min_var, max_minor)
        np.testing.assert_array_equal(hk.numpy(), np.asarray(jhk_mask))
        np.testing.assert_array_equal(ld.numpy(), np.asarray(jld_mask))
        rust = tsites.compute_variable_sites_rust(aln, min_acgt, min_var,
                                                  max_minor=max_minor / 2 +
                                                  0.25, device="cpu")
        np.testing.assert_array_equal(
            rust.numpy(), np.asarray(jsites.compute_variable_sites_rust(
                aln, min_acgt, min_var, max_minor / 2 + 0.25)))


def test_site_masks_take_the_float32_verdicts():
    """36 of 40 concrete cells at ``min_acgt`` 0.9: the JAX device
    function and the port's keep the site (float32: 36 * f32(1/40) >
    f32(0.9)), the float64 host masks drop it (0.9 > 0.9 is False)."""
    aln = np.zeros((40, 2), np.int8)
    aln[:20, :] = 1
    aln[36:, 0] = 4
    hk, _ld = tsites.compute_variable_sites(aln, 0.9, 0.02, device="cpu")
    jhk_mask, _jld = jsites.compute_variable_sites(aln, 0.9, 0.02)
    host, _h = tsites.compute_variable_sites_host(aln, 0.9, 0.02)
    assert hk.tolist() == np.asarray(jhk_mask).tolist() == [True, True]
    assert host.tolist() == [False, True]


def test_site_functions_keep_a_tensor_on_its_device():
    aln = torch.from_numpy(edge_alignment(5))
    assert tsites.site_histogram(aln).device == aln.device
    assert wld.compute_variable_sites(aln, 0.8, 0.02)[0].device == aln.device
    assert wld.henikoff_weights(aln).device == aln.device


@pytest.mark.parametrize("shape", ((40, 300), (200, 1000), (1, 50), (7, 3)))
def test_henikoff_weights_match_jax_and_host(shape):
    n, s = shape
    rng = np.random.default_rng(n * s)
    aln = rng.integers(0, 5, size=(n, s)).astype(np.int8)
    aln[rng.random((n, s)) < 0.05] = 5
    if n > 2:
        aln[2] = 5                        # an all-UNKNOWN row
    aln[:, 1] = 4                         # an all-gap site
    got = wld.henikoff_weights(aln, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jhk.henikoff_weights(
        aln)), rtol=RTOL_JAX, atol=0)
    np.testing.assert_allclose(got.numpy(), henikoff_weights_host(aln),
                               rtol=RTOL_F64, atol=0)
    assert float(got.max()) == 1.0


def test_henikoff_weights_nan_without_a_concrete_cell():
    aln = np.full((4, 10), 5, np.int8)
    assert np.isnan(wld.henikoff_weights(aln, device="cpu").numpy()).all()
    assert np.isnan(np.asarray(jhk.henikoff_weights(aln))).all()


@pytest.mark.parametrize("gz", (False, True))
def test_fasta_names_equal_jax(tmp_path, gz):
    text = ">s0 first\nACGT\nAC\n\n>s1\nTTTTTT\n>  spaced name \nA-GTNN\n"
    path = tmp_path / ("a.fasta.gz" if gz else "a.fasta")
    path.write_bytes(gzip.compress(text.encode()) if gz else text.encode())
    assert fasta_names(path) == jfasta_names(path) == [
        "s0 first", "s1", "spaced name"]


def session_input():
    """``(alignment, weights, site_map)``: codes 0 / 1 / 4 with LD between
    neighbours, 64 x 150 sites: 55 tile pairs at T = 16, in batches of 8
    tiles per shard."""
    rng = np.random.default_rng(23)
    n, s = 64, 150
    aln = rng.choice([0, 0, 0, 1, 1, 4], size=(n, s)).astype(np.int8)
    for c in range(1, s, 2):
        src = aln[:, c - 1].copy()
        flip = rng.random(n) < 0.1
        src[flip] = np.where(src[flip] == 0, 1, 0)
        aln[:, c] = src
    w = (rng.random(n) + 0.05).astype(np.float32)
    return aln, w, np.arange(10, 10 + 3 * s, 3, dtype=np.int64)


CFG = dict(tile=16, seq_chunk=64, tiles_per_shard_batch=8,
           r2_threshold=0.02)


def test_run_batch_equals_jax():
    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.runtime.driver import DriverConfig as JCfg
    from weightedld_tpu.runtime.driver import LdSession as JSession

    aln, w, sm = session_input()
    sess = LdSession(aln, w, sm, DriverConfig(**CFG), device="cpu")
    jsess = JSession(aln, w, sm, JCfg(engine="pallas", **CFG),
                     mesh=default_mesh(jax.devices()[:1]))
    assert sess.n_batches == jsess.n_batches > 1
    for b in range(sess.n_batches):
        got, want = sess.run_batch(b), jsess.run_batch(b)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.pos_a, np.asarray(want.pos_a))
        np.testing.assert_array_equal(got.pos_b, np.asarray(want.pos_b))
        for key in ("d", "d_prime", "r2"):
            np.testing.assert_allclose(getattr(got, key),
                                       np.asarray(getattr(want, key)),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("g", (1, 2, 3))
def test_run_batch_equals_the_stream_batch(g):
    aln, w, sm = session_input()
    sess = LdSession(aln, w, sm, DriverConfig(**CFG), devices=["cpu"] * g)
    streamed = dict(sess.stream())
    assert sorted(streamed) == list(range(sess.n_batches))
    for b in (sess.n_batches - 1, 0, 1):
        got = sess.run_batch(b)
        for key in ("pos_a", "pos_b", "d", "d_prime", "r2"):
            np.testing.assert_array_equal(getattr(got, key),
                                          getattr(streamed[b], key))
    with pytest.raises(IndexError):
        sess.run_batch(sess.n_batches)


@pytest.mark.parametrize("g", (1, 2))
def test_top_pairs_past_a_batch_keeps_only_kept_pairs(g):
    """k above a batch's kept pairs: the unkept slots each shard leaves on
    the device (``topk_batch``) are dropped on the host, so ``top_pairs``
    is every kept pair by r2, descending, and the histogram counts them
    all."""
    aln, w, sm = session_input()
    cfg = dict(CFG, r2_threshold=None, max_site_distance=20)
    sess = LdSession(aln, w, sm, DriverConfig(**cfg), devices=["cpu"] * g)
    rows = [(int(a), int(b), float(r)) for _b, rec in sess.stream()
            for a, b, r in zip(rec.pos_a, rec.pos_b, rec.r2)]
    # A batch offers each shard's top-k all 8 x 256 slots of its tiles,
    # and the window leaves many of them unkept.
    assert 0 < len(rows) < sess.plan.n_tiles * 256
    top = sess.top_pairs(10 * len(rows))
    assert len(top) == len(rows)
    assert np.all(np.diff(top.r2) <= 0)
    assert sorted(zip(top.pos_a.tolist(), top.pos_b.tolist(),
                      top.r2.tolist())) == sorted(rows)
    assert sum(sess.r2_histogram([0.0, 0.5, 1.01])["n_pairs"]) == len(rows)


# ---------------------------------------------------------------------------
# Signatures: every public function and method of both packages
# ---------------------------------------------------------------------------

# What a JAX-style call cannot pass to the port, by "module:qualified name"
# (``_gap``), and why:
# * the mesh arguments: ``mesh=`` gives way to ``device`` / ``devices``;
# * ``platform``: the port has one platform;
# * ``henikoff_weights(dtype=)``: float32 cells and float64 sums, always;
# * ``compact_tile_stats``: the threshold mask is its own step
#   (``threshold_mask``), and the block's size is learned per batch, so
#   the fourth argument is the mask and there is no ``capacity``; JAX's
#   12-byte wire (``wire_scale``) was measured on the card and not kept,
#   ``scale`` rounds to decimals instead;
# * ``round_fixed_exact``: no wire, so no sentinel for -0.0.
DELIBERATE_GAPS = {
    **{name: (("mesh",), ()) for name in (
        "runtime.driver:LdSession.__init__",
        "runtime.driver:collect_ld_records",
        "runtime.driver:run_to_tsv",
        "runtime.driver:stream_ld_records",
        "runtime.ingest:session_from_fasta",
        "runtime.ingest:session_from_vcf")},
    "parallel.sharded:replicate": (("mesh",), ("devices",)),
    **{name: (("platform",), ()) for name in (
        "runtime.driver:LdSession.required_padding",
        "runtime.ingest:prepare_fasta_streamed",
        "runtime.ingest:prepare_vcf_streamed")},
    **{f"core.henikoff:{name}": (("dtype",), ()) for name in (
        "henikoff_weights", "henikoff_weights_large",
        "henikoff_weights_paper", "henikoff_weights_site_major")},
    "core.ld_tiled:compact_tile_stats": (
        ("r2_threshold", "capacity", "wire_scale"), ("mask",)),
    "core.ld_tiled:round_fixed_exact": (("neg_zero_sentinel",), ()),
}
# Open (ROADMAP queue 3): the same parameters as JAX's, in another
# positional order, so a JAX call by position binds another parameter.
REORDERED = {
    "io.fasta:read_fasta_site_major",       # scan before s_pad, n_pad
    "io.vcf:read_vcf_site_major",           # chrom after scan
    "runtime.driver:DriverConfig.__init__",  # the fields' order
    "runtime.driver:LdSession.stream",      # r2_threshold, on_progress
    "runtime.ingest:prepare_vcf_streamed",  # cfg before chrom
    "runtime.ingest:session_from_vcf",      # chrom after weight_precision
}
# The JAX module whose host helpers a port module copies under the same
# names, where the module names differ.
COUNTERPART = {"ops.cuda_ld": "ops.pallas_ld",
               "ops.cuda_general": "ops.pallas_ld"}


def _modules(pkg) -> dict:
    """Every module of ``pkg`` but ``__main__``, by its name below the
    package (``""`` for the top level)."""
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if not info.name.endswith(".__main__"):
            out[info.name.split(".", 1)[1]] = importlib.import_module(
                info.name)
    return out


def _public(mod) -> dict:
    """The public functions ``mod`` defines (jitted ones through their
    wrapper) and the public methods and ``__init__`` of its public
    classes, by qualified name."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != mod.__name__:
            continue
        if inspect.isclass(obj):
            for meth, fn in vars(obj).items():
                fn = getattr(fn, "__func__", fn)
                if inspect.isfunction(fn) and (meth == "__init__"
                                               or not meth.startswith("_")):
                    out[f"{name}.{meth}"] = fn
        elif inspect.isfunction(obj) or hasattr(obj, "__wrapped__"):
            out[name] = obj
    return out


def _params(fn) -> dict:
    return dict(inspect.signature(fn).parameters)


def _gap(jax_fn, port_fn) -> tuple[tuple, tuple]:
    """``(JAX parameters the port does not take, port parameters a JAX
    call would not supply)``, by name: a JAX parameter is missing when the
    port has none of its name and kind (``*args`` and ``**kwargs`` match by
    kind), or takes it only by keyword where JAX takes it by position; a
    port parameter is unsupplied when JAX has none of its name and it has
    no default."""
    P = inspect.Parameter
    positional, var = ((P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD),
                       (P.VAR_POSITIONAL, P.VAR_KEYWORD))
    jp, tp = _params(jax_fn), _params(port_fn)
    missing = []
    for name, p in jp.items():
        if p.kind in var:
            ok = any(q.kind == p.kind for q in tp.values())
        else:
            q = tp.get(name)
            ok = q is not None and q.kind not in var and not (
                p.kind in positional and q.kind not in positional)
        if not ok:
            missing.append(name)
    extra = tuple(name for name, q in tp.items()
                  if name not in jp and q.kind not in var
                  and q.default is q.empty)
    return tuple(missing), extra


def _reordered(jax_fn, port_fn) -> bool:
    """Do the positional parameters both take stand in another order in the
    port (so a JAX call by position binds another parameter)?"""
    P = inspect.Parameter
    jp, tp = _params(jax_fn), _params(port_fn)

    def order(params, other):
        return [n for n, p in params.items() if n in other and p.kind in (
            P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)]

    return order(jp, tp) != [n for n in order(tp, jp) if n in order(jp, tp)]


def _compare_signatures() -> tuple[dict, set, int]:
    """``(gaps, reordered, functions compared)`` over every public function
    and method that both packages define in counterpart modules."""
    jax_mods = _modules(weightedld_tpu)
    gaps, reordered, compared = {}, set(), 0
    for key, mod in _modules(wld).items():
        jmod = jax_mods.get(COUNTERPART.get(key, key))
        if jmod is None:
            continue
        jfns, fns = _public(jmod), _public(mod)
        for name in sorted(set(jfns) & set(fns)):
            compared += 1
            gap = _gap(jfns[name], fns[name])
            if gap != ((), ()):
                gaps[f"{key}:{name}"] = gap
            if _reordered(jfns[name], fns[name]):
                reordered.add(f"{key}:{name}")
    return gaps, reordered, compared


def _doc_name(key: str) -> str:
    """How the documents name a function of the lists: its own name, or its
    class's for ``__init__``."""
    name = key.rsplit(":", 1)[1]
    return name.split(".")[0] if name.endswith(".__init__") \
        else name.rsplit(".", 1)[-1]


def test_signatures_differ_from_jax_only_in_the_deliberate_gaps():
    gaps, _reordered_names, compared = _compare_signatures()
    assert compared > 100, compared
    assert gaps == DELIBERATE_GAPS
    # Both documents name each function of the list.
    for doc in ("docs/API_TORCH.md", "ROADMAP.md"):
        text = (REPO / doc).read_text()
        for key in DELIBERATE_GAPS:
            assert _doc_name(key) in text, (doc, key)


def test_parameter_order_differs_only_where_listed():
    """The same parameters in another positional order: an open fault
    (ROADMAP queue 3), listed here until it is repaired, so that no new
    case goes unseen."""
    _gaps, reordered, _compared = _compare_signatures()
    assert reordered == REORDERED
    text = (REPO / "ROADMAP.md").read_text()
    for key in REORDERED:
        assert _doc_name(key) in text, key


def test_resolve_tile_takes_the_jax_arguments():
    from weightedld_tpu_torch.runtime import driver as drv

    aln = np.zeros((30, 500), np.int8)
    assert drv.resolve_tile(None, "auto", aln) == drv.DEFAULT_TILE
    assert drv.resolve_tile(None, "xla", aln, 512, None, "cpu", True,
                            30) == drv.XLA_TILE
    assert drv.resolve_tile(64, "auto", aln, majmin=True, n_seqs=1000) == 64
    assert (LdSession.required_padding(1000, 500, DriverConfig(), True)
            == LdSession.required_padding(1000, 500))
