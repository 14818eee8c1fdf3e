"""Parity of the port's checkpointed ``run_to_tsv``, progress reports,
``collect_ld_records``, prepared cache and ``device_trace`` with the JAX
package, on the CPU.

* ``run_to_tsv(checkpoint=True)`` interrupted after a few batches and run
  again equals an uninterrupted checkpointed run byte for byte, plain and
  ``.gz`` (one gzip member per batch), on a factorized and on a hybrid
  (factorized + general) plan, and equals the JAX ``run_to_tsv``'s bytes;
  the interruption is a test-only patch of ``LdSession.stream``.
* A resume under a changed plan or input, or in the other output format,
  is refused with the JAX package's message (the port's resolved plan in
  place of its engine name).
* ``LdSession.stream(on_progress=...)`` reports the JAX session's work
  counts, reaching the whole plan exactly once, on the last batch.
* A ``.npz`` cache written by either package loads in the other's CLI with
  the same TSV bytes; a ``--profile-dir`` run writes a trace and the bytes
  of the run without one.

The JAX side runs in a subprocess with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
and its sessions on the interpret-mode Pallas kernels, as in
tests/test_torch_ambiguous.py.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import weightedld_tpu_torch.runtime.driver as drv
from weightedld_tpu_torch import cli
from weightedld_tpu_torch.io.writer import PairAnnot
from weightedld_tpu_torch.pipeline import WldConfig, prepare
from weightedld_tpu_torch.runtime.cache import load_prepared, save_prepared
from weightedld_tpu_torch.runtime.driver import (
    DriverConfig,
    LdSession,
    collect_ld_records,
    run_to_tsv,
)
from weightedld_tpu_torch.runtime.profiling import device_trace

from .test_torch_ambiguous import write_ambiguous_fasta
from .test_torch_regions import run_cli, write_two_chrom_vcf

REPO = Path(__file__).resolve().parent.parent
# name -> (input, prepare kwargs, DriverConfig kwargs, batches before the
# interruption)
INPUTS = {
    "majmin": ("two.vcf", {"chrom": "1"},
               {"tile": 32, "seq_chunk": 64, "tiles_per_shard_batch": 2}, 3),
    "hybrid": ("amb.fasta", {},
               {"tile": 16, "seq_chunk": 64, "tiles_per_shard_batch": 3,
                "r2_threshold": 0.05}, 4),
}
# The tiled layout of the CLI runs (the JAX CLI's on the Pallas kernels).
LAY = ["--engine", "tiled", "--tile", "16", "--seq-chunk", "64"]
CASES = [(name, suffix) for name in INPUTS for suffix in (".tsv", ".tsv.gz")]
PREP = ("min_acgt", "min_variability", "unweighted", "max_minor",
        "weight_mask", "weighting", "chrom", "fasta_reader", "region",
        "keep_samples", "exclude_samples")


def write_inputs(d: Path) -> None:
    write_two_chrom_vcf(d / "two.vcf")
    write_ambiguous_fasta(d / "amb.fasta")
    cfg = WldConfig(min_acgt=0.7)
    save_prepared(d / "port.npz", prepare(d / "amb.fasta", cfg,
                                          device="cpu"),
                  {k: getattr(cfg, k) for k in PREP})


def _prepared(d: Path, name: str, pipeline):
    src, kw, _cfg, _k = INPUTS[name]
    return pipeline.prepare(d / src, pipeline.WldConfig(**kw))


class Stop(Exception):
    pass


def _interrupted(module, after: int, fn, *args, **kwargs):
    """Run ``fn`` with ``module.LdSession.stream`` stopping a first scan
    after ``after`` batches (a resumed scan runs to its end)."""
    orig = module.LdSession.stream

    def limited(*a, **kw):
        n = 0
        for item in orig(*a, **kw):
            yield item
            n += 1
            if n >= after and not kw.get("start_batch"):
                raise Stop

    module.LdSession.stream = limited
    try:
        fn(*args, **kwargs)
    except Stop:
        pass
    finally:
        module.LdSession.stream = orig


def _jax_reference(out_dir: str) -> None:
    """Subprocess body: the JAX ``run_to_tsv`` runs, progress reports,
    records, refusals and cache loads."""
    import contextlib
    import io

    import jax

    import weightedld_tpu.pipeline as jpipe
    import weightedld_tpu.runtime.driver as jd
    from weightedld_tpu import cli as jcli
    from weightedld_tpu.io.writer import PairAnnot as JAnnot
    from weightedld_tpu.parallel.sharded import default_mesh
    from weightedld_tpu.runtime.cache import save_prepared as jsave

    mesh = default_mesh(jax.devices()[:1])
    resolve = jd._resolve_engine
    jd._resolve_engine = lambda engine, platform=None: (
        "pallas" if engine == "auto" else resolve(engine, platform))
    d = Path(out_dir)
    meta = {}
    for name, (_src, _kw, ckw, after) in INPUTS.items():
        res = _prepared(d, name, jpipe)
        args = (res.alignment, res.weights, res.site_map)
        cfg = jd.DriverConfig(engine="pallas", **ckw)
        for suffix in (".tsv", ".tsv.gz"):
            jd.run_to_tsv(*args, d / f"jax_{name}_full{suffix}", cfg,
                          mesh=mesh, checkpoint=True)
            part = d / f"jax_{name}_part{suffix}"
            _interrupted(jd, after, jd.run_to_tsv, *args, part, cfg,
                         mesh=mesh, checkpoint=True)
            jd.run_to_tsv(*args, part, cfg, mesh=mesh, checkpoint=True)
        sess = jd.LdSession(*args, jd.DriverConfig(
            engine="pallas", progress_every_s=0.0, **ckw), mesh)
        reports = []
        for _b, _rec in sess.stream(on_progress=lambda p: reports.append(
                [p.pairs_done, p.pairs_total, p.records_emitted])):
            pass
        rec = jd.collect_ld_records(*args, cfg, mesh=mesh)
        np.savez(d / f"jax_{name}_records.npz", *rec)
        # Refusals: a changed tile, a changed input, the plink format.
        part = d / f"jax_{name}_refuse.tsv"
        _interrupted(jd, 1, jd.run_to_tsv, *args, part, cfg, mesh=mesh)
        errs = []
        changed = res.alignment.copy()
        changed[0, 0] = (changed[0, 0] + 1) % 4
        sm = [int(p) for p in res.site_map]
        annot = JAnnot({p: "0" for p in sm}, {p: f"site{p}" for p in sm})
        for a, c, kw in (
                (args, jd.DriverConfig(engine="pallas",
                                       **{**ckw, "tile": 64}), {}),
                ((changed,) + args[1:], cfg, {}),
                (args, cfg, {"annot": annot})):
            try:
                jd.run_to_tsv(*a, part, c, mesh=mesh, **kw)
                errs.append(None)
            except RuntimeError as e:
                errs.append(str(e))
        meta[name] = {"progress": reports, "refusals": errs}
    # The prepared cache, both ways.
    cfg = jpipe.WldConfig(min_acgt=0.7)
    jsave(d / "jax.npz", jpipe.prepare(d / "amb.fasta", cfg),
          {k: getattr(cfg, k) for k in PREP})
    for npz in ("jax", "port"):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = jcli.main(["--load-prepared", str(d / f"{npz}.npz")]
                           + LAY)
        meta[f"load-{npz}"] = {"rc": rc, "out": out.getvalue(),
                               "err": err.getvalue()}
    (d / "meta.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    write_inputs(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_checkpoint import _jax_reference; "
            "_jax_reference(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(REPO), str(d)],
                   env=env, check=True, timeout=900, cwd=REPO)
    return d, json.loads((d / "meta.json").read_text())


def _port_args(d: Path, name: str):
    import weightedld_tpu_torch.pipeline as ppipe

    src, kw, ckw, after = INPUTS[name]
    res = ppipe.prepare(d / src, ppipe.WldConfig(**kw), device="cpu")
    return (res.alignment, res.weights, res.site_map), DriverConfig(**ckw), \
        after


@pytest.mark.parametrize("name,suffix", CASES)
def test_resumed_run_equals_uninterrupted_and_jax(jax_ref, tmp_path, name,
                                                  suffix):
    d, _meta = jax_ref
    args, cfg, after = _port_args(d, name)
    full = tmp_path / f"full{suffix}"
    n_full = run_to_tsv(*args, full, cfg, device="cpu", checkpoint=True)
    part = tmp_path / f"part{suffix}"
    ckpt = part.with_suffix(part.suffix + ".ckpt.json")
    _interrupted(drv, after, run_to_tsv, *args, part, cfg, device="cpu",
                 checkpoint=True)
    state = json.loads(ckpt.read_text())
    assert state["next_batch"] == after
    assert state["byte_offset"] == part.stat().st_size
    n_resumed = run_to_tsv(*args, part, cfg, device="cpu", checkpoint=True)
    assert not ckpt.exists()
    assert n_resumed == n_full
    data = part.read_bytes()
    assert data == full.read_bytes()
    assert data == (d / f"jax_{name}_full{suffix}").read_bytes()
    assert data == (d / f"jax_{name}_part{suffix}").read_bytes()
    # The checkpointed file holds the records of a run without one.
    plain = tmp_path / "plain.tsv"
    assert run_to_tsv(*args, plain, cfg, device="cpu",
                      checkpoint=False) == n_full
    text = gzip.decompress(data).decode() if suffix.endswith(".gz") \
        else data.decode()
    assert text == plain.read_text()
    if suffix.endswith(".gz"):
        # One member for the header and one per non-empty batch.
        assert data.count(b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x02\xff") > 2


@pytest.mark.parametrize("name", list(INPUTS))
def test_changed_run_is_refused_as_in_jax(jax_ref, tmp_path, name):
    d, meta = jax_ref
    args, cfg, _after = _port_args(d, name)
    part = tmp_path / "refuse.tsv"
    _interrupted(drv, 1, run_to_tsv, *args, part, cfg, device="cpu")
    changed = args[0].copy()
    changed[0, 0] = (changed[0, 0] + 1) % 4
    sm = [int(p) for p in args[2]]
    annot = PairAnnot({p: "0" for p in sm}, {p: f"site{p}" for p in sm})
    engine = "majmin" if name == "majmin" else "hybrid"
    tries = ((args, DriverConfig(**{**INPUTS[name][2], "tile": 64}), {}),
             ((changed,) + args[1:], cfg, {}),
             (args, cfg, {"annot": annot}))
    for (a, c, kw), want in zip(tries, meta[name]["refusals"]):
        with pytest.raises(RuntimeError) as got:
            run_to_tsv(*a, part, c, device="cpu", **kw)
        msg = str(got.value).replace(str(tmp_path / "refuse"),
                                     str(d / f"jax_{name}_refuse"))
        assert msg == want.replace("engine=pallas", f"engine={engine}")
        assert "--tile/--seq-chunk/--tiles-per-batch" in msg
    # The original run still resumes and finishes the file.
    run_to_tsv(*args, part, cfg, device="cpu")
    full = tmp_path / "full.tsv"
    run_to_tsv(*args, full, cfg, device="cpu", checkpoint=False)
    assert part.read_bytes() == full.read_bytes()


@pytest.mark.parametrize("name", list(INPUTS))
def test_progress_and_records_equal_jax(jax_ref, name):
    d, meta = jax_ref
    args, cfg, _after = _port_args(d, name)
    sess = LdSession(*args, DriverConfig(**{**INPUTS[name][2],
                                            "progress_every_s": 0.0}),
                     device="cpu")
    reports = []
    for _b, _rec in sess.stream(on_progress=lambda p: reports.append(
            [p.pairs_done, p.pairs_total, p.records_emitted])):
        pass
    assert reports == meta[name]["progress"]
    assert len(reports) == sess.n_batches
    assert [r[0] == r[1] for r in reports].count(True) == 1
    assert reports[-1][0] == reports[-1][1]
    if name == "hybrid":
        assert sess.phase_tiles["general"] and sess.phase_tiles["majmin"]
    got = collect_ld_records(*args, cfg, device="cpu")
    with np.load(d / f"jax_{name}_records.npz") as z:
        want = [z[f"arr_{i}"] for i in range(5)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_progress_reports_at_most_every_interval(jax_ref, monkeypatch):
    d, _meta = jax_ref
    args, cfg, _after = _port_args(d, "hybrid")
    sess = LdSession(*args, cfg, device="cpu")
    ticks = iter(float(t) for t in range(0, 1000, 4))
    monkeypatch.setattr(drv.time, "monotonic", lambda: next(ticks))
    reports = []
    for _ in sess.stream(on_progress=reports.append):
        pass
    # One tick of 4 s per batch: a report once more than 10 s passed since
    # the last one, and the last batch's (the 12th, at 48 s, is both).
    assert sess.n_batches == 12
    assert [r.elapsed_s for r in reports] == [12.0, 24.0, 36.0, 48.0]
    assert reports[-1].pairs_done == reports[-1].pairs_total


@pytest.mark.parametrize("npz", ["jax", "port"])
def test_cache_round_trips_between_packages(jax_ref, npz):
    d, meta = jax_ref
    want = meta[f"load-{npz}"]
    rc, out, err = run_cli(cli.main, ["--load-prepared",
                                      str(d / f"{npz}.npz"),
                                      "--device", "cpu"] + LAY)
    assert rc == want["rc"] == 0
    assert out == want["out"] and out.count("\n") > 10
    # The cache was prepared with --min-acgt 0.7: both CLIs warn alike.
    assert want["err"] == err + "\n"
    assert err.startswith("warning: --load-prepared ignores preparation "
                          "flags; cached vs requested: {'min_acgt': (0.7, "
                          "0.8)}")
    res, prep = load_prepared(d / f"{npz}.npz")
    assert prep["min_acgt"] == 0.7 and prep["fasta_reader"] == "python"
    other, _ = load_prepared(d / ("port.npz" if npz == "jax" else
                                  "jax.npz"))
    for field in ("alignment", "site_map", "weights", "hk_mask", "ld_mask"):
        np.testing.assert_array_equal(getattr(res, field),
                                      getattr(other, field))


def test_cache_refuses_another_format(tmp_path):
    path = tmp_path / "old.npz"
    with open(path, "wb") as fh:
        np.savez_compressed(fh, format_version=1)
    with pytest.raises(ValueError, match="format 1 != 2"):
        load_prepared(path)


def test_profile_dir_writes_a_trace_and_the_same_bytes(jax_ref, tmp_path):
    d, _meta = jax_ref
    args, cfg, _after = _port_args(d, "hybrid")
    plain = tmp_path / "plain.tsv"
    run_to_tsv(*args, plain, cfg, device="cpu")
    traced = tmp_path / "traced.tsv"
    with device_trace(tmp_path / "prof", "cpu"):
        run_to_tsv(*args, traced, cfg, device="cpu")
    assert traced.read_bytes() == plain.read_bytes()
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert any(n and "aten::" in n for n in names)
    with device_trace(None):
        pass
    # Through the CLI: the bytes of the run without --profile-dir.
    base = ["--file", str(d / "amb.fasta"), "--engine", "tiled", "--tile",
            "16", "--seq-chunk", "64", "--device", "cpu"]
    rc, out, _err = run_cli(cli.main, base)
    rc2, out2, _err2 = run_cli(cli.main, base + ["--profile-dir",
                                                 str(tmp_path / "cli")])
    assert rc == rc2 == 0 and out == out2
    assert len(list((tmp_path / "cli").glob("trace_*.json"))) == 1
