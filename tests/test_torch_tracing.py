"""The port's tracer (``weightedld_tpu_torch/runtime/profiling.py``) on the
CPU: off without a profiler (no range, no event, nothing stored), and
under a CPU ``torch.profiler`` the spans of a CLI job and of every session
query, their counts against the session's own, their ranges in the
exported Chrome trace, and ``StageTimer``'s spans unchanged."""

from __future__ import annotations

import collections
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from weightedld_tpu_torch import cli
from weightedld_tpu_torch.runtime import profiling
from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession
from weightedld_tpu_torch.runtime.profiling import StageTimer

N_SEQS, N_SITES, TILE = 40, 400, 64

QUERIES = {
    "stream": lambda s: list(s.stream()),
    "summarize": lambda s: s.summarize(),
    "top_pairs": lambda s: s.top_pairs(3),
    "ld_decay": lambda s: s.ld_decay([0, 50, 500, 5000]),
    "r2_histogram": lambda s: s.r2_histogram([0.0, 0.1, 0.5, 1.0]),
    "prune": lambda s: s.prune(0.2),
    "matrices": lambda s: s.matrices(),
}


def _codes(seed: int = 0) -> np.ndarray:
    """Major, minor or missing cells, 60 / 30 / 10 %."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([0, 1, 4], np.int8), p=[0.6, 0.3, 0.1],
                      size=(N_SEQS, N_SITES))


def _session(shards: int = 1) -> LdSession:
    return LdSession(_codes(), None, np.arange(N_SITES) * 10 + 1,
                     DriverConfig(tile=TILE, r2_threshold=0.1,
                                  tiles_per_shard_batch=4),
                     devices=["cpu"] * shards)


def _write_vcf(path, seed: int = 1) -> None:
    """A phased VCF of N_SEQS haplotypes with missing calls."""
    codes = _codes(seed)
    gt = np.where(codes == 0, "0", np.where(codes == 1, "1", "."))
    samples = [f"s{i}" for i in range(N_SEQS // 2)]
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(samples)]
    for j in range(N_SITES):
        calls = [f"{gt[2 * i, j]}|{gt[2 * i + 1, j]}"
                 for i in range(len(samples))]
        lines.append(f"1\t{100 + 10 * j}\t.\tA\tG\t.\tPASS\t.\tGT\t"
                     + "\t".join(calls))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def vcf(tmp_path_factory):
    path = tmp_path_factory.mktemp("vcf") / "in.vcf"
    _write_vcf(path)
    return path


def _argv(vcf, out, *extra):
    return ["--file", str(vcf), "--engine", "tiled", "--tile", str(TILE),
            "--r2-threshold", "0.1", "--pair-output", str(out),
            "--device", "cpu", *extra]


def _traced(fn):
    """``fn()`` under a CPU profiler: ``(its result, the spans it
    finished)``."""
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.spans() if s.start >= t0]


def _children(spans, parent) -> list:
    return [s for s in spans if s.parent_id == parent.id]


@pytest.mark.parametrize("query", [*QUERIES, "cli"])
def test_off_without_a_profiler(monkeypatch, tmp_path, vcf, query):
    """No profiler: no range is entered, no CUDA event made, no span
    stored, and ``span`` gives the one shared null context."""
    def refuse(*_a, **_k):
        raise AssertionError("entered while no profiler records")

    sess = None if query == "cli" else _session()
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = len(profiling.spans())
    if query == "cli":
        assert cli.main(_argv(vcf, tmp_path / "o.tsv")) == 0
    else:
        QUERIES[query](sess)
    assert len(profiling.spans()) == before
    assert profiling.span("x") is profiling.span("y", device=True)
    assert not profiling.span("x")


@pytest.mark.parametrize("extra", [(), ("--stats-only",), ("--top", "3"),
                                   ("--prune-r2", "0.2")])
def test_cli_stage_keys_unchanged(tmp_path, vcf, extra):
    """``StageTimer.spans`` has the same keys with and without a profiler,
    and a default job the keys it always had; the stages' extents hold
    their nested spans."""
    keys, spans = [], None
    for on in (False, True):
        timer = StageTimer()

        def job():
            return cli.main(_argv(vcf, tmp_path / "o.tsv", *extra),
                            timer=timer)

        if on:
            rc, spans = _traced(job)
        else:
            rc = job()
        assert rc == 0
        keys.append(list(timer.spans))
    assert keys[0] == keys[1]
    if not extra:
        assert keys[0] == ["ingest", "weights", "upload", "scan+write"]
    for st in (s for s in spans if s.name.startswith("stage.")):
        for ch in _children(spans, st):
            assert st.start <= ch.start <= ch.end <= st.end


def test_cli_job_spans(tmp_path, vcf):
    """A job is ``job`` (with its exit code) -> ``stage.*``: the upload's
    host and copy spans under ``stage.upload``, the reader under
    ``stage.ingest``, the weights' path on ``stage.weights``."""
    rc, spans = _traced(lambda: cli.main(_argv(vcf, tmp_path / "o.tsv")))
    assert rc == 0
    (job,) = [s for s in spans if s.name == "job"]
    assert job.parent_id is None and job.attrs["rc"] == 0
    assert all(s.root_id == job.id and s.root_name == "job" for s in spans)
    stages = {s.name: s for s in _children(spans, job)}
    assert set(stages) == {"stage.ingest", "stage.weights", "stage.upload",
                           "stage.scan+write"}
    upload = {s.name for s in _children(spans, stages["stage.upload"])}
    assert {"upload.scan", "upload.pack", "upload.plan", "upload.copy",
            "upload.sync"} <= upload
    (read,) = [s for s in _children(spans, stages["stage.ingest"])
               if s.name == "ingest.read"]
    assert read.attrs == {"bytes": vcf.stat().st_size, "sites": N_SITES}
    assert stages["stage.weights"].attrs == {"path": "host_f64",
                                             "cells": N_SEQS * N_SITES}
    (stream,) = _children(spans, stages["stage.scan+write"])
    assert stream.name == "query.stream"
    assert all(s.device_s is None for s in spans)     # the CPU


def test_profile_dir_traces_the_whole_job(tmp_path, vcf):
    """``--profile-dir`` traces from ingest to the last write: the trace
    holds the program's ranges of every stage, and the output its bytes
    without the flag."""
    plain, traced = tmp_path / "plain.tsv", tmp_path / "traced.tsv"
    assert cli.main(_argv(vcf, plain)) == 0
    assert cli.main(_argv(vcf, traced, "--profile-dir",
                          str(tmp_path / "prof"))) == 0
    assert traced.read_bytes() == plain.read_bytes()
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert {"wld.stage.ingest", "wld.ingest.read", "wld.stage.weights",
            "wld.stage.upload", "wld.upload.scan", "wld.stage.scan+write",
            "wld.query.stream", "wld.batch.kernel", "wld.batch.read"} <= names


@pytest.mark.parametrize("shards", (1, 2))
@pytest.mark.parametrize("query", list(QUERIES))
def test_session_query_spans(query, shards):
    """Each query method is a root ``query.<kind>`` whose batch loop opens
    ``batch.kernel`` and ``batch.reduce`` for every batch and shard slice;
    a scan's ``batch.read`` spans are one per slice, their records and
    paths those of the session's own counts."""
    sess = _session(shards)
    counts = dict(sess.path_counts)
    out, spans = _traced(lambda: QUERIES[query](sess))
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == f"query.{query}" and root.root_name == root.name
    assert all(s.root_id == root.id for s in spans)
    names = collections.Counter(s.name for s in spans)
    slices = sess.n_batches * shards
    assert names["batch.kernel"] == names["batch.reduce"] == slices
    kernels = [s for s in spans if s.name == "batch.kernel"]
    assert sum(s.attrs["tile_pairs"] for s in kernels) == sess.plan.n_tiles
    assert all(s.device_s is None for s in spans)
    reads = [s for s in spans if s.name == "batch.read"]
    if query not in ("stream", "prune"):
        assert not reads
        return
    assert len(reads) == slices
    paths = collections.Counter(s.attrs["path"] for s in reads)
    assert {k: sess.path_counts[k] - counts[k] for k in counts} \
        == {k: paths[k] for k in counts}
    # A fresh session has no capacity for its first two batches, whose
    # slices take the exact path; later ones, where they overflow.
    unsized = [s for s in reads if s.attrs["capacity"] is None]
    assert len(unsized) == 2 * shards
    assert {s.attrs["path"] for s in unsized} == {"exact"}
    gathered = sum(s.attrs["records"] for s in spans
                   if s.name == "batch.gather")
    assert sum(s.attrs["records"] for s in reads) == gathered
    if query == "stream":
        assert gathered == sum(len(rec) for _b, rec in out)
    else:
        (sweep,) = [s for s in spans if s.name == "prune.sweep"]
        assert sweep.parent_id == root.id and sweep.attrs["pairs"] == gathered
        (scan,) = [s for s in spans if s.name == "query.stream"]
        assert scan.parent_id == root.id and scan.end <= sweep.start


@pytest.mark.parametrize("shards", (1, 2))
def test_ld_decay_reduce_spans_name_their_path(shards):
    """``ld_decay``'s ``batch.reduce`` spans say which version reduced the
    slice (``plain`` on the CPU, ``ld_decay_bins`` on a card) and how many
    pair slots it read: every batch's tile pairs times T^2."""
    sess = _session(shards)
    _out, spans = _traced(lambda: sess.ld_decay([0, 50, 500, 5000]))
    reduces = [s for s in spans if s.name == "batch.reduce"]
    assert len(reduces) == sess.n_batches * shards
    assert {s.attrs["kernel"] for s in reduces} == {"plain"}
    tiles = sum(len(sess.batch_tiles_host(b, sh)[0])
                for b in range(sess.n_batches) for sh in range(shards))
    assert sum(s.attrs["slots"] for s in reduces) == tiles * TILE ** 2


def test_stream_span_closes_with_the_generator():
    """A stream closed after its first batch ends its span then; spans
    opened between its items are not its children."""
    sess = _session()

    def run():
        gen = sess.stream()
        next(gen)
        with profiling.span("between"):
            pass
        gen.close()
        return gen

    _gen, spans = _traced(run)
    (stream,) = [s for s in spans if s.name == "query.stream"]
    (between,) = [s for s in spans if s.name == "between"]
    assert between.parent_id == stream.id       # opened while it was open
    assert stream.end >= between.end
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("after") as after:
            pass
    assert after.parent_id is None


def test_chrome_trace_holds_the_ranges_inside_the_callers(tmp_path):
    """The exported trace has a ``wld.`` range for every span, nested in
    time inside the caller's own range."""
    sess = _session()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller.query"):
            sess.summarize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (caller,) = [e for e in ev if e["name"] == "caller.query"]
    wld = [e for e in ev if e["name"].startswith("wld.")]
    names = collections.Counter(e["name"] for e in wld)
    assert names["wld.query.summarize"] == 1
    assert names["wld.batch.kernel"] == sess.n_batches
    for e in wld:
        assert caller["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= caller["ts"] + caller["dur"]


def test_bounded_list_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "_done", collections.deque(maxlen=3))
    monkeypatch.setattr(profiling, "_dropped", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span(f"s{i}", i=i):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4"]
    assert profiling.dropped() == 2
