"""The readers of the program's spans on hand-built span lists: each keeps
the spans that started in the window, gives its number from them, and
gives nothing for an empty window or a program that keeps no spans."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from ldbench.harness.spec import load_module
from weightedld_tpu_torch.runtime import profiling

METRICS = Path(__file__).resolve().parents[1] / "metrics"
T0, WINDOW = 100.0, 20.0


def _reader(name: str):
    return load_module(METRICS / f"{name}.py")


def _span(sid, name, start, dur=0.1, parent=None, root=None, device_s=None,
          **attrs):
    return SimpleNamespace(id=sid, name=name, start=start, end=start + dur,
                           parent_id=parent, root_id=root or sid,
                           attrs=attrs, device_s=device_s)


def _run(queries=()):
    return SimpleNamespace(window=SimpleNamespace(
        t_first=T0, window_s=WINDOW, jobs=[],
        queries=[{"kind": k, "seconds": 0.05, "error": e}
                 for k, e in queries]))


def _job(sid, start, rc, upload):
    """A job root and its upload spans, ``upload`` seconds each of scan,
    pack and plan, and a copy that upload_host_s leaves out."""
    return [_span(sid, "job", start, 1.0, rc=rc),
            *(_span(sid + i, n, start + 0.1 * i, upload, sid, sid)
              for i, n in enumerate(("upload.scan", "upload.pack",
                                     "upload.plan", "upload.copy"), 1))]


def _reads(start, exact, speculative, root=1):
    out = [_span(10 + i, "batch.read", start, 0.01, root, root, path="exact")
           for i in range(exact)]
    out += [_span(50 + i, "batch.read", start, 0.01, root, root,
                  path="speculative") for i in range(speculative)]
    return out


CASES = {
    # Two jobs in the window (one failed), one before it.
    "upload_host_s": ([*_job(1, T0 - 5, 0, 9.0), *_job(20, T0 + 1, 0, 0.1),
                       *_job(40, T0 + 3, 2, 5.0), *_job(60, T0 + 5, 0, 0.2)],
                      (), pytest.approx((3 * 0.1 + 3 * 0.2) / 2)),
    "exact_slice_pct.cli": ([*_reads(T0 - 1, 5, 0), *_reads(T0 + 1, 1, 3)],
                            (), 25.0),
    "exact_slice_pct.session": ([*_reads(T0 + 2, 2, 14)], (), 12.5),
    "reduce_device_s": ([_span(1, "query.stream", T0 + 1),
                         _span(2, "batch.reduce", T0 + 1, 0.1, 1, 1,
                               device_s=0.02),
                         _span(3, "batch.reduce", T0 + 1.1, 0.1, 1, 1,
                               device_s=0.04),
                         _span(4, "batch.reduce", T0 + 30, 0.1, 1, 1,
                               device_s=9.0)],
                        (("stream", None), ("summarize", None),
                         ("prune", "RuntimeError: x")),
                        pytest.approx(0.03)),
    "prune_sweep_s": ([_span(1, "query.prune", T0 + 1, 1.0),
                       _span(2, "prune.sweep", T0 + 1.5, 0.02, 1, 1),
                       _span(3, "query.prune", T0 + 4, 1.0),
                       _span(4, "prune.sweep", T0 + 4.5, 0.04, 3, 3),
                       _span(5, "query.prune", T0 - 4, 1.0),
                       _span(6, "prune.sweep", T0 - 3.5, 7.0, 5, 5)],
                      (), pytest.approx(0.03)),
}


@pytest.mark.parametrize("metric", list(CASES))
def test_reader_keeps_the_window(monkeypatch, metric):
    spans, queries, want = CASES[metric]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _reader(metric).read(_run(queries)) == want


@pytest.mark.parametrize("metric", list(CASES))
def test_reader_gives_nothing_for_an_empty_window(monkeypatch, metric):
    spans, queries, _want = CASES[metric]
    late = [SimpleNamespace(**{**vars(s), "start": s.start + 1000})
            for s in spans]
    monkeypatch.setattr(profiling, "spans", lambda: late)
    assert _reader(metric).read(_run(queries)) is None


@pytest.mark.parametrize("metric", list(CASES))
def test_reader_of_a_program_without_spans(monkeypatch, metric):
    """The parent's tracer has no ``spans()``: every reader gives None."""
    monkeypatch.delattr(profiling, "spans")
    assert _reader(metric).read(_run(CASES[metric][1])) is None


def test_reduce_device_s_nothing_on_the_cpu(monkeypatch):
    spans = [_span(2, "batch.reduce", T0 + 1, 0.1, 1, 1)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _reader("reduce_device_s").read(
        _run((("stream", None),))) is None
