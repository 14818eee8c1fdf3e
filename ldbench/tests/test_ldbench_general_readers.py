"""The readers of the general kernel's two metrics, on hand-built spans and
traces: ``general_kernel_s`` sums only the ``batch.kernel`` spans of the
general class in the window, and ``ld_general_roofline`` takes the general
class's least work at the session's P over the ``ld_general*`` kernels'
device time.  Each gives nothing where there is nothing of its kernel to
read."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from ldbench.harness.spec import load_module
from ldbench.harness.trace import TraceSummary
from ldbench.tests.test_ldbench_program_spans import T0, _reader, _run, _span
from ldbench.tests.test_ldbench_roofline import _codes, _work, roofline
from weightedld_tpu_torch.runtime import profiling

# General batches in the window and one before it; factorized ones are left
# out.
SPANS = [_span(1, "query.summarize", T0 + 1),
         _span(2, "batch.kernel", T0 + 1, 0.1, 1, 1, device_s=0.03,
               kernel="general", planes=5),
         _span(3, "batch.kernel", T0 + 1.1, 0.1, 1, 1, device_s=0.05,
               kernel="general", planes=5),
         _span(4, "batch.kernel", T0 + 1.2, 0.1, 1, 1, device_s=7.0,
               kernel="majmin"),
         _span(5, "batch.kernel", T0 - 3, 0.1, 1, 1, device_s=9.0,
               kernel="general", planes=5)]
QUERIES = (("summarize", None), ("stream", None),
           ("top_pairs", "RuntimeError: x"))


def test_general_kernel_s_keeps_the_window(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: SPANS)
    got = _reader("general_kernel_s").read(_run(QUERIES))
    assert got == pytest.approx(0.04)


def test_general_kernel_s_nothing_for_an_empty_window(monkeypatch):
    late = [SimpleNamespace(**{**vars(s), "start": s.start + 1000})
            for s in SPANS]
    monkeypatch.setattr(profiling, "spans", lambda: late)
    assert _reader("general_kernel_s").read(_run(QUERIES)) is None


def test_general_kernel_s_of_a_program_without_spans(monkeypatch):
    """The parent's tracer may have no ``spans()``: the reader gives
    None."""
    monkeypatch.delattr(profiling, "spans")
    assert _reader("general_kernel_s").read(_run(QUERIES)) is None


@pytest.mark.parametrize("attrs, device_s", [
    ({}, 0.02), ({"kernel": "majmin"}, 0.02),
    ({"kernel": "general", "planes": 5}, None)])
def test_general_kernel_s_needs_the_kernel_class(monkeypatch, attrs,
                                                 device_s):
    """A program whose ``batch.kernel`` spans name no kernel class (one
    older than the attribute), or whose window ran only factorized
    batches, gives nothing; so does the CPU, where spans have no device
    time."""
    spans = [_span(2, "batch.kernel", T0 + 1, 0.1, 1, 1, device_s=device_s,
                   **attrs)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _reader("general_kernel_s").read(_run((("stream", None),))) \
        is None


def _roofline_reader():
    return load_module(Path(roofline.__file__).with_name(
        "ld_general_roofline.py"))


def _view(work: dict, op_s: dict, queries: int):
    trace = TraceSummary(window_s=20.0, busy_s=sum(op_s.values()),
                         op_s=op_s)
    return SimpleNamespace(window=SimpleNamespace(
        trace=trace, work=work,
        queries=[{"kind": "summarize", "error": None}] * queries
        + [{"kind": "stream", "error": "RuntimeError: x"}]))


def test_ld_general_roofline_reads_the_general_class_with_its_planes():
    """The general kernel's share: the general class's least work at the
    session's P, times the scans completed, over the ``ld_general*``
    kernels' device time; the factorized kernel's time is not its own."""
    reader = _roofline_reader()
    _sess, work = _work(_codes(True), kernel="general")
    assert work["general"]["planes"] == 5
    least, _bound = roofline.least_seconds("general", **work["general"])
    op_s = {"ld_general_wgmma<5, 3, 0, false, false>": 0.4,
            "ld_general_unit<5>": 0.1, "ld_majmin_wgmma<3, 0>": 9.0}
    got = reader.read(_view(work, op_s, queries=6))
    assert got == pytest.approx(100.0 * least * 6 / 0.5)
    # Where operations bound the work (N = 100,000), fewer planes are
    # less of it: the reader takes the session's P.
    big = {**work["general"], "n_seqs": 100_000}
    five = reader.read(_view({"general": big}, op_s, queries=6))
    three = reader.read(_view({"general": {**big, "planes": 3}}, op_s,
                              queries=6))
    assert roofline.least_seconds("general", **big)[1] == "operations"
    assert three / five == pytest.approx((2 * 3 + 4) / (2 * 5 + 4))


def test_ld_general_roofline_nothing_without_its_kernel():
    reader = _roofline_reader()
    _sess, work = _work(_codes(True), kernel="general")
    assert reader.read(_view(work, {"ld_majmin_wgmma<3, 0>": 1.0}, 6)) \
        is None
    assert reader.read(_view({}, {"ld_general_wgmma<5>": 1.0}, 6)) is None
    view = _view(work, {"ld_general_wgmma<5>": 1.0}, 6)
    view.window.trace = None
    assert reader.read(view) is None
