"""The reduction of a profiler trace: busy time is the union of device
intervals inside the window, an idle gap is split among the host steps it
spans, and kernels are found by name without namespace or signature."""

from __future__ import annotations

import pytest

from ldbench.harness.trace import summarize


def _x(name, cat, ts, dur):
    return {"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": dur}


def test_busy_idle_and_kernel_names():
    ev = [_x("ldbench.window", "user_annotation", 0, 100),
          _x("ldbench.job", "user_annotation", 0, 100),
          _x("ldbench.stage.ingest", "user_annotation", 0, 30),
          _x("ldbench.stage.weights", "user_annotation", 30, 50),
          _x("(anonymous namespace)::ld_majmin_wgmma<3, 0, true, true>("
             "(anonymous namespace)::Params, int)", "kernel", 80, 10),
          _x("Memcpy HtoD", "gpu_memcpy", 85, 10),     # overlaps the kernel
          _x("void ld_general_wgmma<5>(Params, int)", "kernel", 120, 5)]
    s = summarize(ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(15e-6)
    assert s.kernel_s("ld_majmin") == pytest.approx(10e-6)
    assert s.kernel_s("ld_general") == 0.0       # outside the window
    assert s.idle_by_host == pytest.approx(
        {"stage.ingest": 30e-6, "stage.weights": 50e-6, "job": 5e-6})
    assert s.breakdown()["device_ops"][0][0].startswith("ld_majmin_wgmma")
