"""The device trace of a traced run: ``torch.profiler`` over the measured
window, reduced to device busy time, time by device operation, and idle
gaps named by what the host was doing.

The harness marks the window and each host step with
``torch.profiler.record_function`` ranges named ``ldbench.<what>``; a gap
on the device is named by the innermost such range that covers its middle
on the host (the clocks of host and device events are one in the
profiler's trace).
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass, field

WINDOW = "ldbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_s: dict[str, float] = field(default_factory=dict)
    idle_by_host: dict[str, float] = field(default_factory=dict)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}

    def kernel_s(self, prefix: str) -> float:
        """Summed device time of the kernels whose name (namespace and
        ``void`` removed, :func:`_short`) starts with ``prefix``."""
        return sum(v for k, v in self.op_s.items() if k.startswith(prefix))


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool, tmpdir: str, out: list):
    """Profile the block when ``enabled``; append its
    :class:`TraceSummary` to ``out``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    os.unlink(path)
    out.append(summarize(events))


def _short(name: str) -> str:
    """A kernel's name without ``void``, the anonymous namespace and the
    parameter list: ``ld_majmin_wgmma<3, 0, true, true>``."""
    name = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def summarize(events: list) -> TraceSummary:
    """Reduce Chrome-trace events to a :class:`TraceSummary` over the
    window range."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no ldbench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    op_s: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                dev.append((a, b))
                key = _short(e.get("name", cat))
                op_s[key] = op_s.get(key, 0.0) + (b - a) * 1e-6
        elif cat == "user_annotation" and e.get("name", "").startswith(
                "ldbench.") and e["name"] != WINDOW:
            host.append((t0, t1, e["name"][len("ldbench."):]))
    dev.sort()
    gaps = []
    cur = w0
    for a, b in dev:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        gaps.append((cur, w1))
    busy = (w1 - w0) - sum(b - a for a, b in gaps)
    idle: dict[str, float] = {}
    for a, b in gaps:
        # A gap may span several host steps: split it at their edges.
        cuts = sorted({a, b, *(t for h0, h1, _n in host for t in (h0, h1)
                                if a < t < b)})
        for c0, c1 in zip(cuts, cuts[1:]):
            mid = 0.5 * (c0 + c1)
            name, best = "outside", None
            for h0, h1, hname in host:
                if h0 <= mid <= h1 and (best is None or h1 - h0 < best):
                    name, best = hname, h1 - h0
            idle[name] = idle.get(name, 0.0) + (c1 - c0) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                        op_s=op_s, idle_by_host=idle)
