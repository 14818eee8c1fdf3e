"""Per-stage wall-clock timing and device traces.

Copy of ``StageTimer`` from ``weightedld_tpu/runtime/profiling.py:19-39``
(the reference's per-stage spans, ``main.rs:128-210``), and a counterpart of
its ``device_trace`` (``:43-51``) on ``torch.profiler`` in place of
``jax.profiler``.  A stage that launches CUDA work must synchronize before
it ends for its span to cover the device time; the driver's stages do (they
end in a host copy).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field

log = logging.getLogger("weightedld_tpu_torch")


@dataclass
class StageTimer:
    spans: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            log.info("stage %-20s %8.3fs", name, dt)

    def report(self) -> str:
        total = sum(self.spans.values())
        denom = total or 1.0
        lines = [f"{k:<20} {v:8.3f}s ({v / denom:5.1%})"
                 for k, v in self.spans.items()]
        lines.append(f"{'total':<20} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | os.PathLike | None, device=None):
    """Record a ``torch.profiler`` trace of the block into ``log_dir`` (a
    no-op without one): CUDA and CPU activity when ``device`` is a CUDA
    device, CPU activity otherwise, written as one Chrome trace file
    ``trace_<ms since epoch>_<pid>.json`` (load it in Perfetto or
    ``chrome://tracing``)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1000)}_"
                        f"{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)
