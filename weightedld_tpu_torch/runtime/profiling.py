"""Per-stage wall-clock timing.

Copy of ``StageTimer`` from ``weightedld_tpu/runtime/profiling.py:19-39``
(the reference's per-stage spans, ``main.rs:128-210``).  A stage that
launches CUDA work must synchronize before it ends for its span to cover
the device time; the driver's stages do (they end in a host copy).
"""

from __future__ import annotations

import contextlib
import logging
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
