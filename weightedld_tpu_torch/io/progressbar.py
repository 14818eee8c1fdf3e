"""Live terminal progress bar with ETA: the analog of the reference Rust
binary's indicatif bars (``main.rs:89-97``), dependency-free.

Copy of ``weightedld_tpu/io/progressbar.py:1-82``.  Renders in place with
``\\r`` when the stream is a TTY; on other streams one full line per
update.  Used as the ``on_progress`` callback of
:meth:`weightedld_tpu_torch.runtime.driver.LdSession.stream`, which calls it
at most once per ``progress_every_s`` and on the last batch.
"""

from __future__ import annotations

import time


def _fmt_si(x: float) -> str:
    for div, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if x >= div:
            return f"{x / div:.2f}{suffix}"
    return f"{x:.0f}"


def _fmt_eta(seconds: float) -> str:
    if not (0 <= seconds < 360_000_000):  # NaN/inf/absurd -> unknown
        return "--:--"
    s = int(seconds)
    if s >= 3600:
        return f"{s // 3600}:{s % 3600 // 60:02d}:{s % 60:02d}"
    return f"{s // 60:02d}:{s % 60:02d}"


class ProgressBar:
    """``on_progress`` callable rendering ``[####----] 42% 1.2G/s eta 01:03``.

    The rate (and hence the ETA) is the cumulative pairs/s the driver
    reports — stable under bursty batch completion, exactly what indicatif
    shows with its default estimator.
    """

    def __init__(self, stream, width: int = 30):
        self._stream = stream
        self._width = width
        self._tty = bool(getattr(stream, "isatty", lambda: False)())
        self._last_len = 0
        self._done = False

    def __call__(self, p) -> None:
        if self._done:
            return
        total = max(p.pairs_total, 1)
        frac = min(p.pairs_done / total, 1.0)
        filled = int(frac * self._width)
        rate = p.pairs_per_s
        eta = (total - p.pairs_done) / rate if rate > 0 else float("inf")
        line = (
            f"[{'#' * filled}{'-' * (self._width - filled)}] "
            f"{100 * frac:5.1f}%  {_fmt_si(p.pairs_done)}/"
            f"{_fmt_si(total)} pairs  {_fmt_si(rate)}/s  "
            f"{p.records_emitted:,} records  eta {_fmt_eta(eta)}"
        )
        if self._tty:
            pad = " " * max(0, self._last_len - len(line))
            self._stream.write("\r" + line + pad)
            self._last_len = len(line)
            if frac >= 1.0:
                self._stream.write("\n")
                self._done = True
        else:
            self._stream.write(line + "\n")
            if frac >= 1.0:
                self._done = True
        self._stream.flush()

    def close(self) -> None:
        """Terminate an in-place bar that never reached 100% (e.g. the scan
        raised) so the next stderr line starts clean."""
        if self._tty and not self._done and self._last_len:
            self._stream.write("\n")
            self._stream.flush()
        self._done = True
