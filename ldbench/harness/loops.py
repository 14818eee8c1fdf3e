"""The two kinds of traffic, each a closed loop of one client: CLI jobs
(``loop: "cli"``) and queries to one device-resident session (``loop:
"session"``).  A mix file names its loop and gives its parameters; the
loops read nothing else of it.

Each loop sets up (input file or session, one warm job or one warm query
of each kind), then starts jobs, or cycles of the mix's queries, while
less than ``seconds`` have passed since the first began, and lets the
last one finish.  It
returns what the window produced: the answers, for the check, and the
timings and spans, for the metrics.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
from torch.profiler import record_function

from . import trace


@dataclass
class Window:
    """What a measured window produced."""

    loop: str
    t_first: float = 0.0          # monotonic start of the first job/query
    window_s: float = 0.0
    jobs: list = field(default_factory=list)      # cli: wall, spans, rc
    queries: list = field(default_factory=list)   # session: kind, seconds
    answers: list = field(default_factory=list)   # what the check judges
    failed: int = 0
    trace: object = None          # trace.TraceSummary of a traced run
    work: dict = field(default_factory=dict)      # per kernel class


def _timer_class(traced: bool):
    from weightedld_tpu_torch.runtime.profiling import StageTimer

    if not traced:
        return StageTimer

    class MarkedTimer(StageTimer):
        """The program's stage timer, each stage also a trace range."""

        @contextlib.contextmanager
        def stage(self, name: str):
            with record_function("ldbench.stage." + name), super().stage(name):
                yield

    return MarkedTimer


def run_cli(mix: dict, data: dict, tmpdir: str, device: str,
            seconds: float, traced: bool) -> Window:
    """CLI jobs back to back: ``weightedld_tpu_torch.cli.main(argv)`` in
    this process, from the input file on disk to the output closed."""
    from weightedld_tpu_torch import cli

    inp = str(Path(tmpdir) / ("input" + data["suffix"]))
    out = str(Path(tmpdir) / "out.tsv")
    data["write"](inp)
    # The file's pages reach the disk in set-up, not under the first jobs.
    fd = os.open(inp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    argv = [a.replace("{input}", inp).replace("{output}", out)
            for a in mix["argv"]]
    if device == "cpu":
        argv += ["--device", "cpu"]
    timer_cls = _timer_class(traced)
    rc = cli.main(argv, timer=timer_cls())
    if rc != 0:
        raise RuntimeError(f"the warm-up job exited {rc}: {argv}")
    win = Window(loop="cli")
    outputs: dict[str, bytes] = {}
    summaries: list = []
    with trace.profiled(traced, device != "cpu", tmpdir, summaries):
        with record_function(trace.WINDOW):
            t0 = time.monotonic()
            while time.monotonic() - t0 < seconds:
                timer = timer_cls()
                Path(out).unlink(missing_ok=True)
                j0 = time.monotonic()
                with record_function("ldbench.job"):
                    try:
                        rc = cli.main(argv, timer=timer)
                    except Exception as e:    # a failed job is counted
                        rc = f"{type(e).__name__}: {e}"
                j1 = time.monotonic()
                win.jobs.append({"wall": j1 - j0, "spans": dict(timer.spans),
                                 "rc": rc})
                if rc != 0 or not Path(out).is_file():
                    win.failed += 1
                    continue
                body = Path(out).read_bytes()
                outputs.setdefault(hashlib.sha256(body).hexdigest(), body)
            win.t_first = t0
            win.window_s = time.monotonic() - t0
    win.trace = summaries[0] if summaries else None
    win.answers = [("tsv", body) for body in outputs.values()]
    return win


def build_session(config: dict, data: dict, mix: dict, device: str):
    """The session the way ``examples_torch/serving_session.py`` builds
    it after its read, from the generated matrix: the site mask where the
    configuration masks (FASTA), as the example's read (``wld.prepare``)
    masks, on the host in float64; weights on the device (``weights=None``,
    the example's tip), ``DriverConfig(r2_threshold=...)`` with the mix's
    ``driver`` options, if any.  Returns ``(session, kept positions, kept
    codes)``."""
    from weightedld_tpu_torch.core.sites import compute_variable_sites_host
    from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

    codes = data["codes"]
    pos = data["positions"]
    if config.get("mask"):
        _hk, keep = compute_variable_sites_host(
            codes, config["min_acgt"], config["min_variability"])
        codes = np.ascontiguousarray(codes[:, keep])
        pos = pos[keep]
    sess = LdSession(codes, None, pos,
                     DriverConfig(r2_threshold=mix["session_threshold"],
                                  **mix.get("driver", {})),
                     device=device)
    return sess, pos, codes


def allele_planes(codes: np.ndarray) -> int:
    """The allele codes 0..4 present in ``codes``: the planes P of the
    general kernel's least work."""
    return sum(bool((codes == c).any()) for c in range(5))


FIELDS = ("pos_a", "pos_b", "d", "dp", "r2")


def _records(rec) -> dict:
    return {"pos_a": np.asarray(rec.pos_a), "pos_b": np.asarray(rec.pos_b),
            "d": np.asarray(rec.d), "dp": np.asarray(rec.d_prime),
            "r2": np.asarray(rec.r2)}


def ask(sess, q: dict):
    """One query of the mix's cycle, its result on the host."""
    kind = q["kind"]
    if kind == "stream":
        parts = [_records(rec) for _b, rec in sess.stream(
            **({"r2_threshold": q["r2_threshold"]}
               if "r2_threshold" in q else {}))]
        return {f: np.concatenate([p[f] for p in parts]) if parts
                else np.zeros(0) for f in FIELDS}
    if kind == "summarize":
        if "r2_threshold" in q:
            return sess.summarize(r2_threshold=q["r2_threshold"])
        return sess.summarize()
    if kind == "top_pairs":
        return _records(sess.top_pairs(q["k"]))
    if kind == "r2_histogram":
        return sess.r2_histogram(q["edges"])
    if kind == "ld_decay":
        return sess.ld_decay(q["edges"])
    if kind == "prune":
        return np.asarray(sess.prune(q["r2_threshold"]))
    raise ValueError(f"unknown query kind {kind!r}")


def _cycles(mix: dict, t0: float, seconds: float):
    """The mix's cycle again and again, each begun while less than
    ``seconds`` have passed since ``t0`` and run whole, so that every
    window holds the mix's proportions exactly and every seed the same
    work."""
    for _ in range(mix["max_cycles"]):
        if time.monotonic() - t0 >= seconds:
            return
        yield mix["cycle"]
    raise RuntimeError("the cycles ran out before the window closed: "
                       "raise max_cycles")


def run_session(config: dict, mix: dict, data: dict, tmpdir: str,
                device: str, seconds: float, traced: bool,
                work_of) -> tuple[Window, object]:
    """Queries back to back to one device-resident session;
    ``work_of(session, planes)`` gives the window's work per kernel
    class."""
    sess, pos, codes = build_session(config, data, mix, device)
    for q in mix["cycle"]:          # one warm query of each kind
        ask(sess, q)
    win = Window(loop="session")
    # The planes of the sites the session holds, not of every column.
    win.work = work_of(sess, allele_planes(codes))
    summaries: list = []
    with trace.profiled(traced, device != "cpu", tmpdir, summaries):
        with record_function(trace.WINDOW):
            t0 = time.monotonic()
            queries = (q for cycle in _cycles(mix, t0, seconds)
                       for q in cycle)
            for q in queries:
                kind = q["kind"]
                q0 = time.monotonic()
                with record_function("ldbench.query." + kind):
                    try:
                        ans = ask(sess, q)
                    except Exception as e:     # a failed query is counted
                        ans = None
                        win.failed += 1
                        err = f"{type(e).__name__}: {e}"
                q1 = time.monotonic()
                win.queries.append({"kind": kind, "seconds": q1 - q0,
                                    "error": None if ans is not None else err})
                if ans is not None:
                    win.answers.append((q, ans))
            win.t_first = t0
            win.window_s = time.monotonic() - t0
    win.trace = summaries[0] if summaries else None
    return win, (sess, pos)
