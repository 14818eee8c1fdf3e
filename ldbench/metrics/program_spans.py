"""The program's own spans in a run's window, for the readers of the
per-layer metrics that the program records
(``weightedld_tpu_torch/runtime/profiling.py``: spans are kept while a
profiler records the process, as it does over a traced run's window).

A span is kept when its start lies in ``[t_first, t_first + window_s]``
(both on ``time.monotonic()``).  A program whose tracer keeps no spans
(it has no ``spans()``) gives None, and so does every reader."""


def window_spans(run):
    """The spans that started in the window, oldest first, or None."""
    from weightedld_tpu_torch.runtime import profiling

    read = getattr(profiling, "spans", None)
    if not callable(read):
        return None
    t0 = run.window.t_first
    t1 = t0 + run.window.window_s
    return [s for s in read() if t0 <= s.start <= t1]


def exact_pct(run):
    """100 x the ``batch.read`` slices of the window that took the exact
    compaction path (``attrs["path"] == "exact"``) over all of them."""
    spans = window_spans(run)
    paths = [s.attrs.get("path") for s in spans or ()
             if s.name == "batch.read"]
    if not paths:
        return None
    return 100.0 * paths.count("exact") / len(paths)


def roots(spans, name: str, **attrs) -> set:
    """Ids of the root spans called ``name`` whose attributes include
    ``attrs``."""
    return {s.id for s in spans if s.name == name and s.parent_id is None
            and all(s.attrs.get(k) == v for k, v in attrs.items())}
