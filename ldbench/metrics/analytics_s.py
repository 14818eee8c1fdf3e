"""analytics_s: the mean host-clock time of the analytics queries in the
window (``ld_decay``, ``r2_histogram``, ``top_pairs``, ``prune``), each
until its result is on the host."""

KINDS = ("ld_decay", "r2_histogram", "top_pairs", "prune")


def read(run):
    vals = [q["seconds"] for q in run.window.queries
            if q["kind"] in KINDS and q["error"] is None]
    return sum(vals) / len(vals) if vals else None
