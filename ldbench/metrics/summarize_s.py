"""summarize_s: the mean host-clock time of the summarize queries in the
window, each until its result is on the host."""


def read(run):
    vals = [q["seconds"] for q in run.window.queries
            if q["kind"] == "summarize" and q["error"] is None]
    return sum(vals) / len(vals) if vals else None
