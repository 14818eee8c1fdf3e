"""stream_s: the mean host-clock time of the stream queries (records
consumed on the host) in the window, each until its result is on the
host."""


def read(run):
    vals = [q["seconds"] for q in run.window.queries
            if q["kind"] == "stream" and q["error"] is None]
    return sum(vals) / len(vals) if vals else None
