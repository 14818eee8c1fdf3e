"""scan_write_s: the mean per CLI job of the batch loop's stage spans,
``scan``, ``scan+write`` and ``write`` summed (the kernels, the threshold,
the compaction, the copies to the host and the TSV writer)."""

SPANS = ("scan", "scan+write", "write")


def read(run):
    jobs = [j for j in run.window.jobs if j["rc"] == 0]
    if not jobs:
        return None
    return sum(sum(j["spans"].get(s, 0.0) for s in SPANS)
               for j in jobs) / len(jobs)
