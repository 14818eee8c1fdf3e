"""ingest_s: the mean per CLI job of the program's stage span ``ingest``
(the reader (native or Python), from the file to the code matrix).
Nothing where no job has the span."""


def read(run):
    jobs = [j for j in run.window.jobs if j["rc"] == 0]
    vals = [j["spans"]["ingest"] for j in jobs if "ingest" in j["spans"]]
    if not vals:
        return None
    return sum(vals) / len(jobs)
