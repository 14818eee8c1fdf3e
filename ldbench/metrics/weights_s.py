"""weights_s: the mean per CLI job of the program's stage span ``weights``
(the Henikoff weights, on the host in float64 or on the card). Nothing
where no job has the span."""


def read(run):
    jobs = [j for j in run.window.jobs if j["rc"] == 0]
    vals = [j["spans"]["weights"] for j in jobs if "weights" in j["spans"]]
    if not vals:
        return None
    return sum(vals) / len(jobs)
