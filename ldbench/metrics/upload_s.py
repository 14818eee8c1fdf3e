"""upload_s: the mean per CLI job of the program's stage span ``upload``
(the session set-up: plan, packing, copies to the card, planes). Nothing
where no job has the span."""


def read(run):
    jobs = [j for j in run.window.jobs if j["rc"] == 0]
    vals = [j["spans"]["upload"] for j in jobs if "upload" in j["spans"]]
    if not vals:
        return None
    return sum(vals) / len(jobs)
