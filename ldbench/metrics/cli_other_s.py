"""cli_other_s: the mean per CLI job of its wall less the summed spans of
the program's stage timer (argument parsing, set-up outside the stages,
the fingerprint of a checkpointable run, logging)."""


def read(run):
    jobs = [j for j in run.window.jobs if j["rc"] == 0]
    if not jobs:
        return None
    return sum(j["wall"] - sum(j["spans"].values()) for j in jobs) / len(jobs)
