"""upload_host_s: the mean per successful CLI job of the window (a root
span ``job`` with ``rc`` 0) of the host work of the session's set-up: its
spans ``upload.scan`` (plane detection, allele counts, the factorized
kernel's exactness test and aux), ``upload.pack`` (packing permutation,
padded site-major codes, packed weights) and ``upload.plan`` (tile plan,
hybrid split, batch tables), summed.  Nothing where the program keeps no
spans or no job succeeded."""

from pathlib import Path

from ldbench.harness.spec import load_module

program_spans = load_module(Path(__file__).with_name("program_spans.py"))

NAMES = ("upload.scan", "upload.pack", "upload.plan")


def read(run):
    spans = program_spans.window_spans(run)
    if spans is None:
        return None
    jobs = program_spans.roots(spans, "job", rc=0)
    if not jobs:
        return None
    return sum(s.end - s.start for s in spans
               if s.name in NAMES and s.root_id in jobs) / len(jobs)
