"""prune_sweep_s: the mean per ``prune`` query of the window (a root span
``query.prune``) of its ``prune.sweep`` span: the host's greedy sweep
after the query's scan (minor-allele fractions, the lexsort of the pairs
above the threshold, the loop over them).  Nothing where the program
keeps no spans or the window holds no prune."""

from pathlib import Path

from ldbench.harness.spec import load_module

program_spans = load_module(Path(__file__).with_name("program_spans.py"))


def read(run):
    spans = program_spans.window_spans(run)
    if spans is None:
        return None
    prunes = program_spans.roots(spans, "query.prune")
    if not prunes:
        return None
    sweep = sum(s.end - s.start for s in spans
                if s.name == "prune.sweep" and s.root_id in prunes)
    return sweep / len(prunes)
