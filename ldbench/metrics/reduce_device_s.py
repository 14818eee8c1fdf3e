"""reduce_device_s: the summed device time of the program's
``batch.reduce`` spans in the window (the masks, threshold, compaction and
copy starts, moments, top-k and bins launched over each batch's
statistics; CUDA events on the slice's stream at the span's entry and
exit) over the queries completed.  Nothing where the program keeps no
spans or a span has no device time (the CPU)."""

from pathlib import Path

from ldbench.harness.spec import load_module

program_spans = load_module(Path(__file__).with_name("program_spans.py"))


def read(run):
    spans = program_spans.window_spans(run)
    dev = [s.device_s for s in spans or () if s.name == "batch.reduce"]
    if not dev or any(d is None for d in dev):
        return None
    queries = sum(1 for q in run.window.queries if q["error"] is None)
    return sum(dev) / queries if queries else None
