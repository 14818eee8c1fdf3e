"""general_kernel_s: the summed device time of the program's
``batch.kernel`` spans in the window whose kernel class is ``general``
(the P-plane kernel, ``attrs["kernel"]``; CUDA events on the slice's
stream at the span's entry and exit) over the queries completed.  Nothing
where the program keeps no spans, names no kernel class (a program older
than the attribute), ran no general batch, or a span has no device time
(the CPU)."""

from pathlib import Path

from ldbench.harness.spec import load_module

program_spans = load_module(Path(__file__).with_name("program_spans.py"))


def read(run):
    spans = program_spans.window_spans(run)
    dev = [s.device_s for s in spans or () if s.name == "batch.kernel"
           and s.attrs.get("kernel") == "general"]
    if not dev or any(d is None for d in dev):
        return None
    queries = sum(1 for q in run.window.queries if q["error"] is None)
    return sum(dev) / queries if queries else None
