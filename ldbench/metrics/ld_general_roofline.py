"""ld_general_roofline: the share of its roofline that the general kernel
reached in the window: the least time of the work its class did there
(roofline.py: one scan's pairs of the class with the kept sites' P allele
planes, times the scans the window completed) over the summed device time
of the ``ld_general*`` kernels in the trace. Nothing where the class has
no pairs or the trace no such kernel."""

from pathlib import Path

from ldbench.harness.spec import load_module

roofline = load_module(Path(__file__).with_name("roofline.py"))


def read(run):
    tr = run.window.trace
    work = run.window.work.get("general")
    if tr is None or not work:
        return None
    dev_s = tr.kernel_s("ld_general")
    if dev_s <= 0:
        return None
    least, _bound = roofline.least_seconds("general", **work)
    scans = sum(1 for q in run.window.queries if q["error"] is None)
    return 100.0 * least * scans / dev_s
