"""exact_slice_pct.cli: the share of the CLI jobs' shard slices in the
window whose records took the exact compaction path (``torch.nonzero``
with a synchronization) over all slices read, from the program's
``batch.read`` spans.  Nothing where the program keeps no spans."""

from pathlib import Path

from ldbench.harness.spec import load_module

program_spans = load_module(Path(__file__).with_name("program_spans.py"))


def read(run):
    return program_spans.exact_pct(run)
