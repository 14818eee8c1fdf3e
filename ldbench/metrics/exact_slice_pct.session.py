"""exact_slice_pct.session: the share of the session queries' shard
slices in the window whose records took the exact compaction path
(``torch.nonzero`` with a synchronization) over all slices read, from the
program's ``batch.read`` spans (``stream`` and ``prune``).  Nothing where
the program keeps no spans."""

from pathlib import Path

from ldbench.harness.spec import load_module

program_spans = load_module(Path(__file__).with_name("program_spans.py"))


def read(run):
    return program_spans.exact_pct(run)
