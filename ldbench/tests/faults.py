"""Faults planted in the program underneath a run, for the tests that see
the comparison catch them.  Each patches the place where an answer is
produced in every engine a cell's traffic may take: the tiled session's
batch read (session queries, and CLI jobs over more than 2,048 sites) and
the dense engine (CLI jobs over fewer, as a masked alignment's)."""

from __future__ import annotations

import numpy as np

from weightedld_tpu_torch import cli
from weightedld_tpu_torch.core import ld_dense
from weightedld_tpu_torch.core.ld_dense import LdRecords
from weightedld_tpu_torch.runtime import driver


def r2_off(rec):
    """The first r2 of a batch moved in the 4th decimal where it is
    produced."""
    r2 = np.array(rec.r2, copy=True)
    r2[0] += np.float32(1e-4)
    return LdRecords(rec.pos_a, rec.pos_b, rec.d, rec.d_prime, r2)


def dropped(rec):
    """The first record of a batch dropped where it is produced."""
    return LdRecords(*(np.asarray(f)[1:] for f in rec))


def patch_records(monkeypatch, edit) -> None:
    """``edit`` applied to every non-empty set of records the program
    produces, in a session's batch read and in the dense engine."""
    real_read = driver.LdSession._read_records
    real_extract = ld_dense.extract_records

    def read(self, b, launched, scale):
        rec = real_read(self, b, launched, scale)
        return edit(rec) if len(rec.r2) else rec

    def extract(*a, **kw):
        rec = real_extract(*a, **kw)
        return edit(rec) if len(rec.r2) else rec

    monkeypatch.setattr(driver.LdSession, "_read_records", read)
    monkeypatch.setattr(ld_dense, "extract_records", extract)


def drop_half(monkeypatch) -> None:
    """Half of the work left out: every second tile pair of each batch a
    session's kernels compute, and in the dense engine every second row of
    the pair matrix (a session over a few tiles runs one batch)."""
    real_dispatch = driver.LdSession._dispatch
    real_dense = ld_dense.ld_all_pairs_dense

    def dispatch(self, b, shard=0):
        st, ti, tj = real_dispatch(self, b, shard)
        st.keep[1::2] = False
        return st, ti, tj

    def dense(alignment, weights):
        st = real_dense(alignment, weights)
        keep = st.keep.clone()
        keep[1::2] = False
        return st._replace(keep=keep)

    monkeypatch.setattr(driver.LdSession, "_dispatch", dispatch)
    monkeypatch.setattr(ld_dense, "ld_all_pairs_dense", dense)


def lazy_jobs(monkeypatch) -> None:
    """A CLI job that returns 0 without writing its output: the first job
    (the warm-up's, whose file would otherwise stand) writes, the rest do
    not, whatever engine they would take."""
    real = cli.main
    calls = []

    def lazy(*a, **kw):
        calls.append(1)
        return real(*a, **kw) if len(calls) <= 1 else 0

    monkeypatch.setattr(cli, "main", lazy)
