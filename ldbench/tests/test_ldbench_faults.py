"""The comparison catches a broken timed path: each fault planted in the
program underneath a run (at a tiny size on the CPU) turns ``correct``
false, and so does the control, the reference in bfloat16 put in the
program's place.  One card runs every cell, so no exchange between chips
exists to leave out."""

from __future__ import annotations

import numpy as np
import pytest

from ldbench.tests import tiny
from weightedld_tpu_torch.core.ld_dense import LdRecords
from weightedld_tpu_torch.runtime import driver

CELLS = ("crit250_vcf.cli", "crit250_vcf.session")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


def _patch_records(monkeypatch, edit):
    real = driver.LdSession._read_records

    def read(self, b, launched, scale):
        rec = real(self, b, launched, scale)
        return edit(rec) if len(rec.r2) else rec

    monkeypatch.setattr(driver.LdSession, "_read_records", read)


def _r2_off(rec):
    """The first r2 of a batch moved in the 4th decimal where it is
    produced."""
    r2 = np.array(rec.r2, copy=True)
    r2[0] += np.float32(1e-4)
    return LdRecords(rec.pos_a, rec.pos_b, rec.d, rec.d_prime, r2)


def _dropped(rec):
    """The first record of a batch dropped where it is produced."""
    return LdRecords(*(np.asarray(f)[1:] for f in rec))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("edit", (_r2_off, _dropped))
def test_altered_answer_is_caught(root, monkeypatch, cell, edit):
    _patch_records(monkeypatch, edit)
    rc, res = tiny.run_inprocess(root, cell, seed=21)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batches_left_out_is_caught(root, monkeypatch, cell):
    real = driver.LdSession._pipelined

    def half(self, launch, start=0):
        for b, x in real(self, launch, start):
            if b % 2 == 0:
                yield b, x

    monkeypatch.setattr(driver.LdSession, "_pipelined", half)
    try:
        rc, res = tiny.run_inprocess(root, cell, seed=22)
    except IndexError:
        return      # top_pairs indexes every batch: the run fails outright
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", ("crit250_vcf.session",))
def test_stale_state_is_caught(root, monkeypatch, cell):
    """A scan that ignores the threshold it is given: the session's state
    answers every stream query."""
    real = driver.LdSession.stream

    def stale(self, start_batch=0, r2_threshold=driver._UNSET, **kw):
        return real(self, start_batch, **kw)

    monkeypatch.setattr(driver.LdSession, "stream", stale)
    rc, res = tiny.run_inprocess(root, cell, seed=23, seconds=6.0)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", ("crit250_vcf.cli",))
def test_job_that_writes_nothing_is_caught(root, monkeypatch, cell):
    """A job that returns without writing its output: the first jobs write
    (the warm-up's file would otherwise stand), the rest do not."""
    real = driver.run_to_tsv
    calls = []

    def lazy(*a, **kw):
        calls.append(1)
        return real(*a, **kw) if len(calls) <= 1 else 0

    monkeypatch.setattr(driver, "run_to_tsv", lazy)
    rc, res = tiny.run_inprocess(root, cell, seed=24, seconds=1.0)
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell):
    """The reference in bfloat16 in the program's place fails the
    comparison the cell's limits make."""
    from ldbench import control
    from ldbench.harness import check, spec

    c = spec.load_cell(root, cell)
    gen = spec.load_module(spec.find(root, "generators",
                                     c.config["generator"], ".py"))
    row = control.one_seed(c, gen, 31, "control", "cpu", 1.0,
                           str(root))
    numbers = {k: row[k] for k in c.limits if k in row}
    numbers["failed"] = 0.0
    ok, _checks = check.verdict(numbers, c.limits)
    assert ok is False


def test_lossy_weight_mode_fails_the_session(root):
    """The program's own int8 weight mode, switched on in the session cell,
    fails its comparison of exact values (a CLI job's 4-dp text cannot
    see it: the bfloat16 reference is that cell's control)."""
    from ldbench import control
    from ldbench.harness import check, spec

    c = spec.load_cell(root, "crit250_vcf.session")
    gen = spec.load_module(spec.find(root, "generators",
                                     c.config["generator"], ".py"))
    row = control.one_seed(c, gen, 32, "int8", "cpu", 1.0, str(root))
    numbers = {k: row[k] for k in c.limits if k in row}
    numbers["failed"] = 0.0
    ok, _checks = check.verdict(numbers, c.limits)
    assert ok is False
