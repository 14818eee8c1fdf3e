"""The comparison catches a broken timed path: each fault planted in the
program underneath a run (at a tiny size on the CPU) turns ``correct``
false, and so does the control, the reference in bfloat16 put in the
program's place.  One card runs every cell, so no exchange between chips
exists to leave out."""

from __future__ import annotations

import pytest

from ldbench.tests import faults, tiny
from weightedld_tpu_torch.runtime import driver


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", tiny.cells())
@pytest.mark.parametrize("edit", (faults.r2_off, faults.dropped))
def test_altered_answer_is_caught(root, monkeypatch, cell, edit):
    faults.patch_records(monkeypatch, edit)
    rc, res = tiny.run_inprocess(root, cell, seed=21)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", tiny.cells())
def test_half_the_batches_left_out_is_caught(root, monkeypatch, cell):
    faults.drop_half(monkeypatch)
    rc, res = tiny.run_inprocess(root, cell, seed=22)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", tiny.cells("session"))
def test_stale_state_is_caught(root, monkeypatch, cell):
    """A scan that ignores the threshold it is given: the session's state
    answers every stream query."""
    real = driver.LdSession.stream

    def stale(self, start_batch=0, r2_threshold=driver._UNSET, **kw):
        return real(self, start_batch, **kw)

    monkeypatch.setattr(driver.LdSession, "stream", stale)
    rc, res = tiny.run_inprocess(root, cell, seed=23, seconds=6.0)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", tiny.cells("cli"))
def test_job_that_writes_nothing_is_caught(root, monkeypatch, cell):
    """A job that returns without writing its output."""
    faults.lazy_jobs(monkeypatch)
    rc, res = tiny.run_inprocess(root, cell, seed=24, seconds=1.0)
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("cell", tiny.cells())
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


@pytest.mark.parametrize("cell", tiny.cells("session"))
def test_lossy_weight_mode_fails_the_session(root, cell):
    """The program's own int8 weight mode, switched on in a session cell,
    fails its comparison of exact values (a CLI job's 4-dp text cannot
    see it: the bfloat16 reference is that cell's control)."""
    from ldbench import control
    from ldbench.harness import check, spec

    c = spec.load_cell(root, cell)
    gen = spec.load_module(spec.find(root, "generators",
                                     c.config["generator"], ".py"))
    row = control.one_seed(c, gen, 32, "int8", "cpu", 1.0, str(root))
    numbers = {k: row[k] for k in c.limits if k in row}
    numbers["failed"] = 0.0
    ok, _checks = check.verdict(numbers, c.limits)
    assert ok is False
