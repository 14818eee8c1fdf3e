"""The port's multi-process path on the CPU: gloo process groups over
localhost, the counterparts of tests/test_multiprocess.py and
tests/test_cli_multiprocess.py.

* Library: two processes x 1 and x 2 CPU shards each; every process's
  records, summary, top-k, decay and histogram equal a one-process session
  with the same global shard count G, and only process 0 writes
  ``run_to_tsv``'s file.
* CLI: the same command line in two processes (``--coordinator``,
  ``--num-processes``, ``--process-id``) writes the TSV and weights bytes
  of the one-process ``--device cpu --devices G`` run and of the JAX CLI at
  ``--devices G`` (a subprocess with G virtual CPU devices, FMA withheld,
  its tiled sessions on the interpret-mode Pallas kernels);
  ``--stats-only`` prints once; ``--checkpoint`` killed mid-triangle and
  resumed equals an uninterrupted two-process run, plain and ``.gz``; the
  ``JAX_*`` variables bring the group up; a bad coordinator exits 2 with
  the JAX CLI's first stderr line; unequal local shard counts are refused.
* Bring-up rules: the Slurm step rule and its coordinator, a rendezvous
  that times out, and the local shard devices.

Every subprocess has a timeout that kills all of its group.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from weightedld_tpu_torch import cli
from weightedld_tpu_torch.parallel import multihost
from weightedld_tpu_torch.runtime.driver import DriverConfig, LdSession

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240
FLAGS = ["--device", "cpu", "--engine", "tiled", "--tile", "16",
         "--tiles-per-batch", "2"]

# The CLI entry of every process, with an optional kill: after
# WLD_FAULT_AFTER_BATCHES streamed batches the process exits at once, with
# no clean-up (a preemption).
_ENTRY = """
import os, sys
sys.path.insert(0, {repo!r})
fault = int(os.environ.get("WLD_FAULT_AFTER_BATCHES", "0"))
if fault:
    from weightedld_tpu_torch.runtime import driver as _drv
    _orig = _drv.LdSession.stream
    def _stream(self, *a, **k):
        n = 0
        for item in _orig(self, *a, **k):
            yield item
            n += 1
            if n >= fault:
                os._exit(17)
    _drv.LdSession.stream = _stream
from weightedld_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""

_WORKER = """
import json, sys
sys.path.insert(0, {repo!r})
pid, port, n_local, out = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), \\
    sys.argv[4]
from weightedld_tpu_torch.parallel import multihost
multihost.initialize_distributed(f"127.0.0.1:{{port}}", 2, pid)
from tests.test_torch_multiprocess import read_outs
res = read_outs(["cpu"] * n_local, out + ".tsv")
res["is_output"] = multihost.is_output_process()
res["process_count"] = multihost.process_count()
with open(out + f".proc{{pid}}.json", "w") as fh:
    json.dump(res, fh)
"""

_JAX_CLI = """
import sys
sys.path.insert(0, {repo!r})
import weightedld_tpu.runtime.driver as jd
resolve = jd._resolve_engine
jd._resolve_engine = lambda engine, platform=None: (
    "pallas" if engine in ("auto", "tiled") else resolve(engine, platform))
from weightedld_tpu.cli import main
sys.exit(main(sys.argv[1:]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env(**extra) -> dict:
    env = dict(os.environ)
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "SLURM_PROCID",
              "SLURM_STEP_NUM_TASKS", "WLD_FAULT_AFTER_BATCHES"):
        env.pop(k, None)
    env.update(extra)
    return env


def _first_line(err: str) -> str:
    """The first line of standard error that is not a c10d warning (the
    store logs one when it cannot name a loopback peer)."""
    return [ln for ln in err.splitlines() if not ln.startswith("[W")][0]


def _wait_all(procs) -> list[tuple[int, str, str]]:
    """``(rc, stdout, stderr)`` of each process; a timeout kills them
    all."""
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return out


def write_fasta(path: Path, ambiguous: bool = False, seed: int = 7) -> None:
    rng = np.random.default_rng(seed)
    rows = rng.choice(list("AACCGTT-"), size=(24, 120),
                      p=[0.4, 0.15, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05])
    for c in range(1, 120, 3):          # LD: a mutated copy of a neighbour
        rows[:, c] = np.where(rng.random(24) < 0.15, rows[:, c],
                              rows[:, c - 1])
    if ambiguous:
        for c in rng.choice(120, size=6, replace=False):
            rows[rng.integers(24), c] = "N"
    with open(path, "w") as fh:
        for i, row in enumerate(rows):
            fh.write(f">s{i}\n{''.join(row)}\n")


def read_outs(devices, tsv: str) -> dict:
    """A session's read-outs on ``devices`` (one process's shards), and
    ``run_to_tsv`` into ``tsv`` (written by process 0 only)."""
    from weightedld_tpu_torch.runtime.driver import run_to_tsv

    rng = np.random.default_rng(0)
    aln = rng.integers(0, 6, size=(24, 96)).astype(np.int8)
    w = (rng.random(24) + 0.05).astype(np.float32)
    sm = np.arange(96) * 3
    cfg = DriverConfig(tile=16, tiles_per_shard_batch=2, seq_chunk=64)
    sess = LdSession(aln, w, sm, cfg, devices=devices)
    rows = [[int(a), int(b), float(r)] for _b, rec in sess.stream()
            for a, b, r in zip(rec.pos_a, rec.pos_b, rec.r2)]
    top = sess.top_pairs(5)
    out = {"n_shards": sess.n_shards, "rows": rows,
           "summary": sess.summarize(r2_threshold=0.3),
           "top": [[int(a), int(b), float(r)]
                   for a, b, r in zip(top.pos_a, top.pos_b, top.r2)],
           "decay": sess.ld_decay([0, 16, 64, 400]),
           "hist": sess.r2_histogram([0.0, 0.1, 1.01])}
    out["n_tsv"] = run_to_tsv(aln, w, sm, tsv, cfg, devices=devices,
                              checkpoint=False)
    return out


@pytest.mark.parametrize("n_local", (1, 2))
def test_two_processes_equal_one_process_session(tmp_path, n_local):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=str(REPO)))
    port = str(_free_port())
    base = str(tmp_path / "out")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), port, str(n_local), base],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_clean_env(), cwd=REPO) for pid in (0, 1)]
    for rc, _o, e in _wait_all(procs):
        assert rc == 0, e[-3000:]
    got = [json.loads(Path(f"{base}.proc{p}.json").read_text())
           for p in (0, 1)]
    assert [g["is_output"] for g in got] == [True, False]
    assert got[0]["process_count"] == 2
    want = read_outs(["cpu"] * (2 * n_local), str(tmp_path / "one.tsv"))
    for g in got:
        assert g["n_shards"] == 2 * n_local
        for key in ("rows", "summary", "top", "decay", "hist", "n_tsv"):
            assert g[key] == want[key], key
    assert Path(f"{base}.tsv").read_bytes() \
        == (tmp_path / "one.tsv").read_bytes()
    assert want["n_tsv"] == len(want["rows"]) > 100


# ---------------------------------------------------------------------------
# The CLI in two processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_mp")
    entry = tmp / "entry.py"
    entry.write_text(_ENTRY.format(repo=str(REPO)))
    for name, amb in (("plain", False), ("amb", True)):
        write_fasta(tmp / f"{name}.fasta", ambiguous=amb)
    return tmp, entry


def _run_two(entry, argv, n_local=(1, 1), env_bring_up=False, fault=0):
    """The CLI once per process of a two-process group."""
    port = _free_port()
    procs = []
    for pid in (0, 1):
        extra = {"WLD_FAULT_AFTER_BATCHES": str(fault)} if fault else {}
        args = [*argv, "--devices", str(n_local[pid])]
        if env_bring_up:
            extra.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                         JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        else:
            args += ["--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", "2", "--process-id", str(pid)]
        procs.append(subprocess.Popen(
            [sys.executable, str(entry), *args], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_clean_env(**extra),
            cwd=REPO))
    return _wait_all(procs)


@pytest.fixture(scope="module")
def jax_cli(cli_env):
    """The JAX CLI's TSV and weights at --devices 2 and 4, per input."""
    tmp, _entry = cli_env
    script = tmp / "jax_cli.py"
    script.write_text(_JAX_CLI.format(repo=str(REPO)))
    runs = []
    for name in ("plain", "amb"):
        for g in (2, 4):
            out = tmp / f"jax_{name}_{g}"
            env = _clean_env(
                JAX_PLATFORMS="cpu",
                XLA_FLAGS=("--xla_cpu_max_isa=AVX "
                           f"--xla_force_host_platform_device_count={g}"))
            runs.append(subprocess.Popen(
                [sys.executable, str(script), "--file",
                 str(tmp / f"{name}.fasta"), *FLAGS[2:], "--devices", str(g),
                 "--pair-output", f"{out}.tsv", "--weights-output",
                 f"{out}.w.tsv"], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for rc, _o, e in _wait_all(runs):
        assert rc == 0, e[-3000:]
    return tmp


@pytest.mark.parametrize("n_local", (1, 2))
@pytest.mark.parametrize("name", ("plain", "amb"))
def test_cli_two_processes_equal_devices_g_and_jax(cli_env, jax_cli, name,
                                                   n_local):
    tmp, entry = cli_env
    g = 2 * n_local
    out = tmp / f"two_{name}_{g}"
    res = _run_two(entry, ["--file", str(tmp / f"{name}.fasta"), *FLAGS,
                           "--pair-output", f"{out}.tsv",
                           "--weights-output", f"{out}.w.tsv"],
                   n_local=(n_local, n_local))
    for rc, o, e in res:
        assert rc == 0 and o == "", e[-3000:]
    one = tmp / f"one_{name}_{g}"
    assert cli.main(["--file", str(tmp / f"{name}.fasta"), *FLAGS,
                     "--devices", str(g), "--pair-output", f"{one}.tsv",
                     "--weights-output", f"{one}.w.tsv"]) == 0
    tsv = Path(f"{out}.tsv").read_bytes()
    assert len(tsv.splitlines()) > 100
    assert tsv == Path(f"{one}.tsv").read_bytes()
    assert tsv == (tmp / f"jax_{name}_{g}.tsv").read_bytes()
    weights = Path(f"{out}.w.tsv").read_bytes()
    assert weights == Path(f"{one}.w.tsv").read_bytes()
    assert weights == (tmp / f"jax_{name}_{g}.w.tsv").read_bytes()


def test_cli_jax_env_bring_up_equals_flags(cli_env):
    tmp, entry = cli_env
    fasta = str(tmp / "plain.fasta")
    outs = []
    for env_bring_up in (False, True):
        out = tmp / f"env_{env_bring_up}.tsv"
        for rc, _o, e in _run_two(entry, ["--file", fasta, *FLAGS,
                                          "--pair-output", str(out)],
                                  env_bring_up=env_bring_up):
            assert rc == 0, e[-3000:]
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 1000


def test_cli_two_process_stats_only_prints_once(cli_env):
    tmp, entry = cli_env
    argv = ["--file", str(tmp / "amb.fasta"), *FLAGS, "--stats-only"]
    res = _run_two(entry, argv)
    lines = [ln for rc, o, e in res for ln in o.splitlines()]
    assert all(rc == 0 for rc, _o, _e in res)
    assert len(lines) == 1
    got = json.loads(lines[0])
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([*argv, "--devices", "2"]) == 0
    want = json.loads(buf.getvalue())
    for key in ("n_sequences", "n_sites", "n_pairs", "n_over_threshold"):
        assert got[key] == want[key], key
    for key in ("r2_sum_over_threshold", "r2_max"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_cli_two_process_checkpoint_kill_resume(cli_env, suffix):
    tmp, entry = cli_env
    fasta = str(tmp / "amb.fasta")
    out = tmp / f"ckpt.tsv{suffix}"
    ckpt = Path(f"{out}.ckpt.json")
    argv = ["--file", fasta, *FLAGS, "--checkpoint", "--pair-output",
            str(out)]
    for rc, _o, _e in _run_two(entry, argv, fault=2):
        assert rc == 17
    state = json.loads(ckpt.read_text())
    assert state["next_batch"] == 2
    torn = out.read_bytes()
    res = _run_two(entry, [*argv, "-v"])
    assert all(rc == 0 for rc, _o, _e in res)
    assert "resuming at batch 2" in res[0][2]
    assert "resuming at batch" not in res[1][2]     # only process 0 reads it
    assert not ckpt.exists()
    assert out.read_bytes()[:state["byte_offset"]] \
        == torn[:state["byte_offset"]]
    clean = tmp / f"clean.tsv{suffix}"
    for rc, _o, e in _run_two(entry, ["--file", fasta, *FLAGS,
                                      "--checkpoint", "--pair-output",
                                      str(clean)]):
        assert rc == 0, e[-3000:]
    assert out.read_bytes() == clean.read_bytes()


def test_cli_unequal_local_shards_are_refused(cli_env):
    tmp, entry = cli_env
    res = _run_two(entry, ["--file", str(tmp / "plain.fasta"), *FLAGS,
                           "--pair-output", str(tmp / "unequal.tsv")],
                   n_local=(1, 2))
    for rc, _o, e in res:
        assert rc == 2
        assert _first_line(e) == (
            "error: every process must drive the same number of local "
            "shards; process 0 has 1, process 1 has 2")
    assert not (tmp / "unequal.tsv").exists()


@pytest.mark.parametrize("argv", [
    ["--coordinator", "127.0.0.1", "--num-processes", "2",
     "--process-id", "0"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
     "--process-id", "2"],
    ["--coordinator", "127.0.0.1:1", "--process-id", "0"],
])
def test_cli_bad_bring_up_exits_2_with_jax_first_line(argv, capsys):
    assert cli.main(["--file", "x.fasta", "--device", "cpu", *argv]) == 2
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("error: distributed bring-up failed: ")
    assert multihost.process_count() == 1


# ---------------------------------------------------------------------------
# Bring-up rules
# ---------------------------------------------------------------------------


def test_multiprocess_env_rules(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "SLURM_NTASKS",
                "SLURM_PROCID", "SLURM_STEP_NUM_TASKS",
                "SLURM_STEP_NODELIST", "SLURM_JOB_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not multihost._multiprocess_env()
    multihost.initialize_distributed()      # nothing indicated: local
    assert multihost.process_count() == 1 and multihost.is_output_process()
    # An sbatch batch step (no srun) stays local.
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_PROCID", "3")
    assert not multihost._multiprocess_env()
    # An srun step of several tasks: the group, its coordinator on the
    # step's first node.
    monkeypatch.setenv("SLURM_STEP_NUM_TASKS", "8")
    monkeypatch.setenv("SLURM_STEP_NODELIST", "gpu[07-09,12],login1")
    monkeypatch.setenv("SLURM_JOB_ID", "4100")
    assert multihost._multiprocess_env()
    assert multihost._from_env() == ("gpu07:" + str(4100 % 4096 + 61440),
                                     8, 3)
    monkeypatch.delenv("SLURM_STEP_NODELIST")
    with pytest.raises(RuntimeError, match="coordinator address"):
        multihost._from_env()
    monkeypatch.delenv("SLURM_STEP_NUM_TASKS")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "h:1234")
    assert multihost._multiprocess_env()
    with pytest.raises(RuntimeError, match="process count"):
        multihost.initialize_distributed()


def test_rendezvous_timeout_raises():
    """A peer whose coordinator never answers fails within its timeout; it
    never runs on as a lone process 0."""
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from weightedld_tpu_torch.parallel import multihost\n"
            "try:\n"
            "    multihost.initialize_distributed(sys.argv[2], 2, 1, "
            "timeout_s=3)\n"
            "except RuntimeError as e:\n"
            "    print('raised', e)\n"
            "    sys.exit(3)\n")
    res = subprocess.run(
        [sys.executable, "-c", code, str(REPO), f"127.0.0.1:{_free_port()}"],
        capture_output=True, text=True, timeout=120, env=_clean_env())
    assert res.returncode == 3, res.stderr[-2000:]
    assert res.stdout.startswith("raised rendezvous at 127.0.0.1:")


def test_local_devices():
    assert multihost.local_devices("cpu") == [torch.device("cpu")]
    assert len(multihost.local_devices("cpu", 3)) == 3
    with pytest.raises(ValueError, match="positive"):
        multihost.local_devices("cpu", 0)
    assert multihost.global_shard_count(3) == 3
