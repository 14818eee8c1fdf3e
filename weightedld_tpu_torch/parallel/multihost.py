"""Multi-process execution: the process group, the shard devices and who
writes the output.

Counterpart of ``weightedld_tpu/parallel/multihost.py:1-124`` on
``torch.distributed``.  The site-pair triangle is the only scale-out axis:
the inputs go to every shard device once, the striped tile plan is global
and deterministic, so every process computes its own disjoint shards
without coordination, and process 0 writes the output
(``parallel/sharded.py`` stitches the shards together).  A Slurm, MPI or
pod launcher runs the same command line in every process.

The process group is gloo, on the CPU.  Every collective of this package
moves host data: each batch's compacted records and its moments, the top-k
candidates, the decay and histogram partial sums, the resume state and the
shard-count check.  The port copies each of them to the host once per
batch anyway, so a gloo gather adds no device copy, and gloo can put two
ranks on one card, which NCCL refuses (the layout a one-card machine can
show).  Device-side NCCL gathers are later work, once a measurement calls
for them.

Bring-up reads the three explicit arguments (the CLI's ``--coordinator``,
``--num-processes`` and ``--process-id``), else the three environment
variables the JAX CLI honours (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so a launcher script works
with either package.  Of ``_multiprocess_env``'s rules (``:71-100``) the
port keeps those torch can act on: the coordinator variables, and a Slurm
step of several tasks (``SLURM_STEP_NUM_TASKS`` > 1 with ``SLURM_PROCID``,
the coordinator on the step's first node).  The TPU pod
(``TPU_WORKER_HOSTNAMES``) and Megascale (``MEGASCALE_COORDINATOR_ADDRESS``)
detections name TPU runtimes and have no meaning here.  A multi-process
environment that is indicated but fails to come up raises; it never
degrades to N independent "process 0"s all writing the same output
(``:63-66``).
"""

from __future__ import annotations

import logging
import os
import re
from datetime import timedelta

import torch

log = logging.getLogger("weightedld_tpu_torch")

# How long a collective waits for a peer before it fails: a rank that dies
# must not leave the others hanging.
DEFAULT_TIMEOUT_S = 600.0


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def _split_address(address: str) -> tuple[str, int]:
    host, sep, port = str(address).rpartition(":")
    if not sep or not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"coordinator address must be HOST:PORT, got "
                         f"{address!r}")
    return host.strip("[]"), int(port)


def _slurm_first_node(nodelist: str) -> str:
    """First host of a Slurm node list (``node[03-05,9],other`` ->
    ``node03``)."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if not m:
        raise ValueError(f"cannot read a host from SLURM_STEP_NODELIST="
                         f"{nodelist!r}")
    if m.group(2) is None:
        return m.group(1)
    return m.group(1) + m.group(2).split(",")[0].split("-")[0]


def _multiprocess_env() -> bool:
    """Does the environment indicate a multi-process job?  The coordinator
    variables always count; a Slurm step counts only when it has several
    tasks and this process a task id (``SLURM_STEP_NUM_TASKS``, not
    ``SLURM_NTASKS``: an ``sbatch --ntasks=N`` batch step that runs the
    program once without ``srun`` must not wait for N - 1 peers that were
    never launched)."""
    env = os.environ
    if any(v in env for v in ("JAX_COORDINATOR_ADDRESS",
                              "COORDINATOR_ADDRESS")):
        return True
    try:
        return (int(env.get("SLURM_STEP_NUM_TASKS", "1")) > 1
                and "SLURM_PROCID" in env)
    except ValueError:
        return False


def _from_env() -> tuple[str, int, int]:
    """``(coordinator, world size, rank)`` of an indicated multi-process
    environment, or a ``RuntimeError`` naming what is missing."""
    env = os.environ
    addr = env.get("JAX_COORDINATOR_ADDRESS", env.get("COORDINATOR_ADDRESS"))
    n, pid = env.get("JAX_NUM_PROCESSES"), env.get("JAX_PROCESS_ID")
    if "SLURM_PROCID" in env and int(env.get("SLURM_STEP_NUM_TASKS",
                                             "1")) > 1:
        n = n if n is not None else env["SLURM_STEP_NUM_TASKS"]
        pid = pid if pid is not None else env["SLURM_PROCID"]
        if addr is None and "SLURM_STEP_NODELIST" in env:
            # The JAX Slurm cluster's rule: the step's first node, a port
            # derived from the job id.
            port = int(env.get("SLURM_JOB_ID", "0")) % 4096 + 61440
            addr = f"{_slurm_first_node(env['SLURM_STEP_NODELIST'])}:{port}"
    missing = [name for name, v in (("a coordinator address", addr),
                                    ("the process count", n),
                                    ("the process id", pid)) if v is None]
    if missing:
        raise RuntimeError(
            "a multi-process environment is indicated but "
            f"{' and '.join(missing)} could not be read from it; pass "
            "--coordinator/--num-processes/--process-id")
    return addr, int(n), int(pid)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the gloo process group (a no-op for single-process runs
    and when the group is already up).  Call before any device use.

    The arguments name the group explicitly; with none given, the three
    ``JAX_*`` variables do, and then an indicated Slurm step or coordinator
    variable.  ``ValueError`` for malformed arguments, ``RuntimeError`` for
    a rendezvous that fails or times out (``timeout_s``)."""
    dist = _dist()
    if dist is not None and dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if all(v in env for v in ("JAX_COORDINATOR_ADDRESS",
                                  "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")):
            coordinator_address = env["JAX_COORDINATOR_ADDRESS"]
            num_processes = int(env["JAX_NUM_PROCESSES"])
            process_id = int(env["JAX_PROCESS_ID"])
        elif _multiprocess_env():
            coordinator_address, num_processes, process_id = _from_env()
        else:
            log.debug("no multi-process environment detected; running "
                      "locally")
            return
    missing = [flag for flag, v in (("--coordinator", coordinator_address),
                                    ("--num-processes", num_processes),
                                    ("--process-id", process_id))
               if v is None]
    if missing:
        raise ValueError(f"manual bring-up needs --coordinator, "
                         f"--num-processes and --process-id together; "
                         f"missing {', '.join(missing)}")
    host, port = _split_address(coordinator_address)
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in 0.."
                         f"{num_processes - 1} (num_processes "
                         f"{num_processes})")
    if dist is None:
        raise RuntimeError("torch.distributed is not available in this "
                           "PyTorch build")
    try:
        dist.init_process_group(
            backend="gloo", init_method=f"tcp://{host}:{port}",
            world_size=num_processes, rank=process_id,
            timeout=timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError, OSError) as e:
        raise RuntimeError(f"rendezvous at {host}:{port} as process "
                           f"{process_id} of {num_processes} failed: "
                           f"{e}") from e
    log.info("distributed runtime up: process %d/%d (gloo)", process_id,
             num_processes)


def process_count() -> int:
    dist = _dist()
    if dist is None or not dist.is_initialized():
        return 1
    return dist.get_world_size()


def process_index() -> int:
    dist = _dist()
    if dist is None or not dist.is_initialized():
        return 0
    return dist.get_rank()


def is_output_process() -> bool:
    """Only process 0 writes records and prints; the others drive their
    shards.  True when no process group is up (every single-process run
    is its own output process)."""
    return process_index() == 0


def local_devices(device: str | torch.device | None = None,
                  n: int | None = None) -> list[torch.device]:
    """The shard devices of this process: on ``cuda`` the first ``n``
    visible cards (all by default; an ``n`` above the count gives the
    count, as ``jax.devices()[:n]`` does), or the one card a device index
    names; on ``cpu`` ``n`` CPU shards (1 by default), the counterpart of
    the JAX suite's virtual CPU devices."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if n is not None and n < 1:
        raise ValueError(f"--devices must be positive, got {n}")
    if dev.type == "cpu":
        return [dev] * (n or 1)
    if dev.index is not None:
        if (n or 1) != 1:
            raise ValueError(f"device {str(dev)!r} names one card; drop the "
                             "index to shard over several")
        return [dev]
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(min(n or count, count))]


def global_shard_count(n_local: int) -> int:
    """``G``, the shards of all processes: ``process_count() * n_local``.
    Every process must drive the same number of shards (the striped plan
    assumes it, as the JAX global mesh does); a mismatch raises
    ``ValueError`` on every rank, naming the counts."""
    n_proc = process_count()
    if n_proc == 1:
        return n_local
    from .sharded import allgather

    counts = allgather(int(n_local))
    odd = [p for p, c in enumerate(counts) if c != counts[0]]
    if odd:
        raise ValueError(
            "every process must drive the same number of local shards; "
            f"process 0 has {counts[0]}, process {odd[0]} has "
            f"{counts[odd[0]]}")
    return n_proc * n_local
