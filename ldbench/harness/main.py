"""One run of one cell: set up, measure for ``--seconds``, check the
answers against the plain reference, print the result line.

    python3 ldbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number compared
with its limit, which also close standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import check, loops, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "weightedld_tpu", "bench", "bench_torch",
             "chip_smoke")


@dataclass
class RunView:
    """What a per-layer reader sees."""

    cell: spec.Cell
    window: loops.Window


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``weightedld_tpu_torch`` is not
    ``weightedld_tpu``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def _forbidden_found() -> bool:
    found = forbidden_modules()
    if found:
        print(f"error: modules of the JAX package or the old harness are "
              f"loaded: {found}", file=sys.stderr)
    return bool(found)


def parse(argv):
    ap = argparse.ArgumentParser(description="ldbench: one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--root", default=".",
                    help="directory holding BENCHMARK.json (default: the "
                    "current directory)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the kernels' plain versions, for tests; no "
                    "device metric is meaningful then")
    return ap.parse_args(argv)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e308


def _one(values: list, what: str):
    """The one value the mix's queries give for ``what`` (None if none)."""
    vals = {tuple(v) if isinstance(v, list) else v for v in values}
    if len(vals) > 1:
        raise ValueError(f"the mix asks for several {what}: {sorted(vals)}")
    return vals.pop() if vals else None


def reference_spec(mix: dict):
    """What the reference collects for the mix: the record thresholds of
    its jobs or queries, and the histogram and LD-decay edges its queries
    ask for."""
    from ..reference import ld_ref

    if mix["loop"] == "cli":
        return ld_ref.Spec(thresholds=(mix["threshold"],))
    cycle = mix["cycle"]
    thr = {mix["session_threshold"]} | {
        q["r2_threshold"] for q in cycle if "r2_threshold" in q}
    hist = _one([q["edges"] for q in cycle if q["kind"] == "r2_histogram"],
                "histogram edges") or ()
    decay = _one([q["edges"] for q in cycle if q["kind"] == "ld_decay"],
                 "decay edges") or ()
    # The program bins r2 against float32 edges.
    return ld_ref.Spec(thresholds=tuple(sorted(thr)),
                       hist_edges=tuple(float(np.float32(e)) for e in hist),
                       decay_edges=tuple(int(e) for e in decay))


def reference_for(cell: spec.Cell, data: dict, device: str):
    """The reference's inputs for the cell's data: the kept sites' codes,
    their Henikoff weights and positions, and the minor fraction per
    site."""
    import torch

    from ..reference import ld_ref

    cfg = cell.config
    codes = torch.from_numpy(data["codes"]).to(device)
    pos = data["positions"]
    if cfg.get("mask"):
        _hk, ld = ld_ref.site_masks(codes, cfg["min_acgt"],
                                    cfg["min_variability"])
        codes = codes[:, ld]
        pos = pos[ld.cpu().numpy()]
    return codes, ld_ref.henikoff(codes), pos, ld_ref.minor_fraction(codes)


def ref_block(device: str) -> int:
    """The reference's block of sites: 4,096 on the card (a few GB of
    float64 temporaries), 1,024 on the CPU (the tests)."""
    return 4096 if device == "cuda" else 1024


def parse_tsv(body: bytes) -> dict:
    lines = body.decode().splitlines()[1:]
    if not lines:
        return {k: np.zeros(0) for k in ("pos_a", "pos_b", "d", "dp", "r2")}
    arr = np.array([ln.split("\t") for ln in lines])
    return {"pos_a": arr[:, 0].astype(np.int64),
            "pos_b": arr[:, 1].astype(np.int64),
            "d": arr[:, 2].astype(np.float64),
            "dp": arr[:, 3].astype(np.float64),
            "r2": arr[:, 4].astype(np.float64)}


def judge(cell: spec.Cell, judge_: check.Judge, answers: list) -> dict:
    mix = cell.traffic
    for q, res in answers:
        if q == "tsv":
            judge_.records(parse_tsv(res), mix["threshold"],
                           mix["decimals"])
            continue
        kind = q["kind"]
        thr = q.get("r2_threshold", mix.get("session_threshold"))
        if kind == "stream":
            judge_.records(res, thr)
        elif kind == "summarize":
            judge_.summarize(res, thr)
        elif kind == "r2_histogram":
            judge_.histogram(res)
        elif kind == "ld_decay":
            judge_.decay(res)
        elif kind == "top_pairs":
            judge_.top_pairs(res, q["k"])
        elif kind == "prune":
            judge_.prune(res, thr)
        else:
            raise ValueError(f"no comparison for query kind {kind!r}")
    return judge_.out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    args = parse(argv)
    root = Path(args.root).resolve()
    try:
        cell = spec.load_cell(root, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell.workload["chips"])
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import weightedld_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        print(f"error: the program is not importable: {e}", file=sys.stderr)
        return 4
    device = args.device
    if device == "cuda":
        torch.cuda.init()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = spec.load_module(spec.find(root, "generators",
                                     cell.config["generator"], ".py"))
    mix = cell.traffic
    tmpdir = tempfile.mkdtemp(prefix="ldbench-")
    try:
        return _run(args, cell, gen, mix, device, tmpdir, t_start)
    finally:
        for p in Path(tmpdir).glob("*"):
            p.unlink()
        os.rmdir(tmpdir)


def _run(args, cell, gen, mix, device, tmpdir, t_start) -> int:
    import torch

    data = gen.generate(cell.config, args.seed, device)
    traced = bool(args.trace)
    if mix["loop"] == "cli":
        win = loops.run_cli(mix, data, tmpdir, device, args.seconds, traced)
        state = None
    elif mix["loop"] == "session":
        roofline = spec.load_module(spec.find(cell.root, "metrics",
                                              "roofline", ".py"))
        win, state = loops.run_session(
            cell.config, mix, data, tmpdir, device, args.seconds, traced,
            roofline.session_work)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    setup_s = win.t_first - t_start
    if _forbidden_found():
        return 5
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell.workload["chips"]),
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if traced and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
    # Free the program's state before the reference runs on the card.
    del state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    codes, w, pos, maf = reference_for(cell, data, device)
    from ..reference import ld_ref

    acc = ld_ref.scan(codes, w, pos, reference_spec(cell.traffic), device,
                      block=ref_block(device))
    del codes
    n = len(win.jobs) + len(win.queries)     # one of the two is empty
    print(f"run: setup {setup_s:.3f} s, window {win.window_s:.3f} s over "
          f"{n} jobs or queries, reference {time.monotonic() - t_ref:.3f} s, "
          f"{len(acc.records()['r2'])} reference records", file=sys.stderr)
    numbers = judge(cell, check.Judge(acc, pos, maf), win.answers)
    numbers["failed"] = float(win.failed)
    ok, checks = check.verdict(numbers, cell.limits)
    if not win.answers:
        ok = False

    metrics = {}
    if traced:
        view = RunView(cell=cell, window=win)
        for m in cell.metrics("per_layer"):
            reader = spec.load_module(spec.find(cell.root, "metrics",
                                                m["name"], ".py"))
            val = reader.read(view)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        per = win.window_s / max(n, 1)
        values = {"setup_s": setup_s, "job_s": per, "query_s": per}
        if win.queries:
            lat = sorted(q["seconds"] for q in win.queries)
            values["query_p90_s"] = lat[math.ceil(0.9 * len(lat)) - 1]
        for m in cell.metrics("end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": n,
              "failed": int(win.failed), "metrics": metrics, "device": dev}
    if traced and win.trace is not None:
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    # Again after the reference and the readers were loaded: nothing that
    # ran in this process, before the result is printed, loaded them.
    if _forbidden_found():
        return 5
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
