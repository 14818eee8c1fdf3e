"""Readings that set a cell's limits: the program's numbers and the
control's, over many seeds in one process.

    python3 ldbench/control.py --workload <cell> --seeds 1,2,3 \
        --mode program|control|int8 [--seconds 5]

``program``: for each seed, the cell's own set-up, a short window at the
cell's load and the run's comparison, as a run makes it.  ``control``: for
each seed, the reference computed in bfloat16 (``ld_ref.scan(precision=
"bf16")``) put in the program's place, its answers to the cell's traffic
judged by the same comparison.  ``int8``: as ``program``, with the
program's own lossy int8 weight mode switched on.  One JSON line per seed;
the benchmark's own runs never run this.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from ldbench.harness import check, loops, main as run, spec  # noqa: E402
from ldbench.reference import ld_ref  # noqa: E402


def control_answers(cell, acc, pos, maf) -> list:
    """The answers the bfloat16 reference gives to the cell's traffic, in
    the program's forms: a 4-dp TSV for a CLI job, one answer to each
    query of the cycle for a session."""
    mix = cell.traffic
    rec = acc.records()
    recs = {"pos_a": pos[rec["i"]], "pos_b": pos[rec["j"]], "d": rec["d"],
            "dp": rec["dp"], "r2": rec["r2"]}

    def above(t):
        m = recs["r2"] > t
        return {k: v[m] for k, v in recs.items()}

    if mix["loop"] == "cli":
        r = above(mix["threshold"])
        rows = ["posa\tposb\tD\tD'\tR2"] + [
            "\t".join([str(int(a)), str(int(b))] + [
                repr(round(float(x), mix["decimals"])) for x in (d, dp, r2)])
            for a, b, d, dp, r2 in zip(r["pos_a"], r["pos_b"], r["d"],
                                       r["dp"], r["r2"])]
        return [("tsv", ("\n".join(rows) + "\n").encode())]
    out = []
    for q in mix["cycle"]:
        kind = q["kind"]
        t = q.get("r2_threshold", mix["session_threshold"])
        if kind == "stream":
            ans = above(t)
        elif kind == "summarize":
            n_s, _n_u, s_s, _s_u = acc.summ[t]
            ans = {"n_pairs": acc.kept_sure, "n_over_threshold": n_s,
                   "r2_sum_over_threshold": s_s, "r2_max": acc.r2_max_sure}
        elif kind == "r2_histogram":
            ans = {"n_pairs": list(acc.hist_sure)}
        elif kind == "ld_decay":
            d = acc.decay_sure
            ans = {"n_pairs": list(d[:, 0]), "r2_sum": list(d[:, 1]),
                   "abs_d_prime_sum": list(d[:, 2]),
                   "n_d_prime_finite": list(d[:, 3])}
        elif kind == "top_pairs":
            order = np.argsort(-recs["r2"], kind="stable")[:q["k"]]
            ans = {k: v[order] for k, v in recs.items()}
        elif kind == "prune":
            kept, _exact = ld_ref.prune(acc, maf, t)
            ans = pos[kept]
        else:
            raise ValueError(f"no control answer for {kind!r}")
        out.append((q, ans))
    return out


def lossy_mix(mix: dict) -> dict:
    """The cell's traffic with the program's lossy int8 weight mode on:
    ``--weight-quant int8`` on a job, ``DriverConfig(weight_quant="int8")``
    for a session."""
    if mix["loop"] == "cli":
        return {**mix, "argv": [*mix["argv"], "--weight-quant", "int8"]}
    return {**mix, "driver": {**mix.get("driver", {}),
                              "weight_quant": "int8"}}


def one_seed(cell, gen, seed: int, mode: str, device: str, seconds: float,
             tmpdir: str) -> dict:
    import torch

    data = gen.generate(cell.config, seed, device)
    t0 = time.monotonic()
    if mode in ("program", "int8"):
        mix = cell.traffic if mode == "program" else lossy_mix(cell.traffic)
        if mix["loop"] == "cli":
            win = loops.run_cli(mix, data, tmpdir, device, seconds, False)
        else:
            win, state = loops.run_session(cell.config, mix, data, tmpdir,
                                           device, seconds, False,
                                           lambda s, p: {})
            del state
        answers, n = win.answers, len(win.jobs) + len(win.queries)
        if device == "cuda":
            torch.cuda.empty_cache()
    codes, w, pos, maf = run.reference_for(cell, data, device)
    block = run.ref_block(device)
    rs = run.reference_spec(cell.traffic)
    acc = ld_ref.scan(codes, w, pos, rs, device, block=block)
    if mode == "control":
        ctrl = ld_ref.scan(codes, w, pos, rs, device, precision="bf16",
                           band=0.0, block=block)
        answers, n = control_answers(cell, ctrl, pos, maf), 1
    numbers = run.judge(cell, check.Judge(acc, pos, maf), answers)
    return {"seed": seed, "mode": mode, "answers": n,
            "records": len(acc.records()["r2"]),
            "seconds": time.monotonic() - t0, **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control", "int8"),
                    required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--root", default=".")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import tempfile

    root = Path(args.root).resolve()
    cell = spec.load_cell(root, args.workload)
    gen = spec.load_module(spec.find(root, "generators",
                                     cell.config["generator"], ".py"))
    with tempfile.TemporaryDirectory(prefix="ldbench-") as tmpdir:
        for seed in (int(s) for s in args.seeds.split(",")):
            row = one_seed(cell, gen, seed, args.mode, args.device,
                           args.seconds, tmpdir)
            print(json.dumps({k: run._finite(v) if isinstance(v, float)
                              else v for k, v in row.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
