"""``bench_torch.py --pod`` and its refusals on the CPU (``--device cpu``,
the kernels' plain versions, tiny sizes): ``tests/test_bench.py``'s three
``--pod`` smoke runs against ``bench.py`` (two shards sharing one device,
``--pod all`` exiting 2, ``--pod 2 --processes 2`` on a gloo group), and
the script exiting 2 with a message without a card and without
``--device cpu``.  Split from ``test_torch_bench.py`` so that no test
worker carries both files' subprocesses.
"""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_bench import CPU_DEVICE, _run


def test_bench_torch_pod_shared_device_smoke():
    rc, out, payload = _run(["--pod", "2", "--device", "cpu"], 300,
                            WLD_POD_BENCH_N="24", WLD_POD_BENCH_S="512")
    assert rc == 0, out[-3000:]
    assert payload["metric"] == "pod_scaling_pairs_per_s"
    assert payload["n_devices"] == 2 and payload["virtual_mesh"] is True
    assert payload["efficiency_basis"].startswith("plan_balance")
    assert payload["device"] == CPU_DEVICE
    rows = payload["rows"]
    assert [r["shards"] for r in rows] == [1, 2]
    for r in rows:
        assert r["pairs_per_s"] > 0
        assert 0.9 <= r["balance_efficiency"] <= 1.0
        assert r["efficiency"] == round(r["balance_efficiency"], 4)
        assert r["pairs_spread_pct"] < 10.0


@pytest.mark.parametrize("args", (["--pod", "all"],
                                  ["--pod", "2", "--processes", "x"]))
def test_bench_torch_pod_rejects_non_numeric_argument(args):
    rc, out, _payload = _run(args, 120)
    assert rc == 2
    assert "expected a count" in out


def test_bench_torch_pod_processes_smoke():
    """--processes brings up a real two-process gloo group (the JAX_*
    variables) and reports the measured 1-vs-2-process ratio over the same
    total shard count."""
    rc, out, payload = _run(
        ["--pod", "2", "--processes", "2", "--device", "cpu"], 300,
        WLD_POD_BENCH_N="24", WLD_POD_BENCH_S="512", WLD_POD_BENCH_REPS="1")
    assert rc == 0, out[-3000:]
    assert payload["metric"] == "pod_process_scaling_pairs_per_s"
    rows = payload["rows"]
    assert [r["processes"] for r in rows] == [1, 2]
    assert rows[0]["n_devices"] == rows[1]["n_devices"] == 2
    assert rows[0]["n_processes"] == 1 and rows[1]["n_processes"] == 2
    assert payload["process_efficiency"] > 0
    assert "measured wall-clock" in payload["efficiency_basis"]
    assert "not scale-out" in payload["efficiency_basis"]


def test_bench_torch_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for args in ([], ["--heavy"], ["--pod", "2"]):
        rc, out, payload = _run(args, 120)
        assert rc == 2 and payload is None, args
        assert "torch.cuda.is_available() is False" in out, args
