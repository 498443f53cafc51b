"""Each cell of BENCHMARK.json runs through the harness at a tiny size on
the CPU and gives a result line of the contract's shape."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny

SPEC = harness.load_json(os.path.join(tiny.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]


def _check_line(result: dict, trace: bool, cell: str):
    line = json.loads(json.dumps(result))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    wanted = harness.for_cell(SPEC["per_layer" if trace
                                   else "end_to_end"], cell)
    units = {m["name"]: m["unit"] for m in wanted}
    for name, metric in line["metrics"].items():
        assert metric["unit"] == units[name]
        assert isinstance(metric["value"], float)
    for name, check in line["checks"].items():
        assert check["value"] <= check["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # a CPU run has no device metric; the host's are there
        assert {"train_frames_per_s", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_gives_a_result_line(cell, trace):
    _check_line(tiny.run(cell, trace=trace), trace, cell)


def test_same_seed_same_run():
    a = tiny.run(CELLS[0], seed=5)
    b = tiny.run(CELLS[0], seed=5)
    assert a["checks"] == b["checks"]


def test_no_card_no_result(tmp_path):
    """On a machine without a CUDA card the command exits non-zero and
    prints nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_missing_span_stops_the_run(monkeypatch):
    """A traced run stops, with no result, where the program no longer has
    a name that a span wraps: the metric it feeds would go quiet."""
    from benchmark.drivers import program

    common = program.common
    monkeypatch.setattr(program, "common", lambda trainer: common(trainer) + [
        (trainer, "renamed_step", "renamed_step", None)])
    with pytest.raises(RuntimeError, match="renamed_step"):
        tiny.run(CELLS[0], trace=True)
