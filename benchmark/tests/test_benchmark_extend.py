"""A cell, a configuration and a per-layer metric are added by new files
and new entries in BENCHMARK.json alone: the harness finds them by name."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

from benchmark.tests import tiny

RUNNER = textwrap.dedent("""
    import json, sys
    from benchmark.tests import tiny
    print(json.dumps(tiny.run(sys.argv[1], trace=sys.argv[2] == "1")))
""")


def test_new_files_add_a_cell_a_config_and_a_metric(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    bench = root / "benchmark"
    # a configuration: the transduction one at another dropout rate
    cfg = json.loads((bench / "configs" /
                      "gaddy21-transduction.json").read_text())
    cfg.update(name="gaddy21-transduction-nodrop", dropout=0.0)
    (bench / "configs" / "gaddy21-transduction-nodrop.json").write_text(
        json.dumps(cfg))
    shutil.copy(bench / "reference" / "limits" / "gaddy21-transduction.json",
                bench / "reference" / "limits" /
                "gaddy21-transduction-nodrop.json")
    spec["configs"].append(dict(
        name=cfg["name"], source=cfg["source"], reduced=["dropout"],
        file="benchmark/configs/gaddy21-transduction-nodrop.json",
        why="no dropout"))
    # a traffic mix
    mix = json.loads((bench / "workloads" /
                      "corpus2000-silent30.json").read_text())
    mix["silent_share"] = 0.6
    (bench / "workloads" / "corpus2000-silent60.json").write_text(
        json.dumps(mix))
    spec["workloads"].append(dict(
        name="nodrop-silent60", config=cfg["name"],
        traffic="corpus2000-silent60", chips=1, why="more silent rows"))
    # a per-layer metric
    (bench / "metrics" / "micro_steps.window.py").write_text(
        "def read(run):\n    return float(run.traced.micro_steps)\n")
    spec["per_layer"].append(dict(
        name="micro_steps.window", unit="steps", better="higher",
        source="program_counter", layer="device",
        moves="train_frames_per_s", workloads=["nodrop-silent60"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), tiny.ROOT]))
    out = subprocess.run([sys.executable, "-c", RUNNER, "nodrop-silent60",
                          "1"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    traced = line["metrics"]["micro_steps.window"]["value"]
    assert 0 < traced < line["attempted"]
