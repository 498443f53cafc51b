"""The port's bench on the CPU at its tiny size: one JSON line with the
JAX bench's keys and metric name, every step on the device-corpus path."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from silent_speech_tpu_torch import bench

from torch_port_util import one_torch_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def test_bench_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "silent_speech_tpu_torch.bench", "--tiny",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "train_steps_per_sec_emg2mel"
    assert line["unit"] == "steps/s" and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench.REFERENCE_STEPS_PER_SEC, 2)


def test_every_bench_step_gathers_on_the_device():
    trainer, corpus, id_sets = bench.setup(tiny=True, device="cpu")
    assert [len(s) for s in id_sets] == [len(s) for s in
                                         bench.example_sets(tiny=True)]
    assert all(trainer._cache_fits(corpus, ids) for ids in id_sets)
    calls = []
    step = bench.ids_steps(trainer, corpus, id_sets)
    rates = bench.measure(lambda i: calls.append(i) or step(i),
                          trainer.device, warmup=1, trial_steps=2, trials=3)
    assert calls == list(range(7)) and len(rates) == 3
    assert np.all(np.asarray(rates) > 0)
    assert bench.result_line([1.0, 6.0, 3.0])["value"] == 3.0
