"""The port's ``utils/profiling.py`` against the JAX package's:
``StepTimer``'s statistics and log lines on one patched clock, and
``trace`` writing its file on the CPU. Also ROADMAP §3 fault 14: the JAX
docstring names a ``--profile_steps`` flag that no JAX module defines, and
nothing calls ``StepTimer`` or ``trace`` on either side."""

import json
import logging
import pathlib
import re
import types

import pytest
import torch

from silent_speech_tpu.utils import profiling as jax_profiling
from silent_speech_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
CLOCKS = [
    [0.0, 0.1, 0.25, 0.3, 0.7, 0.71, 1.2, 1.25, 2.0, 2.05, 2.4],
    [10.0, 10.5],
    [5.0],
    [1.0 + 0.01 * i * i for i in range(60)],
]


def _run(module, ticks, log_every, monkeypatch, caplog):
    it = iter(ticks)
    # the module's clock alone: logging reads time.time() for its records
    monkeypatch.setattr(module, "time",
                        types.SimpleNamespace(time=lambda: next(it)))
    timer = module.StepTimer(log_every=log_every, name="step")
    caplog.clear()
    with caplog.at_level(logging.INFO):
        for _ in ticks:
            timer.tick()
    stats = (timer.steps_per_sec,
             [timer.percentile_ms(q) for q in (0, 10, 50, 90, 99, 100)],
             [r.getMessage() for r in caplog.records])
    timer.reset()
    return stats + (timer.steps_per_sec, timer.percentile_ms(50))


@pytest.mark.parametrize("log_every", [0, 3, 50])
@pytest.mark.parametrize("clock", range(len(CLOCKS)))
def test_step_timer_matches_jax(monkeypatch, caplog, clock, log_every):
    ticks = CLOCKS[clock]
    ours = _run(profiling, ticks, log_every, monkeypatch, caplog)
    ref = _run(jax_profiling, ticks, log_every, monkeypatch, caplog)
    assert ours == ref
    if log_every == 3 and len(ticks) > 3:
        assert ours[2] and ours[2][0].startswith("step: ")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "tb")):
        x = torch.ones(64, 64)
        (x @ x).sum()
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)


def _py_files(*roots):
    for r in roots:
        p = ROOT / r
        yield from (sorted(p.rglob("*.py")) if p.is_dir() else [p])


def test_fault_14_no_jax_module_defines_profile_steps():
    doc = jax_profiling.__doc__
    assert "``--profile_steps`` is set" in doc   # the claim
    jax_side = ["silent_speech_tpu"] + [p.name for p in ROOT.glob("*.py")
                                        if p.name != "chip_smoke.py"]
    hits = [str(p.relative_to(ROOT)) for p in _py_files(*jax_side)
            if "profile_steps" in p.read_text()]
    assert hits == ["silent_speech_tpu/utils/profiling.py"]
    # ... and there only in the docstring: no flag, no caller
    src = (ROOT / "silent_speech_tpu/utils/profiling.py").read_text()
    assert src.count("profile_steps") == doc.count("profile_steps") == 1
    for side in ("silent_speech_tpu", "silent_speech_tpu_torch"):
        callers = [str(p.relative_to(ROOT)) for p in _py_files(side)
                   if re.search(r"StepTimer\(|profiling\.trace|"
                                r"import.*\btrace\b", p.read_text())
                   and not p.name == "profiling.py"]
        assert callers == [], side
    # the port adds no such flag: only its docstring names it
    port = [str(p.relative_to(ROOT))
            for p in _py_files("silent_speech_tpu_torch", "chip_smoke.py")
            if "profile_steps" in p.read_text()]
    assert port == ["silent_speech_tpu_torch/utils/profiling.py"]
    assert profiling.__doc__.count("profile_steps") == 1
