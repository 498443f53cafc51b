"""The port's ``utils/profiling.py``: ``trace`` writing its file on the
CPU. Also ROADMAP §3 fault 14: the JAX docstring names a
``--profile_steps`` flag that no JAX module defines, and nothing calls
``StepTimer`` or ``trace`` on either side (the port has no ``StepTimer``;
its ``span`` is tested in ``test_torch_tracing.py``)."""

import json
import pathlib
import re

import torch

from silent_speech_tpu.utils import profiling as jax_profiling
from silent_speech_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent


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
