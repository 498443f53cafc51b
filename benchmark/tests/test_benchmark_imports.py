"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the
program."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys
import textwrap

from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "silent_speech_tpu"}
PROGRAM = "silent_speech_tpu_torch"


def _loaded_after(code: str) -> set:
    probe = textwrap.dedent(code) + textwrap.dedent("""
        import json, sys
        print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", probe], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    loaded = _loaded_after("""
        from benchmark.tests import tiny
        tiny.run("transduction-train", trace=True)
        tiny.run("recognition-train")
    """)
    assert PROGRAM in loaded          # the names are compared whole
    assert not loaded & FORBIDDEN


def test_run_refuses_by_whole_top_level_name(monkeypatch):
    import types

    from benchmark import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    monkeypatch.setitem(sys.modules, "silent_speech_tpu_torch.probe",
                        types.ModuleType("probe"))
    assert "silent_speech_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "silent_speech_tpu.probe",
                        types.ModuleType("probe"))
    assert "silent_speech_tpu" in run.forbidden_modules()


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("""
        import benchmark.reference.train, benchmark.reference.losses
        import benchmark.reference.model, benchmark.reference.batch
        import benchmark.reference.draws
    """)
    assert not loaded & (FORBIDDEN | {PROGRAM})


def test_the_reference_sources_import_nothing_of_the_program():
    files = glob.glob(os.path.join(tiny.ROOT, "benchmark", "reference",
                                   "*.py"))
    assert files
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {PROGRAM}, \
                    (path, name)
