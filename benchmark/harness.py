"""Runs one cell once: set-up, the measured window, the traced window's
reading, the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, program entry or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the path in the entry's ``file``), whose
  ``entry`` names the driver ``drivers/<entry>.py``;
- ``workloads/<traffic>.json``, the traffic mix;
- ``metrics/<metric>.py``, a reader with ``read(run) -> float | None``;
- ``reference/limits/<config>.json``, the comparison's limits.

A reader that finds nothing to read returns None and the metric is left
out of the line; on a card, a metric that ``BENCHMARK.json`` lists for the
cell and that reads nothing stops the run without a result, as does a
span whose name the program no longer has, so that no metric goes quiet
unseen. With ``--trace 0`` the line carries the cell's end-to-end metrics,
read from the measured window. With ``--trace 1`` it carries the cell's
per-layer metrics: the run measures the same window first, untraced (the
whole step's share of the peak is read there), then a traced window of at
most ``TRACED_S`` seconds under ``torch.profiler``, whose profile the
other per-layer metrics read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from benchmark import checks
from benchmark.spans import Spans

PACKAGE = os.path.dirname(os.path.abspath(__file__))
TRACED_S = 15.0     # a traced window's seconds at most


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: str, tag: str):
    """A module loaded from ``path`` (names may hold dots and dashes)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark._{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def config_name(self) -> str:
        return self.workload["config"]


def for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(root: str, name: str) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    workload = next((w for w in spec["workloads"] if w["name"] == name),
                    None)
    if workload is None:
        raise KeyError(f"no workload {name} in BENCHMARK.json")
    config = next(c for c in spec["configs"]
                  if c["name"] == workload["config"])
    return Cell(name, workload,
                load_json(os.path.join(root, config["file"])),
                load_json(os.path.join(PACKAGE, "workloads",
                                       f"{workload['traffic']}.json")),
                for_cell(spec["end_to_end"], name),
                for_cell(spec["per_layer"], name))


@dataclass
class Window:
    """A window's seconds, the real frames of each of its micro-steps, and
    its micro-steps and updates."""

    seconds: float
    frames: List[int]
    micro_steps: int
    updates: int


@dataclass
class Run:
    """What a metric's reader reads: the measured (untraced) window and, in
    a traced run, the traced window with its profile and spans."""

    cell: Cell
    device: torch.device
    setup_s: float
    window: Window
    peak_bytes: int
    traced: Optional[Window] = None
    trace: object = None
    calls: Dict[str, list] = field(default_factory=dict)
    host_s: Dict[str, float] = field(default_factory=dict)


def card() -> str:
    """``<name>, <power limit>`` from nvidia-smi, or the name alone."""
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or name
    except (OSError, subprocess.TimeoutExpired):
        return name


def _window(driver, seconds: float, name: str):
    """Step back to back for ``seconds``, then to an update boundary; the
    window closes on one loss read and a sync. Returns the ``Window`` and
    its start on the host clock. Prints, on standard error, the frames a
    second issued in each quarter of the window (host clock, no sync: a
    drift inside the window shows there)."""
    first, done = len(driver.frames), driver.micro_steps
    t0 = time.perf_counter()
    issued = []
    while True:
        frames = driver.step()
        now = time.perf_counter()
        issued.append((now - t0, frames))
        if now - t0 >= seconds and driver.may_close():
            break
    driver.close()
    t1 = time.perf_counter()
    quarters = [0] * 4
    for at, frames in issued:
        quarters[min(3, int(4 * at / (t1 - t0)))] += frames
    print(f"[window] {name}: frames/s issued by quarter: " + " ".join(
        f"{4 * q / (t1 - t0):.0f}" for q in quarters), file=sys.stderr)
    steps = driver.micro_steps - done
    return Window(t1 - t0, list(driver.frames[first:]), steps,
                  steps // driver.accum), t0


def _profiler_cost(measured: Window, traced: Window, busy_s: float) -> None:
    """Prints, on standard error, what the profiler costs the host: both
    windows' rates, and the idle share that the measured window would
    read at the traced window's device time a micro-step."""
    if not (traced.micro_steps and measured.seconds and traced.seconds):
        return
    busy = busy_s / traced.micro_steps
    idle = 100.0 * (1.0 - busy * measured.micro_steps / measured.seconds)
    print(f"[window] measured {sum(measured.frames) / measured.seconds:.0f}"
          f" frames/s, traced {sum(traced.frames) / traced.seconds:.0f}; "
          f"device {1e3 * busy:.2f} ms a micro-step; idle share of the "
          f"measured window at that device time {idle:.2f}%",
          file=sys.stderr)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str, started: float, cell: Optional[Cell] = None,
             fault: Optional[str] = None) -> dict:
    """One run of cell ``name``; returns the result line's fields and, under
    ``checks``, each compared number with its limit."""
    cell = cell or load_cell(root, name)
    dev = torch.device(device)
    driver = load_file(os.path.join(PACKAGE, "drivers",
                                    f"{cell.config['entry']}.py"),
                       f"driver_{cell.config['entry']}").Driver(
        cell.config, cell.traffic, seed, dev, fault=fault)
    limits = checks.load_limits(PACKAGE, cell.config_name)
    readers = {m["name"]: load_file(os.path.join(PACKAGE, "metrics",
                                                 f"{m['name']}.py"),
                                    f"metric_{m['name']}")
               for m in (cell.per_layer if trace else cell.end_to_end)}
    if dev.type == "cuda":
        kind = card()
        print(f"[bench] {cell.name} seed {seed} on {kind}", file=sys.stderr)
    driver.setup()
    gc.collect()
    gc.freeze()     # the set-up's objects leave the collector's scans
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    measured, t0 = _window(driver, seconds, "measured")
    setup_s = t0 - started
    traced = prof = spans = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        spans = Spans()
        for owner, attr, span, info in driver.span_targets():
            if not spans.wrap(owner, attr, span, info):
                raise RuntimeError(
                    f"span {span}: the program has no "
                    f"{getattr(owner, '__name__', type(owner).__name__)}"
                    f".{attr} to wrap")
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.__enter__()
        traced, _ = _window(driver, min(seconds, TRACED_S), "traced")
        prof.__exit__(None, None, None)
        spans.unwrap()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run = Run(cell, dev, setup_s, measured, peak, traced)
    if prof is not None:
        from benchmark.trace import Trace

        run.trace = Trace(prof, traced.seconds)
        run.calls, run.host_s = dict(spans.calls), dict(spans.host_s)
        _profiler_cost(measured, traced, run.trace.busy_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif dev.type == "cuda":
            raise RuntimeError(f"metric {m['name']} read nothing in cell "
                               f"{cell.name}")
    device_line = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": driver.micro_steps,
              "failed": 0, "metrics": metrics, "device": device_line}
    if run.trace is not None:
        device_line["busy_s"] = run.trace.busy_s
        device_line["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": run.trace.top_ops(),
            "idle_gaps": run.trace.idle_gaps(
                run.trace.thread_of("train_step_ids"))}
    del prof, run
    driver.release()
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    values = checks.numbers(driver.readings, driver.reference(),
                           driver.accum)
    judged = checks.judge(values, limits)
    result["readings"] = {k: v for k, v in values.items()
                          if k not in limits}
    result["correct"] = all(ok for _, _, _, ok in judged)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in judged}
    return result
