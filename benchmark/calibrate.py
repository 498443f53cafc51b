"""The readings that the comparison's limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--out file.json]

For each of ``--seeds``, the program's sound run (set-up and the compared
micro-steps, exactly as a benchmark run makes them) against the float32
reference: the lower readings. For each of ``--control-seeds``, the
control, the reference computed in float8 (``reference.model.Precision``),
against the float32 reference; for each of ``--fault-seeds``, the program
with half of each batch left out (its loss the mean over the rest)
against the reference: the upper readings. A state left unchanged reads 1
on ``change_gap`` by its definition and is not run. ``--set key=value``
changes the configuration for a witness run. Each reading is one JSON
line on standard output, with ``correct``: its numbers judged by
``checks.judge`` against the configuration's limits, as a run judges
them; ``--out`` collects them all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark import checks, harness


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=JSON",
                    help="change a key of the configuration (a witness run, "
                         "such as the program in float32)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = os.path.dirname(harness.PACKAGE)
    cell = harness.load_cell(root, args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        cell.config[key] = json.loads(value)
    entry = cell.config["entry"]
    module = harness.load_file(
        os.path.join(harness.PACKAGE, "drivers", f"{entry}.py"),
        f"driver_{entry}")
    limits = checks.load_limits(harness.PACKAGE, cell.config_name)
    lines = []

    def top_leaves(program, ref, values):
        """The five leaves with the widest gradient gaps, for the look at
        what sets ``grad_gap``."""
        gaps = checks.leaf_gaps(program.grad_norms, ref.grad_norms,
                                 sorted(ref.grad_norms))
        worst = sorted(gaps, key=gaps.get, reverse=True)[:5]
        values["grad_top"] = [[n, gaps[n], ref.grad_norms[n],
                               program.grad_norms[n]] for n in worst]

    def emit(kind, seed, values, t0):
        judged = checks.judge(values, limits)
        values["correct"] = all(ok for *_, ok in judged)
        values["failed_numbers"] = [n for n, _, _, ok in judged if not ok]
        line = dict(kind=kind, workload=cell.name, seed=seed,
                    seconds=time.perf_counter() - t0, **values)
        lines.append(line)
        print(json.dumps(line), flush=True)

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    plan = [("sound", s) for s in args.seeds] \
        + [("control_fp8", s) for s in args.control_seeds] \
        + [("fault_half_batch", s) for s in args.fault_seeds]
    for kind, seed in plan:
        t0 = time.perf_counter()
        if kind == "control_fp8":
            d = module.Driver(cell.config, cell.traffic, seed, "cuda")
            d.plan_compared()
            control, ref = d.reference("fp8"), d.reference()
            values = checks.numbers(control, ref, d.accum)
            values.update(losses=control.losses, reference_losses=ref.losses)
            top_leaves(control, ref, values)
        else:
            fault = "half_batch" if kind == "fault_half_batch" else None
            d = module.Driver(cell.config, cell.traffic, seed, "cuda",
                              fault=fault)
            d.setup()
            program = d.readings
            d.release()
            fresh()
            ref = d.reference()
            values = checks.numbers(program, ref, d.accum)
            values.update(losses=program.losses,
                          reference_losses=ref.losses)
            top_leaves(program, ref, values)
        emit(kind, seed, values, t0)
        del d
        fresh()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
