"""Run one cell of the benchmark once, on the CUDA card(s) of this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the per-run progress and, as its last
lines on standard error, each compared number beside its limit; the last
line of standard output is one JSON object: ``correct``, ``attempted``
(micro-steps in the windows), ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``. Exits non-zero,
printing no result, without a CUDA card, or where JAX or the JAX package
was loaded into the process.

Build and kernel caches stay inside the checkout, at fixed paths under
``build/``.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "silent_speech_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "nv"}


def forbidden_modules() -> list:
    """Top-level names, compared whole, of loaded modules that no run may
    load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    # one process, few threads: the host's own work is one Python thread
    # and autograd's, and the CPU ops of a step are too small to split
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {cell.name} needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", STARTED, cell=cell)
    found = forbidden_modules()
    if found:
        print(f"[bench] the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    for name, value in result.pop("readings").items():
        print(f"[reading] {name} {value!r}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"[check] {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
