"""The filter-chain kernel against another version of ``csrc/filtfilt.cu``
on the card.

    python -m silent_speech_tpu_torch.ops.filtfilt_study \\
        --against old_filtfilt.cu [--sass DIR]

``--against`` names a filter-chain source with the same C entry
(``filtfilt_chain``), for example an earlier commit's, written out with
``git show <commit>:silent_speech_tpu_torch/csrc/filtfilt.cu >
old_filtfilt.cu``. Both are built with the port's nvcc flags into
``build/filtfilt_study/``. Two shapes:

- **S-phase7**: the inputs of ``chip_smoke.py``'s phase 7 corpus build,
  which it saves to ``build/filtfilt_corpus_inputs.pt`` (``--inputs``):
  B=9, T_pad=7936, C=8 in its runs;
- **S-corpus**: a synthetic group as ``data/device_featurize._groups``
  forms one at the 256 MiB group size (``corpus_group``): B=512,
  T_pad=16,384, C=8, lengths uniform in 6,000..16,384 from ``--seed``, σ =
  100 noise, the cleaning chain ``filter_coeffs(1000.0, 60.0)``.

At each shape the port's kernel must give the other's output and the
plain version's (``torch.equal``; at S-corpus on the shortest and the
longest utterance, sliced out, since a column never reads another) and
the same output twice; then each library's C entry is timed alone (CUDA
events, the scratch allocated once) in turns, other, port, port, other,
and reported as ms a launch and ns a step of the longest column's chain
(16 passes of L + 2p steps for the cleaning chain).

``--sass DIR`` writes ``cuobjdump -sass`` of both sources.

Needs a CUDA card and nvcc. Prints one line per result and writes them as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import build
from .filtfilt import _library, _table, chain_padlen, filtfilt_chain, \
    filtfilt_chain_plain

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "filtfilt_study"
INPUTS = ROOT / "build" / "filtfilt_corpus_inputs.pt"
# S-corpus: 512 utterances of up to 16,384 samples (previous, current and
# next utterance at 1000 Hz) in one 256 MiB group
CORPUS_B, CORPUS_T, CORPUS_C = 512, 16384, 8
CORPUS_MIN_LEN = 6000


def _nvcc(src: Path, out: Path, cubin=False):
    flags = [f for f in build.NVCC_FLAGS
             if not cubin or f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [build._nvcc(), *flags, *(["-cubin"] if cubin else []), "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return out


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.filtfilt_chain.argtypes = [ptr] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        i32, i32, i32, i32, ptr]
    lib.filtfilt_chain.restype = i32
    return lib


def corpus_group(seed: int, device="cuda"):
    """S-corpus's inputs: (B, T_pad, C) float32 of σ = 100 on ``device``,
    zero past each length; the (B,) lengths (int64, on the host), uniform
    in CORPUS_MIN_LEN..T_pad from ``seed``; the cleaning chain at 1000 Hz."""
    from ..dsp.device_pipeline import filter_coeffs

    rng = np.random.default_rng(seed)
    lengths = torch.from_numpy(rng.integers(
        CORPUS_MIN_LEN, CORPUS_T + 1, size=CORPUS_B))
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((CORPUS_B, CORPUS_T, CORPUS_C), generator=gen,
                    device=device) * 100
    t = torch.arange(CORPUS_T, device=device)
    x *= (t[None, :] < lengths.to(device)[:, None])[..., None]
    return x, lengths, filter_coeffs(1000.0, 60.0)


def chain_steps(lengths, coeffs) -> int:
    """The dependent steps of the longest column: each filter's two passes
    of L + 2p steps (the reverse pass's last p are cropped, and the
    redesigned kernel skips them: this keeps the first design's count)."""
    from ..dsp.device_filters import padlen

    n = int(max(lengths))
    return sum(2 * (n + 2 * padlen(b, a)) for b, a in coeffs)


def extremes(x, lengths):
    """The shortest and the longest utterance of ``x``, cut to the longer's
    length, on the host, with their indices and lengths."""
    lens = [int(n) for n in lengths]
    pick = [int(np.argmin(lens)), int(np.argmax(lens))]
    t = max(lens[i] for i in pick)
    return pick, x[pick, :t].cpu(), torch.tensor([lens[i] for i in pick])


def sliced_check(x, lengths, coeffs, out, ref=None) -> dict:
    """The shortest and the longest utterance of a launch's output against
    the plain version of those two alone, on CPU tensors (a column never
    reads another column, so the slice is exact); ``ref``, that plain
    output where it was computed already."""
    pick, x2, len2 = extremes(x, lengths)
    lens = [int(n) for n in lengths]
    t = x2.shape[1]
    if ref is None:
        ref = filtfilt_chain_plain(x2, len2, coeffs)
    got = out[pick, :t].cpu()
    return {"utterances": pick, "lengths": [lens[i] for i in pick],
            "equal": bool(torch.equal(got, ref)
                          and not out[pick, t:].any()),
            "max_abs_err": float((got - ref).abs().max())}


class Entry:
    """A library's C entry on fixed inputs, launched on the current
    stream, with its own output and scratch."""

    def __init__(self, lib, x, lengths, coeffs):
        self.lib, self.x = lib, x
        self.nd, self.coef = _table(coeffs)
        self.n = len(coeffs)
        b, t, c = x.shape
        rows = t + 2 * chain_padlen(coeffs)
        self.lengths = lengths.to(x.device, torch.int32)
        self.out = torch.empty_like(x)
        self.scratch = torch.zeros(rows * b * c, device=x.device)

    def __call__(self):
        b, t, c = self.x.shape
        err = self.lib.filtfilt_chain(
            self.x.data_ptr(), self.lengths.data_ptr(), self.out.data_ptr(),
            self.scratch.data_ptr(),
            self.nd.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            self.coef.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n, b, t, c, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"filtfilt_chain failed: cudaError {err}")


def _ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def study_shape(name, x, lengths, coeffs, libs, rounds, iters, sliced):
    """The checks and the timings in turns of one shape."""
    out = filtfilt_chain(x, lengths, coeffs)
    again = filtfilt_chain(x, lengths, coeffs)
    other = Entry(libs["other"], x, lengths, coeffs)
    other()
    torch.cuda.synchronize()
    res = {"shape": name, "B_T_C": list(x.shape),
           "lengths": [int(lengths.min()), int(lengths.max())],
           "equal_other": bool(torch.equal(out, other.out)),
           "repeat_equal": bool(torch.equal(out, again))}
    if sliced:
        res["plain"] = sliced_check(x, lengths, coeffs, out)
    else:
        ref = filtfilt_chain_plain(x.cpu(), lengths.cpu(), coeffs)
        res["plain"] = {"equal": bool(torch.equal(out.cpu(), ref)),
                        "max_abs_err": float((out.cpu() - ref).abs().max())}
    res["ok"] = res["equal_other"] and res["repeat_equal"] and \
        res["plain"]["equal"]
    entries = {n: Entry(lib, x, lengths, coeffs) for n, lib in libs.items()}
    times = {n: [] for n in entries}
    order = list(entries)
    for _ in range(rounds):
        for n in order + order[::-1]:
            times[n].append(_ms(entries[n], iters))
    steps = chain_steps(lengths.tolist(), coeffs)
    res["chain_steps"] = steps
    res["times"] = times
    res["ms"] = {n: float(np.median(v)) for n, v in times.items()}
    res["ns_per_step"] = {n: ms * 1e6 / steps for n, ms in res["ms"].items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path)
    ap.add_argument("--inputs", type=Path, default=INPUTS)
    ap.add_argument("--shapes", default="phase7,corpus")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=OUT_DIR / "study.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("filtfilt_study needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[filtfilt_study] {card}; torch {torch.__version__}", flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    build.build(["filtfilt"])
    libs = {"other": _load(_nvcc(args.against, OUT_DIR / "libother.so")),
            "port": _library()}
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
        tool = Path(build._nvcc()).parent / "cuobjdump"
        for name, src in (("other", args.against),
                          ("port", build.CSRC / "filtfilt.cu")):
            cubin = _nvcc(src, OUT_DIR / f"{name}.cubin", cubin=True)
            (args.sass / f"sass_filtfilt_{name}.txt").write_text(
                subprocess.run([str(tool), "-sass", str(cubin)],
                               capture_output=True, text=True,
                               check=True).stdout)
    result = {"card": card, "against": str(args.against), "shapes": []}
    shapes = args.shapes.split(",")
    if "phase7" in shapes:
        x, lengths, coeffs = torch.load(args.inputs)
        coeffs = [(b.numpy(), a.numpy()) for b, a in coeffs]
        result["shapes"].append(study_shape(
            "S-phase7", x.cuda().contiguous(), lengths, coeffs, libs,
            args.rounds, iters=10, sliced=False))
    if "corpus" in shapes:
        x, lengths, coeffs = corpus_group(args.seed)
        result["shapes"].append(study_shape(
            "S-corpus", x, lengths, coeffs, libs, args.rounds, iters=2,
            sliced=True))
        del x
    for res in result["shapes"]:
        print(f"[filtfilt_study] check {res['shape']} B,T,C {res['B_T_C']} "
              f"lengths {res['lengths']}: torch.equal to the other "
              f"{res['equal_other']}, to the plain version "
              f"{res['plain']}, two calls {res['repeat_equal']}", flush=True)
        for n, ms in res["ms"].items():
            print(f"[filtfilt_study] {card} | {res['shape']} {n}: {ms:.4f} "
                  f"ms a launch, {res['ns_per_step'][n]:.2f} ns a step of "
                  f"{res['chain_steps']}, median of {len(res['times'][n])} "
                  f"in turns", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0 if all(r["ok"] for r in result["shapes"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
