"""The CTC kernel against another version of ``csrc/ctc.cu`` on the card.

    python -m silent_speech_tpu_torch.ops.ctc_study --against old_ctc.cu \\
        [--sass DIR]

``--against`` names a CTC source with the same C entries (``ctc_forward``,
``ctc_backward``), for example an earlier commit's, written out with ``git
show <commit>:silent_speech_tpu_torch/csrc/ctc.cu > old_ctc.cu``. Both are
built with the port's nvcc flags into ``build/ctc_study/``. On the inputs
of a recognition micro-step that ``chip_smoke.py`` saves
(``build/ctc_micro_step_inputs.pt``, ``--inputs``) and on edge shapes, the
port's kernel must give the other's NLL and gradient (``torch.equal``
reported; on the rows with labels too) and the plain version's within
the card tests' tolerances; then each side's forward and backward (the C
entries alone, CUDA events) are timed in turns, other, port, port,
other.

``--sass DIR`` writes ``cuobjdump -sass`` of the ``--against`` source.

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
from .ctc import _inputs, _library, ctc_grad_plain, ctc_nll, ctc_nll_plain

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "ctc_study"
BLANK = 37
# the card tests' tolerances (tests/test_torch_kernels_cuda.py)
NLL_RTOL, GRAD_RTOL = 1e-6, 1e-5

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
    lib.ctc_forward.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.ctc_backward.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    return lib


def _entries(lib, lp, utt_len, labels, text_len, g_nll, states=None):
    """The library's forward and backward on these inputs, as calls that
    launch them on the current stream, and their outputs. With
    ``states``, the backward reads those per-frame states and the forward
    writes its own."""
    u, t, k = lp.shape
    s = labels.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    dev = lp.device
    nll = torch.empty(u, device=dev)
    h_phi = torch.empty((u, t + 1, s + 1), device=dev)
    h_emit = torch.empty_like(h_phi)
    occ_e = torch.empty((u, t, s + 1), device=dev)
    occ_b = torch.empty_like(occ_e)
    grad = torch.empty_like(lp)
    read_phi, read_emit = states if states else (h_phi, h_emit)

    def forward():
        err = lib.ctc_forward(lp.data_ptr(), utt_len.data_ptr(),
                              labels.data_ptr(), text_len.data_ptr(),
                              nll.data_ptr(), h_phi.data_ptr(),
                              h_emit.data_ptr(), u, t, k, s, BLANK, stream)
        if err:
            raise RuntimeError(f"ctc_forward failed: cudaError {err}")

    def backward():
        err = lib.ctc_backward(lp.data_ptr(), utt_len.data_ptr(),
                               labels.data_ptr(), text_len.data_ptr(),
                               read_phi.data_ptr(), read_emit.data_ptr(),
                               g_nll.data_ptr(), occ_e.data_ptr(),
                               occ_b.data_ptr(), grad.data_ptr(), u, t, k, s,
                               BLANK, stream)
        if err:
            raise RuntimeError(f"ctc_backward failed: cudaError {err}")

    return forward, backward, nll, grad, (h_phi, h_emit)


def _ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rows(seed, t, s, rows):
    """Log-probs (U, t, 38) and one row per (labels, frames) of ``rows``."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(len(rows), t, 38)).astype(np.float32) * 2), -1)
    labels = np.full((len(rows), s), -1, np.int64)
    for i, (n, _) in enumerate(rows):
        labels[i, :n] = rng.integers(0, 37, size=n)
    return [lp.cuda()] + [torch.tensor(x).cuda() for x in (
        [r[1] for r in rows], labels, [r[0] for r in rows])]


def compare(name, other, lp, utt_len, labels, text_len) -> dict:
    """The port's NLL and gradient against ``other``'s (torch.equal, and
    on the rows with labels alone: an older kernel gave a row without
    labels a zero gradient), the plain version's (autograd and the
    ``ctc_grad_plain`` mirror, every row) and a second call's."""
    ul, lab, tl = _inputs(lp, utt_len, labels, text_len, torch.int32)
    g = torch.rand(lp.shape[0], device=lp.device,
                   generator=torch.Generator(lp.device).manual_seed(5))
    runs = []
    for _ in range(2):
        x = lp.detach().clone().requires_grad_()
        nll = ctc_nll(x, ul, lab, tl, BLANK)
        (nll * g).sum().backward()
        runs.append((nll.detach(), x.grad))
    fwd, bwd, o_nll, o_grad, _ = _entries(other, lp, ul, lab, tl, g)
    fwd()
    bwd()
    x = lp.detach().clone().requires_grad_()
    ref = ctc_nll_plain(x, utt_len, labels, text_len, BLANK)
    (ref * g).sum().backward()
    torch.cuda.synchronize()
    (nll, grad), text = runs[0], tl > 0
    tol = GRAD_RTOL * float(x.grad.abs().max())
    mirror = ctc_grad_plain(lp, utt_len, labels, text_len, BLANK) * g[
        :, None, None]
    out = {"case": name, "shape": list(lp.shape) + [labels.shape[1]],
           "nll_equal_other": torch.equal(nll, o_nll),
           "grad_equal_other": torch.equal(grad, o_grad),
           "grad_equal_other_rows_with_labels": torch.equal(grad[text],
                                                            o_grad[text]),
           "repeat_equal": (torch.equal(nll, runs[1][0])
                            and torch.equal(grad, runs[1][1])),
           "nll_rel_plain": float(((nll - ref.detach()).abs()
                                   / ref.detach().abs().clamp_min(1e-30))
                                  .max()),
           "grad_err_plain": float((grad - x.grad).abs().max()),
           "grad_err_mirror": float((grad - mirror).abs().max()),
           "grad_tol": tol}
    out["ok"] = (out["repeat_equal"] and out["nll_rel_plain"] <= NLL_RTOL
                 and out["grad_err_plain"] <= tol
                 and out["grad_err_mirror"] <= tol)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path)
    ap.add_argument("--inputs", type=Path,
                    default=ROOT / "build" / "ctc_micro_step_inputs.pt")
    ap.add_argument("--sass", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=OUT_DIR / "study.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ctc_study needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[ctc_study] {card}; torch {torch.__version__}", flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    build.build(["ctc"])
    other = _load(_nvcc(args.against, OUT_DIR / "libother.so"))
    result = {"card": card, "against": str(args.against)}

    lp, utt_len, labels, text_len, blank = torch.load(args.inputs)
    assert blank == BLANK
    lp = lp.cuda().contiguous()
    utt_len, labels, text_len = (v.cuda() for v in (utt_len, labels,
                                                     text_len))
    cases = [("micro_step", [lp, utt_len, labels, text_len]),
             ("edges_S64", _rows(1, 165, 64, [
                 (0, 165), (31, 63), (32, 64), (33, 65), (63, 165), (1, 1),
                 (31, 51), (32, 52), (33, 53), (63, 100), (40, 20),
                 (64, 165), (5, 0)])),
             ("L1023", _rows(2, 40, 1023, [(1023, 40), (1000, 33), (0, 40),
                                           (3, 40)])),
             ("S128_T1024", _rows(3, 1024, 128, [(128, 1024), (100, 999),
                                                 (64, 513), (33, 52)]))]
    result["checks"] = [compare(n, other, *c) for n, c in cases]
    for c in result["checks"]:
        print(f"[ctc_study] check {json.dumps(c)}", flush=True)

    ul, lab, tl = _inputs(lp, utt_len, labels, text_len, torch.int32)
    g = torch.ones(lp.shape[0], device="cuda")
    frames = int(utt_len.max())
    libs = {"other": other, "port": _library()}
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
        tool = Path(build._nvcc()).parent / "cuobjdump"
        cubin = _nvcc(args.against, OUT_DIR / "other.cubin", cubin=True)
        (args.sass / "sass_other.txt").write_text(subprocess.run(
            [str(tool), "-sass", str(cubin)], capture_output=True,
            text=True, check=True).stdout)
    # every backward reads the states of the other version's forward
    first, _, _, _, states = _entries(other, lp, ul, lab, tl, g)
    first()
    calls = {n: _entries(lib, lp, ul, lab, tl, g, states)[:2]
             for n, lib in libs.items()}
    times = {n: {"forward": [], "backward": []} for n in libs}
    order = list(libs)
    for _ in range(args.rounds):
        for n in order + order[::-1]:
            forward, backward = calls[n]
            times[n]["forward"].append(_ms(forward))
            times[n]["backward"].append(_ms(backward))
    result["frames"] = frames
    result["times"] = times
    for n, d in times.items():
        f, b = float(np.median(d["forward"])), float(np.median(d["backward"]))
        print(f"[ctc_study] {card} | {n}: forward {f:.4f} ms "
              f"({f * 1e6 / frames:.1f} ns a frame), backward {b:.4f} ms "
              f"({b * 1e6 / frames:.1f} ns a frame) over {frames} frames, "
              f"medians of {len(d['forward'])} in turns", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0 if all(c["ok"] for c in result["checks"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
