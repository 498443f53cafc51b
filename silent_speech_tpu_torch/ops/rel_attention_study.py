"""The float32 attention kernels against other versions of their sources
on the card: the backward (``csrc/rel_attention_bwd.cu``) or, with
``--forward``, the forward (``csrc/rel_attention_fwd.cu``).

    mkdir -p build/old
    git show <commit>:silent_speech_tpu_torch/csrc/rel_attention_bwd.cu \\
        > build/old/rel_attention_bwd.cu
    git show <commit>:silent_speech_tpu_torch/csrc/rel_attention.cuh \\
        > build/old/rel_attention.cuh
    python -m silent_speech_tpu_torch.ops.rel_attention_study \\
        --against build/old/rel_attention_bwd.cu [--shapes train,rec] \\
        [--ablate]
    # the forward: the same with rel_attention_fwd.cu and
    python -m silent_speech_tpu_torch.ops.rel_attention_study --forward \\
        --against build/old/rel_attention_fwd.cu [--ablate]

Backward. ``--against`` names a source with the single C entry of the
design before the staged one, ``rel_attention_bwd`` (one kernel writing
per-query-tile partials of dK, dV and dE, a second summing them) and
``rel_attention_bwd_partial_elems``; it includes the ``rel_attention.cuh``
beside it, else the port's. Both are built with the port's nvcc flags, the
other into ``build/rel_attention_study/``. At the training step's shape
(``train``: B=120, H=8, T=200, d_h=96, m=100, dropout 0.2) and a
recognition micro-step's (``rec``: B=64), the port's dQ, dK, dV and dE
must match autograd through the plain version within 1e-4 of each
gradient's largest entry and repeat bit for bit; the other's are checked
the same way and against the port's. Then each library's whole backward
(every launch of it, the partials' or the stages' and the dE sum
included, scratch allocated once) is timed alone by CUDA events in turns,
other, port, port, other, ``--rounds`` times, and each of the port's
stages alone, with the SM clock and the power draw sampled by
``nvidia-smi`` meanwhile (medians).

``--ablate`` times each stage, at the training step's shape, of variants
of the port's own source, each a text edit that must apply to it or to
the ``f32_band.cuh`` it includes: (a) stage A's products with a quarter of
their FMAs (one of the four a 128-bit step), (b) stage A without R's
product, (c) stage A without its scratch stores, (d) stage A without the
dropout hash, (e) stage A without the softmax, (f) a third buffer in every
stage's ring of slices. Their outputs are wrong by design but (f)'s; the
point is the ms each piece costs.

Forward (``--forward``). ``--against`` names another source with the C
entry ``rel_attention_fwd`` (the same arguments as the port's; the
design before the band one includes the ``rel_attention.cuh`` of its
commit, which goes beside it). At ``train`` and ``rec`` with dropout 0.2
both outputs must lie within 1e-4 of the plain version
(``chip_smoke.KERNEL_ATOL``), the port's repeat bit for bit, and both
are compared with each other; then the two C entries are timed alone in
turns (other, port, port, other) into preallocated outputs, with the SM
clock and power, beside ``chip_smoke.attention_bound``'s bound and the
plain version's time. Its
``--ablate`` times, at ``train`` and in turns with the port, (a) the
three products with a quarter of their FMAs, (b) no P'.V, (c) no
dropout hash.

Needs a CUDA card and nvcc. Prints one line per result and writes them as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import build
from .rel_attention import (STAGES, _bind, _keep_scale, _library,
                            _staged_bwd, attention_drop_threshold,
                            rel_attention, rel_attention_bwd,
                            rel_attention_plain)

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "rel_attention_study"
SHAPES = {"train": 120, "rec": 64}       # B at H=8, T=200, d_h=96, m=100
H, T, DH, M = 8, 200, 96, 100
RTOL = 1e-4                               # chip_smoke.BWD_RTOL["float32"]
FWD_ATOL = 1e-4                           # chip_smoke.KERNEL_ATOL["float32"]

# --ablate: text edits of csrc/rel_attention_bwd.cu
_FMA_YZW = """        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
"""
_R = """band_product(acc, q + head, e + (size_t)h * W * dh, q0, T, r_lo,
               r_hi - r_lo, r_hi, dh, sA, sB);"""
_NEVER = "dsv == 1234.5f"   # a store no cell takes
ABLATIONS = {
    "a": [(_FMA_YZW, "")],
    "b": [(_R, _R.replace("r_hi - r_lo, r_hi", "0, r_hi"))],
    "c": [("      pp[(row0 + qi) * Tp + kj] =",
           f"      if ({_NEVER}) pp[(row0 + qi) * Tp + kj] ="),
          ("      ds[(row0 + qi) * Tp + kj] = dsv;",
           f"      if ({_NEVER}) ds[(row0 + qi) * Tp + kj] = dsv;"),
          ("if (kj < T && r >= 0 && r < W) dr[",
           f"if ({_NEVER} && kj < T && r >= 0 && r < W) dr["),
          ("  for (int i = warp; i < QA; i += NWARPS) {\n    const int qi = q0",
           "  for (int i = warp; i < QA && q0 < 0; i += NWARPS) {\n"
           "    const int qi = q0")],
    "d": [("const bool keep = drop_threshold == 0u ||",
           "const bool keep = true ||")],
    "e": [("for (int j = lane; j < nb; j += 32) mx = fmaxf(mx, srow[j]);",
           "for (int j = lane; j < 0; j += 32) mx = fmaxf(mx, srow[j]);"),
          ("    for (int j = lane; j < nb; j += 32) {\n      const float p",
           "    for (int j = lane; j < 0; j += 32) {\n      const float p")],
    "f": [("constexpr int NBUF = 2;", "constexpr int NBUF = 3;")],
}
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def _load_other(src: Path, forward: bool = False) -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / ("libother_fwd.so" if forward else "libother.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)
    if forward:     # q, k, v, e, o, dims, the dropout's, is_bf16, stream
        lib.rel_attention_fwd.argtypes = ([ptr] * 5 + [i32] * 6
                                          + [f32, u32, u32, f32] + [i32] * 4
                                          + [ptr])
        lib.rel_attention_fwd.restype = i32
        return lib
    lib.rel_attention_bwd.argtypes = ([ptr] * 12 + [i32] * 6
                                      + [f32, u32, u32, f32] + [i32] * 4
                                      + [ptr])
    lib.rel_attention_bwd.restype = i32
    lib.rel_attention_bwd_partial_elems.argtypes = [i32] * 6
    lib.rel_attention_bwd_partial_elems.restype = ctypes.c_longlong
    return lib


# --forward --ablate: text edits of csrc/rel_attention_fwd.cu and the
# f32_band.cuh it includes
FWD_ABLATIONS = {
    "a": [(_FMA_YZW, ""), ("          for (int s = 0; s < 4; ++s) {",
                           "          for (int s = 0; s < 1; ++s) {")],
    "b": [("      ncp / KV,", "      0,"),
          ("  stage_async<DH>(sV, LDV, vh, DH, kb, KV, T, 0, DH);\n", "")],
    "c": [("const bool keep = drop_threshold == 0u ||",
           "const bool keep = true ||")],
}
HEADER = "f32_band.cuh"


def edited_texts(name: str, tag: str, edits) -> dict:
    """``csrc/<name>.cu`` and the f32_band.cuh it includes, by file name,
    after the edits of ablation ``tag``: each applies to the one text that
    holds its code, exactly once, or the call raises."""
    edited = {f"{name}.cu": (build.CSRC / f"{name}.cu").read_text(),
              HEADER: (build.CSRC / HEADER).read_text()}
    for old, new in edits:
        where = [f for f, text in edited.items() if old in text]
        if len(where) != 1 or edited[where[0]].count(old) != 1:
            raise ValueError(f"--ablate ({tag}): the source does not have "
                             f"the code this variant edits once:\n{old}")
        edited[where[0]] = edited[where[0]].replace(old, new)
    return edited


def ablation_libs(name: str = "rel_attention_bwd",
                  ablations: dict = ABLATIONS) -> dict:
    """Each ablation of ``csrc/<name>.cu``, built in parallel and bound; a
    variant's edited texts go into a directory of their own, which its
    include finds first."""
    procs = {}
    for tag, edits in ablations.items():
        edited = edited_texts(name, tag, edits)
        out_dir = OUT_DIR / f"ablate_{name}_{tag}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for f, text in edited.items():
            (out_dir / f).write_text(text)
        out = out_dir / f"lib{name}.so"
        procs[tag] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(out), str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"--ablate ({tag}) did not build:\n{log}")
        libs[tag] = _bind(ctypes.CDLL(str(out)), name)
    return libs


def _inputs(b: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(b, H, T, DH, device="cuda", generator=g)
                     for _ in range(4))
    e = torch.randn(H, 2 * M - 1, DH, device="cuda", generator=g) * DH ** -0.5
    return q, k, v, e, dout


def _other_call(lib, q, k, v, e, dout, seed, thresh):
    """The other library's backward as a call that launches it on the
    current stream, and its outputs."""
    b = q.shape[0]
    dims = (b, H, T, DH, M)
    outs = [torch.empty_like(x) for x in (q, k, v, e)]
    parts = [torch.empty(lib.rel_attention_bwd_partial_elems(w, *dims),
                         device="cuda") for w in (0, 0, 1)]
    args = [x.data_ptr() for x in (q, k, v, e, dout, *outs, *parts)]

    def call():
        err = lib.rel_attention_bwd(
            *args, *dims, T, 1.0 / math.sqrt(DH), seed, thresh,
            _keep_scale(thresh), 0, 0, H, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other rel_attention_bwd failed: "
                               f"cudaError {err}")

    return call, outs


class ClockSampler:
    """``nvidia-smi``'s SM clock (MHz) and power draw (W) every 100 ms
    while the block runs, from its first sample on (the block starts once
    ``nvidia-smi`` is up, so a short one still gets its samples);
    ``median()`` gives both medians."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        self.proc.stdout.readline()   # nvidia-smi is up: its first sample
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        lines = self.proc.communicate()[0].splitlines()
        self.rows = [[float(x) for x in line.split(",")]
                     for line in lines if line.count(",") == 1]

    def median(self):
        if not self.rows:
            return None, None
        clock, power = np.median(np.array(self.rows), axis=0)
        return float(clock), float(power)


def _ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(b: int):
    """Least time of the function: Q, K, V, dO, E read and dQ, dK, dV, dE
    written once over HBM, or eight d_h-long products a visible pair over
    the FP32 peak (chip_smoke.attention_bwd_bound); the larger, and which
    one it is."""
    pos = np.arange(T)
    pairs = int((np.abs(pos[:, None] - pos[None, :]) <= M - 1).sum())
    t_bytes = (7 * b * H * T * DH + 2 * H * (2 * M - 1) * DH) * 4 \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 16 * DH * pairs * b * H / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check(name, other, b, thresh) -> dict:
    q, k, v, e, dout = _inputs(b, seed=b)
    ours = rel_attention_bwd(q, k, v, e, dout, M, None, 3, thresh)
    again = rel_attention_bwd(q, k, v, e, dout, M, None, 3, thresh)
    call, theirs = _other_call(other, q, k, v, e, dout, 3, thresh)
    call()
    xs = [x.detach().requires_grad_() for x in (q, k, v, e)]
    rel_attention_plain(*xs, M, None, 3, thresh).backward(dout)
    torch.cuda.synchronize()
    out = {"case": name, "B": b, "repeat_equal": all(
        torch.equal(x, y) for x, y in zip(ours, again))}
    for g, o, t_, x in zip(("dq", "dk", "dv", "de"), ours, theirs, xs):
        scale = float(x.grad.abs().max())
        out[f"{g}_err_plain"] = float((o - x.grad).abs().max()) / scale
        out[f"{g}_other_err_plain"] = float((t_ - x.grad).abs().max()) / scale
        out[f"{g}_err_other"] = float((o - t_).abs().max()) / scale
    out["ok"] = out["repeat_equal"] and all(
        out[f"{g}_err_plain"] <= RTOL for g in ("dq", "dk", "dv", "de"))
    return out


def ablate(card, thresh, rounds, iters) -> dict:
    """Each stage of the port and of its ablations at the training step's
    shape, timed alone in turns; medians in ms."""
    libs = {"port": _library("rel_attention_bwd"), **ablation_libs()}
    q, k, v, e, dout = _inputs(SHAPES["train"], seed=1)
    stages = {n: _staged_bwd(q, k, v, e, dout, M, T, 3, thresh, lib=lib)[1]
              for n, lib in libs.items()}
    times = {n: {s: [] for s in STAGES} for n in libs}
    order = list(libs)
    with ClockSampler() as clocks:
        for _ in range(rounds):
            for n in order + order[::-1]:
                for s, launch in stages[n]:
                    times[n][s].append(_ms(launch, iters))
    med = {n: {s: float(np.median(v)) for s, v in d.items()}
           for n, d in times.items()}
    clock, power = clocks.median()
    for n, d in med.items():
        print(f"[rel_attention_study] {card} | ablation {n}: "
              + ", ".join(f"{s} {d[s]:.4f}" for s in STAGES)
              + f" ms (sum {sum(d.values()):.4f}), medians of "
              f"{2 * rounds} in turns; SM clock {clock} MHz, {power} W",
              flush=True)
    return {"ms": med, "sm_clock_mhz": clock, "power_w": power}


def _fwd_call(lib, q, k, v, e, seed, thresh):
    """A library's f32 forward as a call that launches it on the current
    stream into a preallocated output, and that output."""
    b = q.shape[0]
    out = torch.empty_like(q)
    args = [x.data_ptr() for x in (q, k, v, e, out)]

    def call():
        err = lib.rel_attention_fwd(
            *args, b, H, T, DH, M, T, 1.0 / math.sqrt(DH), seed, thresh,
            _keep_scale(thresh), 0, 0, H, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rel_attention_fwd failed: cudaError {err}")

    return call, out


def fwd_bound_ms(b: int):
    """chip_smoke.attention_bound in f32: Q, K, V, E read and O written
    once over HBM, or three d_h-long products a visible pair over the
    FP32 peak; the larger, and which one it is."""
    pos = np.arange(T)
    pairs = int((np.abs(pos[:, None] - pos[None, :]) <= M - 1).sum())
    t_bytes = (4 * b * H * T * DH + H * (2 * M - 1) * DH) * 4 \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * DH * pairs * b * H / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_fwd(name, other, b, thresh) -> dict:
    q, k, v, e, _ = _inputs(b, seed=b)
    ours = rel_attention(q, k, v, e, M, None, 3, thresh)
    again = rel_attention(q, k, v, e, M, None, 3, thresh)
    call, theirs = _fwd_call(other, q, k, v, e, 3, thresh)
    call()
    ref = rel_attention_plain(q, k, v, e, M, None, 3, thresh)
    torch.cuda.synchronize()
    out = {"case": name, "B": b, "repeat_equal": torch.equal(ours, again),
           "err_plain": float((ours - ref).abs().max()),
           "other_err_plain": float((theirs - ref).abs().max()),
           "err_other": float((ours - theirs).abs().max())}
    out["ok"] = out["repeat_equal"] and out["err_plain"] <= FWD_ATOL
    return out


def ablate_fwd(card, thresh, rounds, iters) -> dict:
    """The port's forward and its ablations at the training step's shape,
    timed alone in turns; medians in ms."""
    libs = {"port": _library("rel_attention_fwd"),
            **ablation_libs("rel_attention_fwd", FWD_ABLATIONS)}
    q, k, v, e, _ = _inputs(SHAPES["train"], seed=1)
    calls = {n: _fwd_call(lib, q, k, v, e, 3, thresh)[0]
             for n, lib in libs.items()}
    times = {n: [] for n in libs}
    order = list(libs)
    with ClockSampler() as clocks:
        for _ in range(rounds):
            for n in order + order[::-1]:
                times[n].append(_ms(calls[n], iters))
    med = {n: float(np.median(v)) for n, v in times.items()}
    clock, power = clocks.median()
    print(f"[rel_attention_study] {card} | forward ablations at B="
          f"{SHAPES['train']}: " + ", ".join(f"{n} {t:.4f}"
                                              for n, t in med.items())
          + f" ms, medians of {2 * rounds} in turns; SM clock {clock} MHz, "
          f"{power} W", flush=True)
    return {"ms": med, "sm_clock_mhz": clock, "power_w": power}


def main_forward(args, card, thresh) -> int:
    build.build(["rel_attention_fwd"])
    other = _load_other(args.against, forward=True)
    shapes = args.shapes.split(",")
    result = {"card": card, "against": str(args.against), "kernel": "forward",
              "shape": f"H={H} T={T} d_h={DH} m={M} f32 dropout 0.2",
              "checks": [check_fwd(s, other, SHAPES[s], thresh)
                         for s in shapes]}
    for c in result["checks"]:
        print(f"[rel_attention_study] forward check {json.dumps(c)}",
              flush=True)
    result["times"] = {}
    port = _library("rel_attention_fwd")
    for s in shapes:
        b = SHAPES[s]
        q, k, v, e, _ = _inputs(b, seed=b)
        calls = {"other": _fwd_call(other, q, k, v, e, 3, thresh)[0],
                 "port": _fwd_call(port, q, k, v, e, 3, thresh)[0]}
        times = {n: [] for n in calls}
        with ClockSampler() as clocks:
            for _ in range(args.rounds):
                for n in ("other", "port", "port", "other"):
                    times[n].append(_ms(calls[n], args.iters))
        clock, power = clocks.median()
        bound, by = fwd_bound_ms(b)
        med = {n: float(np.median(v)) for n, v in times.items()}
        plain = _ms(lambda: rel_attention_plain(q, k, v, e, M, None, 3,
                                                thresh), 3)
        result["times"][s] = {"B": b, "ms": times, "median_ms": med,
                              "plain_ms": plain, "bound_ms": bound,
                              "bound_by": by, "sm_clock_mhz": clock,
                              "power_w": power}
        print(f"[rel_attention_study] {card} | forward B={b} H={H} T={T} "
              f"d_h={DH} m={M} f32 dropout 0.2: other {med['other']:.4f} "
              f"ms, port {med['port']:.4f} ms "
              f"({med['other'] / med['port']:.2f}x), medians of "
              f"{len(times['port'])} in turns; plain {plain:.4f} ms; bound "
              f"{bound:.5f} ms ({by}), "
              f"the port at {bound / med['port']:.1%} of it, the other at "
              f"{bound / med['other']:.1%}; SM clock {clock} MHz, {power} W "
              f"(medians)", flush=True)
        del calls, q, k, v, e
        torch.cuda.empty_cache()
    if args.ablate:
        result["ablations"] = ablate_fwd(card, thresh, args.rounds,
                                         args.iters)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0 if all(c["ok"] for c in result["checks"]) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path)
    ap.add_argument("--shapes", default="train,rec")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--forward", action="store_true",
                    help="study csrc/rel_attention_fwd.cu (default: the "
                         "backward)")
    ap.add_argument("--out", type=Path, default=None,
                    help="JSON results (default build/rel_attention_study/"
                         "study.json, or study_fwd.json with --forward)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rel_attention_study needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[rel_attention_study] {card}; torch {torch.__version__}",
          flush=True)
    thresh = attention_drop_threshold(0.2)
    if args.out is None:
        args.out = OUT_DIR / ("study_fwd.json" if args.forward
                              else "study.json")
    if args.forward:
        return main_forward(args, card, thresh)
    build.build(["rel_attention_bwd"])
    other = _load_other(args.against)
    shapes = args.shapes.split(",")
    result = {"card": card, "against": str(args.against),
              "shape": f"H={H} T={T} d_h={DH} m={M} f32 dropout 0.2",
              "checks": [check(s, other, SHAPES[s], thresh) for s in shapes]}
    for c in result["checks"]:
        print(f"[rel_attention_study] check {json.dumps(c)}", flush=True)

    result["times"] = {}
    for s in shapes:
        b = SHAPES[s]
        q, k, v, e, dout = _inputs(b, seed=b)
        _, stages, _ = _staged_bwd(q, k, v, e, dout, M, T, 3, thresh)
        other_call, _ = _other_call(other, q, k, v, e, dout, 3, thresh)

        def port():
            for _, launch in stages:
                launch()

        calls = {"other": other_call, "port": port}
        times = {n: [] for n in calls}
        with ClockSampler() as clocks:
            for _ in range(args.rounds):
                for n in ("other", "port", "port", "other"):
                    times[n].append(_ms(calls[n], args.iters))
            stage_ms = {n: _ms(launch, args.iters) for n, launch in stages}
        clock, power = clocks.median()
        bound, by = bound_ms(b)
        med = {n: float(np.median(v)) for n, v in times.items()}
        result["times"][s] = {"B": b, "ms": times, "median_ms": med,
                              "stages_ms": stage_ms, "bound_ms": bound,
                              "bound_by": by, "sm_clock_mhz": clock,
                              "power_w": power}
        print(f"[rel_attention_study] {card} | B={b} H={H} T={T} d_h={DH} "
              f"m={M} f32 dropout 0.2: other {med['other']:.4f} ms, port "
              f"{med['port']:.4f} ms ({med['other'] / med['port']:.2f}x), "
              f"medians of {len(times['port'])} in turns; port stages "
              + ", ".join(f"{n} {stage_ms[n]:.4f}" for n in STAGES)
              + f" ms; bound {bound:.4f} ms ({by}), the port at "
              f"{bound / med['port']:.1%} of it; SM clock {clock} MHz, "
              f"{power} W (medians)", flush=True)
        del stages, other_call, calls
        torch.cuda.empty_cache()
    if args.ablate:
        result["ablations"] = ablate(card, thresh, args.rounds, args.iters)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0 if all(c["ok"] for c in result["checks"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
