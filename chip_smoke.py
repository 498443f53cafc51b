#!/usr/bin/env python3
"""Drive the PyTorch port (``silent_speech_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. build every CUDA kernel from ``silent_speech_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, in
   bf16 and f32, at the serving shapes (L = T, L < T, T < m);
3. serve: init a full-width transduction model and a full-width
   recognition model from a seed, save each as a reference-layout
   ``model.pt``, export both with the export CLI, load the bundles on the
   card, start the HTTP server and answer transduce and recognize requests
   in every bucket. Every kernel's launch count is zeroed just before and
   read just after, and each must have launched on that path. Outputs are
   checked for shape and finiteness, against the same bundle with the plain
   attention on the card, and (f32) against the same bundle on the CPU;
4. time the requests per bucket, the forward per bucket and each kernel
   per launch against its bound and its plain version, and profile one
   forward in the largest bucket (device busy time, kernels by time).

The last lines are the card (``nvidia-smi`` name and power limit), one JSON
line describing each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKETS = (256, 512, 1024, 2048)
REQUEST_T = (200, 450, 700, 1500)  # one utterance length per bucket
TIMED_REQUESTS = 5                 # per kind and length, after one warm-up
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 tensor cores
            "float32": 67e12}      # f32 outside the tensor cores
# kernel vs plain: both compute in f32; a bf16 output may differ by one
# rounding step (2^-6 at |O| < 4)
KERNEL_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
KERNEL_CASES = ((256, 256), (1024, 1024), (2048, 2048), (256, 37), (64, 64))
HEADLINE_T = 1024
# a full bf16 forward with the kernel vs the plain attention: per-layer
# differences of one bf16 step compound over 6 layers
SERVED_RTOL = 0.05
# f32 forward on the card vs on the CPU (TF32 off): summation order only
F32_ATOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(samples) -> float:
    return float(np.median(samples)) * 1e3


def cuda_time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(t: int, dtype, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(1, 8, t, 96, device="cuda", generator=g)
               for _ in range(3))
    e = torch.randn(8, 199, 96, device="cuda", generator=g) * 96 ** -0.5
    return [x.to(dtype).contiguous() for x in (q, k, v, e)]


def attention_bound(b, h, t, dh, m, valid_len, dtype_name):
    """Least time for the function: each input read once and the output
    written once over HBM, or its three d_h-long dot products (QK, QE,
    PV) per visible (q, k) pair over the peak rate; the larger wins."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (4 * b * h * t * dh + h * (2 * m - 1) * dh) * item
    q = np.arange(t)
    lo = np.where(q < valid_len, np.maximum(0, q - m + 1),
                  np.maximum(valid_len, q - m + 1))
    hi = np.where(q < valid_len, np.minimum(valid_len - 1, q + m - 1),
                  np.minimum(t - 1, q + m - 1))
    pairs = int(np.sum(hi - lo + 1))
    ops = 3 * 2 * dh * pairs * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def post(port: int, route: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def utterance(t: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, 112)).astype(np.float32),
            rng.normal(size=(8 * t, 8)).astype(np.float32))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import silent_speech_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        raise RuntimeError(f"silent_speech_tpu_torch resolved outside the "
                           f"checkout: {port.__file__}")
    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.eval import export
    from silent_speech_tpu_torch.eval.server import ServingServer
    from silent_speech_tpu_torch.models import transformer
    from silent_speech_tpu_torch.models.encoder import EMGEncoder
    from silent_speech_tpu_torch.ops import build
    from silent_speech_tpu_torch.ops.rel_attention import (
        rel_attention, rel_attention_plain)
    from silent_speech_tpu_torch.utils.device import card_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info("cuda")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {len(built)} kernel(s) in {time.perf_counter() - t0:.2f} s")
    for name, (secs, msgs) in built.items():
        log(f"[build] {name}: {secs:.2f} s")
        for line in msgs.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")

    # 2. kernel vs plain ---------------------------------------------------
    max_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for t, valid_len in KERNEL_CASES:
            q, k, v, e = attention_inputs(t, dtype, seed=t + valid_len)
            out = rel_attention(q, k, v, e, 100, valid_len)
            torch.cuda.synchronize()
            ref = rel_attention_plain(q, k, v, e, 100, valid_len)
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= KERNEL_ATOL[name]
            log(f"[kernel] rel_attention_fwd {name} T={t} L={valid_len}: "
                f"max_abs_err {err:.3g} (tolerance {KERNEL_ATOL[name]}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version: {name} T={t} L={valid_len}")
            max_err[name] = max(max_err.get(name, 0.0), err)

    # 3. serve -------------------------------------------------------------
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT,
                                                                   "build"))
    server = None
    try:
        bundles = {}
        for i, (kind, heads) in enumerate((("transduction", (80, 48)),
                                           ("recognition", (38, None)))):
            model = EMGEncoder(*heads, ModelConfig()).init_weights(
                torch.Generator().manual_seed(SEED + i))
            path = os.path.join(work, f"{kind}.pt")
            torch.save(model.state_dict(), path)
            argv = ["--models", path, "--output_directory",
                    os.path.join(work, kind),
                    "--t_buckets", ",".join(map(str, BUCKETS))]
            export.main(argv + (["--recognition"]
                                if kind == "recognition" else []))
            bundles[kind] = export.ServingBundle.load(
                os.path.join(work, kind), device="cuda")
        n_params = sum(p.numel() for p in
                       bundles["transduction"].model.parameters())
        log(f"[serve] transduction model: {n_params} parameters, bf16 "
            f"compute, buckets {BUCKETS}")
        server = ServingServer(recognition=bundles["recognition"],
                               transduction=bundles["transduction"]).start()
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30).read())
        if health != {"ok": True, "kinds": ["recognition", "transduction"]}:
            raise AssertionError(f"/healthz answered {health}")

        requests = []
        for t in REQUEST_T:
            emg, raw = utterance(t, seed=SEED + t)
            body = {"emg": emg.tolist(), "raw_emg": raw.tolist()}
            requests.append((t, "/v1/transduce",
                             {**body, "session_ids": [0] * t}))
            requests.append((t, "/v1/recognize", body))

        rel_attention.launches = 0
        latency, replies = {}, {}
        for t, route, body in requests:
            for rep in range(1 + TIMED_REQUESTS):
                t0 = time.perf_counter()
                reply = post(server.port, route, body)
                if rep:
                    latency.setdefault((route, t), []).append(
                        time.perf_counter() - t0)
            replies[(route, t)] = reply
        launches = {"rel_attention_fwd": rel_attention.launches}
        n_requests = len(requests) * (1 + TIMED_REQUESTS)
        layers = bundles["transduction"].model.cfg.num_layers
        log(f"[serve] {n_requests} requests, launches {launches}")
        if launches["rel_attention_fwd"] != layers * n_requests:
            raise AssertionError(
                f"expected {layers} attention launches per request, got "
                f"{launches['rel_attention_fwd']} for {n_requests}")

        for (route, t), reply in replies.items():
            key, width = (("mel", 80) if route == "/v1/transduce"
                          else ("log_probs", 38))
            out = np.asarray(reply[key], np.float32)
            if out.shape != (t, width) or not np.isfinite(out).all():
                raise AssertionError(f"{route} t={t}: shape {out.shape}, "
                                     f"finite {np.isfinite(out).all()}")
            if route == "/v1/recognize" and not isinstance(reply["text"],
                                                           str):
                raise AssertionError("recognize reply has no text")

        # the served outputs against the same bundles with the plain
        # attention on the card (the kernel swapped out, not counted)
        t_cmp = REQUEST_T[2]
        emg, raw = utterance(t_cmp, seed=SEED + t_cmp)
        transformer.rel_attention = rel_attention_plain
        try:
            plain = {
                "/v1/transduce": bundles["transduction"].predict(
                    emg, raw, np.zeros(t_cmp, np.int64)),
                "/v1/recognize": bundles["recognition"].predict(emg, raw)}
        finally:
            transformer.rel_attention = rel_attention
        for route, ref in plain.items():
            key = "mel" if route == "/v1/transduce" else "log_probs"
            served = np.asarray(replies[(route, t_cmp)][key], np.float32)
            err = float(np.abs(served - ref).max())
            bound = SERVED_RTOL * float(np.abs(ref).max())
            log(f"[serve] {route} t={t_cmp} served vs plain attention: "
                f"max_abs_err {err:.4g} (tolerance {bound:.4g} = "
                f"{SERVED_RTOL} x max|ref|)")
            if not err <= bound:
                raise AssertionError(f"{route}: kernel path disagrees with "
                                     f"the plain attention")

        # f32 forward on the card vs on the CPU, same weights
        t_f32 = REQUEST_T[0]
        emg, raw = utterance(t_f32, seed=SEED + 99)
        ref_dir = os.path.join(work, "transduction")
        outs = [export.ServingBundle.load(ref_dir, device=dev,
                                          dtype=torch.float32).predict(
                    emg, raw, np.zeros(t_f32, np.int64))
                for dev in ("cuda", "cpu")]
        err = float(np.abs(outs[0] - outs[1]).max())
        log(f"[serve] f32 transduce t={t_f32} card vs CPU: max_abs_err "
            f"{err:.3g} (tolerance {F32_ATOL})")
        if not err <= F32_ATOL:
            raise AssertionError("f32 forward on the card disagrees with "
                                 "the CPU")

        # 4. timings -------------------------------------------------------
        for (route, t), samples in sorted(latency.items()):
            bucket = next(b for b in BUCKETS if t <= b)
            log(f"[time] {card} | {route} bucket {bucket} (t={t}): request "
                f"p50 {median_ms(samples):.2f} ms over {len(samples)}")
        for t in REQUEST_T:
            bucket = next(b for b in BUCKETS if t <= b)
            emg, raw = utterance(t, seed=SEED + t)
            bundle = bundles["transduction"]
            bundle.predict(emg, raw, np.zeros(t, np.int64))
            samples = []
            for _ in range(TIMED_REQUESTS):
                t0 = time.perf_counter()
                bundle.predict(emg, raw, np.zeros(t, np.int64))
                samples.append(time.perf_counter() - t0)
            log(f"[time] {card} | transduction predict() bucket {bucket}: "
                f"p50 {median_ms(samples):.2f} ms (forward incl. host "
                f"copies, no HTTP/JSON)")

        # where one forward's time goes: kernels on the card vs the host
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bundle.predict(emg, raw, np.zeros(t, np.int64))
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.time_range.elapsed_us() / 1e3)
        busy = sum(by_name.values())
        if busy == 0:
            log("[profile] device time not measured: the profiler saw no "
                "CUDA activity")
        else:
            log(f"[profile] {card} | transduction predict() bucket {bucket} "
                f"under the profiler: wall {wall_ms:.3f} ms, device busy "
                f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.1%}")
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                log(f"[profile]   {ms:8.3f} ms {ms / busy:6.1%}  {name[:100]}")
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for t in (256, 1024, 2048):
        q, k, v, e = attention_inputs(t, torch.bfloat16, seed=7)
        ms = cuda_time_ms(lambda: rel_attention(q, k, v, e, 100, t))
        plain_ms = cuda_time_ms(
            lambda: rel_attention_plain(q, k, v, e, 100, t), iters=10)
        bound_ms, bound_by = attention_bound(1, 8, t, 96, 100, t,
                                             "bfloat16")
        log(f"[time] {card} | rel_attention_fwd bf16 B=1 H=8 T={t} d_h=96 "
            f"m=100: kernel {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}), "
            f"{bound_ms / ms:.2%} of bound")
        if t == HEADLINE_T:
            kernels.append({
                "name": "rel_attention_fwd", "route": "cuda",
                "source": "silent_speech_tpu_torch/csrc/rel_attention_fwd.cu",
                "replaces": "silent_speech_tpu/ops/pallas/rel_attention.py:386",
                "shape": f"B=1 H=8 T={t} d_h=96 m=100 L=T bf16",
                "launches": launches["rel_attention_fwd"],
                "max_abs_err": max_err["bfloat16"],
                "max_abs_err_f32": max_err["float32"],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
