#!/usr/bin/env python3
"""Drive the PyTorch port (``silent_speech_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. build every CUDA kernel from ``silent_speech_tpu_torch/csrc`` with nvcc,
   one process per source, all started together;
2. hold each kernel against its plain PyTorch version on the card: the
   attention forward (bf16 and f32, serving shapes and the training shape
   with dropout), the attention backward (bf16 and f32, dropout off and
   on) and the DTW alignment with its DP-only mode (prof_dtw's shape and
   the n ∈ {1, 2} edge cases);
3. serve: init a full-width transduction model and a full-width
   recognition model from a seed, save each as a reference-layout
   ``model.pt``, export both with the export CLI, load the bundles on the
   card, start the HTTP server and answer transduce and recognize requests
   in every bucket. Every kernel's launch count is zeroed just before and
   read just after; the forward kernel must launch 6 times a request.
   Outputs are checked for shape and finiteness, against the same bundle
   with the plain attention on the card, and (f32) against the CPU;
4. train: a full-width transduction trainer (bf16 compute, dropout 0.2,
   shift augmentation, AdamW with bf16 moments) takes 2 warm-up and 10
   timed steps on reference-capacity packed batches (120 chunks of 200
   frames, 64 utterances, t_cap 1024), with the counts zeroed just before
   and read just after: 6 forward and 6 backward attention launches and 1
   DTW launch (when the batch has silent utterances) a step. Every loss is
   finite and the weights and BatchNorm statistics move. One eval step.
   Then one f32 step with the kernels against the same step with the plain
   versions swapped in (same seeds, so the same dropout masks);
5. time the requests per bucket, the forward per bucket, the training
   steps (median of 3 synced trials) and each kernel per launch at the
   main path's shapes against its bound and its plain version, and
   profile one forward and one training step (device busy time, idle
   share, kernels by time).

The last lines are the card (``nvidia-smi`` name and power limit), one JSON
line describing each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
KERNEL_CASES = ((1, 256, 256), (1, 1024, 1024), (1, 2048, 2048),
                (1, 256, 37), (1, 64, 64))
TRAIN_BT = (120, 200)              # attention (B, T) of the training step
DROP_CASES = ((4, 200), TRAIN_BT, (1, 1024))    # (B, T), L = T, rate 0.2
# backward vs autograd through the plain version, relative to each
# gradient's largest entry: f32 sums in another order (dK, dV, dE with
# atomics in a run-to-run order); bf16 adds one rounding of each output
BWD_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
HEADLINE_T = 1024
# a full bf16 forward with the kernel vs the plain attention: per-layer
# differences of one bf16 step compound over 6 layers
SERVED_RTOL = 0.05
# f32 forward on the card vs on the CPU (TF32 off): summation order only
F32_ATOL = 2e-3
WARMUP_STEPS = 2
TRIAL_STEPS = (4, 3, 3)            # 10 timed steps in 3 synced trials
# f32 train step with the kernels vs with the plain versions: the loss to
# 1e-4 relative; gradients to 1e-3 of each tensor's largest entry (sums in
# another order, and a DTW row may flip on a near-tie of the two runs'
# slightly different costs)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
COMPARED_GRADS = ("conv_blocks.0.conv1.weight",
                  "transformer.layers.0.self_attn.w_q",
                  "transformer.layers.5.self_attn.relative_positional"
                  ".embeddings",
                  "transformer.layers.3.linear1.weight", "w_out.weight",
                  "w_aux.weight")


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


def attention_inputs(b: int, t: int, dtype, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, 8, t, 96, device="cuda", generator=g)
               for _ in range(3))
    e = torch.randn(8, 199, 96, device="cuda", generator=g) * 96 ** -0.5
    return [x.to(dtype).contiguous() for x in (q, k, v, e)]


def _visible_pairs(t, m, valid_len) -> int:
    q = np.arange(t)
    lo = np.where(q < valid_len, np.maximum(0, q - m + 1),
                  np.maximum(valid_len, q - m + 1))
    hi = np.where(q < valid_len, np.minimum(valid_len - 1, q + m - 1),
                  np.minimum(t - 1, q + m - 1))
    return int(np.sum(hi - lo + 1))


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_bound(b, h, t, dh, m, valid_len, dtype_name):
    """Least time for the forward: Q, K, V and E read once and O written
    once over HBM, or its three d_h-long dot products (QK, QE, PV) per
    visible (q, k) pair over the peak rate; the larger wins."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (4 * b * h * t * dh + h * (2 * m - 1) * dh) * item
    ops = 3 * 2 * dh * _visible_pairs(t, m, valid_len) * b * h
    return _bound(nbytes, ops, dtype_name)


def attention_bwd_bound(b, h, t, dh, m, dtype_name):
    """Least time for the backward: Q, K, V, dO and E read once, dQ, dK,
    dV and dE written once, or its eight d_h-long products per visible
    pair (S's two, dP, dV, dQ's two, dK, dE) over the peak rate."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (7 * b * h * t * dh + 2 * h * (2 * m - 1) * dh) * item
    ops = 8 * 2 * dh * _visible_pairs(t, m, t) * b * h
    return _bound(nbytes, ops, dtype_name)


def dtw_bound(n1, n2, t1, item):
    """Least time for the DTW: the valid cost cells read once, the lengths
    read and the alignment and costs written once, or four f32 operations
    (three compares and an add) per valid cell over the f32 peak."""
    cells = int(np.sum(n1.astype(np.int64) * n2))
    k = len(n1)
    nbytes = cells * item + 8 * k + 4 * k * t1 + 4 * k
    return _bound(nbytes, 4 * cells, "float32")


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


def build_examples(rng, target_frames=22000, silent_fraction=0.3,
                   max_len=800):
    """Synthetic utterances up to ``target_frames`` frames, about 30%
    silent (own copy of the JAX package's ``bench.py`` generator)."""
    examples = []
    total = 0
    while total < target_frames:
        t = int(rng.uniform(max_len * 3 // 8, max_len))
        silent = rng.uniform() < silent_fraction
        ex = {
            "emg": rng.normal(size=(t, 112)).astype(np.float32),
            "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
            "session_ids": np.zeros(t, dtype=np.int64),
            "silent": silent,
            "text": "benchmark",
            "text_int": rng.integers(0, 37, size=40).astype(np.int64),
        }
        if silent:
            tt = int(t * rng.uniform(0.9, 1.15))
            ex["parallel_voiced_audio_features"] = rng.normal(
                size=(tt, 80)).astype(np.float32)
            ex["parallel_voiced_emg"] = rng.normal(
                size=(tt, 112)).astype(np.float32)
            ex["phonemes"] = rng.integers(0, 48, size=tt).astype(np.int64)
        else:
            ex["audio_features"] = rng.normal(size=(t, 80)).astype(
                np.float32)
            ex["phonemes"] = rng.integers(0, 48, size=t).astype(np.int64)
        examples.append(ex)
        total += t
    return examples


def device_profile(card, what, fn):
    """Run ``fn`` once under the profiler; log wall time, device busy time,
    idle share and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    if busy == 0:
        log(f"[profile] {what}: device time not measured: the profiler saw "
            f"no CUDA activity")
        return
    log(f"[profile] {card} | {what} under the profiler: wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall_ms:.1%}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {ms:8.3f} ms {ms / busy:6.1%}  {name[:100]}")


def check_kernels():
    """Phase 2: every kernel against its plain version on the card."""
    import torch
    from silent_speech_tpu_torch.ops.dtw import (
        dtw_align_batch, dtw_align_batch_plain)
    from silent_speech_tpu_torch.ops.rel_attention import (
        attention_drop_threshold, rel_attention, rel_attention_bwd,
        rel_attention_plain)

    drop = attention_drop_threshold(0.2)
    train_case = (*TRAIN_BT, drop)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        cases = [(b, t, valid_len, 0) for b, t, valid_len in KERNEL_CASES]
        cases += [(b, t, t, drop) for b, t in DROP_CASES]
        for b, t, valid_len, thresh in cases:
            q, k, v, e = attention_inputs(b, t, dtype, seed=t + valid_len)
            out = rel_attention(q, k, v, e, 100, valid_len, 11, thresh)
            torch.cuda.synchronize()
            ref = rel_attention_plain(q, k, v, e, 100, valid_len, 11, thresh)
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= KERNEL_ATOL[name]
            log(f"[kernel] rel_attention_fwd {name} B={b} T={t} "
                f"L={valid_len} dropout {'0.2' if thresh else '0'}: "
                f"max_abs_err {err:.3g} (tolerance {KERNEL_ATOL[name]}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"rel_attention_fwd disagrees with its "
                                     f"plain version: {name} B={b} T={t}")
            if (b, t, thresh) == train_case:
                errs[("rel_attention_fwd", name)] = err

        for b, t, thresh in ((4, 200, 0), (4, 200, drop), train_case):
            q, k, v, e = attention_inputs(b, t, dtype, seed=5)
            g = torch.Generator(device="cuda").manual_seed(6)
            dout = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
            grads = rel_attention_bwd(q, k, v, e, dout, 100, None, 13,
                                      thresh)
            torch.cuda.synchronize()
            xs = [x.detach().requires_grad_() for x in (q, k, v, e)]
            rel_attention_plain(*xs, 100, None, 13, thresh).backward(dout)
            case_err = 0.0
            for gname, ours, x in zip(("dQ", "dK", "dV", "dE"), grads, xs):
                err = (ours.float() - x.grad.float()).abs().max().item()
                tol = BWD_RTOL[name] * x.grad.float().abs().max().item()
                ok = ours.dtype == x.dtype and err <= tol
                log(f"[kernel] rel_attention_bwd {name} B={b} H=8 T={t} "
                    f"d_h=96 m=100 dropout {'0.2' if thresh else '0'} "
                    f"{gname}: max_abs_err {err:.3g} (tolerance {tol:.3g} "
                    f"= {BWD_RTOL[name]} x max|ref|) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"rel_attention_bwd disagrees with "
                                         f"autograd: {name} B={b} {gname}")
                case_err = max(case_err, err)
            if (b, t, thresh) == train_case:
                errs[("rel_attention_bwd", name)] = case_err
            del q, k, v, e, dout, grads, xs

    # DTW at prof_dtw.py's shape; utterances 0-3 are the n ∈ {1, 2} edges
    rng = np.random.default_rng(SEED)
    costs = torch.from_numpy(rng.uniform(0.1, 2.0, size=(16, 1024, 1024))
                             .astype(np.float32)).cuda()
    n1 = rng.integers(600, 1000, size=16)
    n2 = rng.integers(600, 1000, size=16)
    n1[:4], n2[:4] = (1, 1, 2, 2), (1, 2, 1, 2)
    n1, n2 = (torch.from_numpy(x).int().cuda() for x in (n1, n2))
    for dtype in (torch.float32, torch.bfloat16):
        c = costs.to(dtype)
        align, cost = dtw_align_batch(c, n1, n2)
        dp_align, dp_cost = dtw_align_batch(c, n1, n2, dp_only=True)
        torch.cuda.synchronize()
        ref_align, ref_cost = dtw_align_batch_plain(c, n1, n2)
        mismatched = int((align != ref_align).any(1).sum())
        finite = torch.isfinite(ref_cost)
        same_inf = bool((torch.isfinite(cost) == finite).all())
        rel = ((cost - ref_cost).abs()[finite]
               / ref_cost.abs()[finite].clamp_min(1e-30)).max().item()
        dp_same = bool((dp_cost == cost).all()) and int(dp_align.abs().sum()) \
            == 0
        ok = mismatched == 0 and same_inf and rel <= 1e-5 and dp_same
        log(f"[kernel] dtw_align {str(dtype)[6:]} K=16 T=1024 n in [600, "
            f"1000) + n in {{1, 2}}: alignment rows differing {mismatched}, "
            f"path cost max rel err {rel:.3g} (tolerance 1e-5), dp_only "
            f"cost equal and alignment zero: {dp_same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("dtw_align disagrees with its plain version")
    return errs


def serve(card, work):
    """Phase 3 (and its timings): full-width models served over HTTP."""
    import torch
    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.eval import export
    from silent_speech_tpu_torch.eval.server import ServingServer
    from silent_speech_tpu_torch.models import transformer
    from silent_speech_tpu_torch.models.encoder import EMGEncoder
    from silent_speech_tpu_torch.ops.rel_attention import rel_attention_plain

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

        reset_launches()
        latency, replies = {}, {}
        for t, route, body in requests:
            for rep in range(1 + TIMED_REQUESTS):
                t0 = time.perf_counter()
                reply = post(server.port, route, body)
                if rep:
                    latency.setdefault((route, t), []).append(
                        time.perf_counter() - t0)
            replies[(route, t)] = reply
        launches = read_launches()
        n_requests = len(requests) * (1 + TIMED_REQUESTS)
        layers = bundles["transduction"].model.cfg.num_layers
        log(f"[serve] {n_requests} requests, launches {launches}")
        if launches != {"rel_attention_fwd": layers * n_requests,
                        "rel_attention_bwd": 0, "dtw_align": 0,
                        "dtw_align_dp_only": 0}:
            raise AssertionError(
                f"expected {layers} forward attention launches per request "
                f"and no other kernel, got {launches} for {n_requests}")

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
        with swapped(transformer, "rel_attention", rel_attention_plain):
            plain = {
                "/v1/transduce": bundles["transduction"].predict(
                    emg, raw, np.zeros(t_cmp, np.int64)),
                "/v1/recognize": bundles["recognition"].predict(emg, raw)}
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

        for (route, t), samples in sorted(latency.items()):
            bucket = next(b for b in BUCKETS if t <= b)
            log(f"[time] {card} | {route} bucket {bucket} (t={t}): request "
                f"p50 {median_ms(samples):.2f} ms over {len(samples)}")
        bundle = bundles["transduction"]
        for t in REQUEST_T:
            bucket = next(b for b in BUCKETS if t <= b)
            emg, raw = utterance(t, seed=SEED + t)
            bundle.predict(emg, raw, np.zeros(t, np.int64))
            samples = []
            for _ in range(TIMED_REQUESTS):
                t0 = time.perf_counter()
                bundle.predict(emg, raw, np.zeros(t, np.int64))
                samples.append(time.perf_counter() - t0)
            log(f"[time] {card} | transduction predict() bucket {bucket}: "
                f"p50 {median_ms(samples):.2f} ms (forward incl. host "
                f"copies, no HTTP/JSON)")
        device_profile(card, f"transduction predict() bucket {bucket}",
                       lambda: bundle.predict(emg, raw,
                                              np.zeros(t, np.int64)))
    finally:
        if server is not None:
            server.stop()
    return launches


@contextlib.contextmanager
def swapped(module, name, fn):
    """Replace the module global ``module.name`` with ``fn`` in the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def reset_launches():
    from silent_speech_tpu_torch.ops.dtw import dtw_align_batch
    from silent_speech_tpu_torch.ops.rel_attention import (
        rel_attention, rel_attention_bwd)

    rel_attention.launches = rel_attention_bwd.launches = 0
    dtw_align_batch.launches = dtw_align_batch.dp_only_launches = 0


def read_launches():
    from silent_speech_tpu_torch.ops.dtw import dtw_align_batch
    from silent_speech_tpu_torch.ops.rel_attention import (
        rel_attention, rel_attention_bwd)

    return {"rel_attention_fwd": rel_attention.launches,
            "rel_attention_bwd": rel_attention_bwd.launches,
            "dtw_align": dtw_align_batch.launches,
            "dtw_align_dp_only": dtw_align_batch.dp_only_launches}


def train(card):
    """Phase 4: full-width training steps through the kernels, the eval
    step, and the f32 step against its plain twin. Returns the main path's
    launches, the steps/s trials, and the inputs the timings use."""
    import torch
    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.models import transformer
    from silent_speech_tpu_torch.ops.dtw import (
        dtw_align_batch, dtw_align_batch_plain)
    from silent_speech_tpu_torch.ops.rel_attention import rel_attention_plain
    from silent_speech_tpu_torch.train import losses
    from silent_speech_tpu_torch.train.schedule import warmup_lr
    from silent_speech_tpu_torch.train.transduction import (
        TransductionTrainer)

    trainer = TransductionTrainer()
    model = trainer.init_state(SEED)
    cfg = trainer.train_cfg
    t0 = time.perf_counter()
    batches = [trainer._pack(build_examples(np.random.default_rng(i)))
               for i in range(4)]
    log(f"[train] {sum(p.numel() for p in model.parameters())} parameters, "
        f"bf16 compute, dropout {trainer.model_cfg.dropout}, shift "
        f"{trainer.model_cfg.shift_augment}, moments "
        f"{cfg.moment_dtype}; 4 batches packed in "
        f"{time.perf_counter() - t0:.2f} s: raw {batches[0].raw_emg.shape}, "
        f"utterances x frames {batches[0].utt_gather_idx.shape}, "
        f"silent slices {[b.num_silent for b in batches]}")
    for b in batches:
        if b.raw_emg.shape != (120, 1600, 8) \
                or b.utt_gather_idx.shape != (64, 1024):
            raise AssertionError(f"packed shape {b.raw_emg.shape}, "
                                 f"{b.utt_gather_idx.shape}")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    n_steps = WARMUP_STEPS + sum(TRIAL_STEPS)
    order = [batches[i % len(batches)] for i in range(n_steps)]
    reset_launches()
    step_losses, trials, step = [], [], 0
    for trial, n in enumerate((WARMUP_STEPS, *TRIAL_STEPS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = trainer.train_step(order[step], warmup_lr(
                step, cfg.learning_rate, cfg.learning_rate_warmup))
            step_losses.append(out.loss)
            step += 1
        torch.cuda.synchronize()
        if trial:  # trial 0 is the warm-up
            trials.append(n / (time.perf_counter() - t0))
    launches = read_launches()
    layers = trainer.model_cfg.num_layers
    expected = {"rel_attention_fwd": layers * n_steps,
                "rel_attention_bwd": layers * n_steps,
                "dtw_align": sum(1 for b in order if b.num_silent),
                "dtw_align_dp_only": 0}  # a timing mode, off the path
    log(f"[train] {n_steps} steps, launches {launches} (expected "
        f"{expected})")
    if launches != expected or not all(expected[k] for k in (
            "rel_attention_fwd", "rel_attention_bwd", "dtw_align")):
        raise AssertionError(f"training launches {launches}, expected "
                             f"{expected}, each kernel of the path above 0")
    loss_values = torch.stack(step_losses).cpu().numpy()
    log(f"[train] losses {np.round(loss_values, 4).tolist()}")
    if not np.isfinite(loss_values).all():
        raise AssertionError("a training loss is not finite")
    after = model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    stats = [k for k in before if k.endswith(("running_mean",
                                              "running_var"))]
    weights = [k for k, _ in model.named_parameters()]
    log(f"[train] {len([k for k in moved if k in weights])}/{len(weights)} "
        f"parameter tensors and {len([k for k in moved if k in stats])}/"
        f"{len(stats)} BatchNorm statistics changed")
    if not set(stats) <= set(moved) or not any(k in moved for k in weights):
        raise AssertionError("the step did not move the weights and the "
                             "BatchNorm statistics")

    ev = trainer.eval_step(batches[0])
    total = int(ev.total_length)
    ev_ok = (np.isfinite(ev.loss.item()) and ev.confusion.shape == (48, 48)
             and int(ev.confusion.sum().item()) == total
             and 0 <= int(ev.correct_phones) <= total)
    log(f"[train] eval step: loss {ev.loss.item():.4f}, phoneme accuracy "
        f"{int(ev.correct_phones) / total:.4f} over {total} frames, "
        f"confusion sums to the frames: {ev_ok}")
    if not ev_ok:
        raise AssertionError("eval step output is malformed")

    def one_step():
        trainer.train_step(order[0], cfg.learning_rate)

    device_profile(card, "one bf16 training step (B=120 chunks x 200)",
                   one_step)
    del trainer, model, before, after
    torch.cuda.empty_cache()

    # the f32 step with the kernels, then with the plain versions swapped in
    batch = batches[0]
    captured = {}

    def capture(costs, n1, n2, **kw):
        captured["args"] = (costs.clone(), n1.clone(), n2.clone())
        return dtw_align_batch(costs, n1, n2, **kw)

    swaps = {"kernels": [(losses, "dtw_align_batch", capture)],
             "plain": [(losses, "dtw_align_batch", dtw_align_batch_plain),
                       (transformer, "rel_attention", rel_attention_plain)]}
    runs = {}
    for mode, mode_swaps in swaps.items():
        tr = TransductionTrainer(ModelConfig(compute_dtype="float32"))
        tr.init_state(SEED)
        with contextlib.ExitStack() as stack:
            for swap in mode_swaps:
                stack.enter_context(swapped(*swap))
            out = tr.train_step(batch, cfg.learning_rate)
        params = dict(tr.model.named_parameters())
        runs[mode] = (out, {n: params[n].grad.detach().clone()
                            for n in COMPARED_GRADS})
        del tr, params
        torch.cuda.empty_cache()
    (k_out, k_grads), (p_out, p_grads) = runs["kernels"], runs["plain"]
    rel = abs(k_out.loss.item() - p_out.loss.item()) / abs(p_out.loss.item())
    ns = batch.num_silent
    rows = int((k_out.alignment[:ns] != p_out.alignment[:ns]).any(1).sum())
    costs, n1, n2 = captured["args"]
    same_costs = dtw_align_batch_plain(costs, n1, n2)[0]
    k_align = k_out.alignment[:ns].int()
    dtw_rows = int((k_align != same_costs).any(1).sum())
    log(f"[train] f32 step, kernels vs plain: loss {k_out.loss.item():.6f} "
        f"vs {p_out.loss.item():.6f}, rel err {rel:.3g} (tolerance "
        f"{STEP_LOSS_RTOL}); DTW rows differing between the two runs "
        f"{rows} of {ns}; kernel vs plain DTW on the run's own costs: "
        f"{dtw_rows} rows differ (must be 0)")
    if not rel <= STEP_LOSS_RTOL or dtw_rows:
        raise AssertionError("the f32 step with the kernels disagrees with "
                             "the plain versions")
    for name in COMPARED_GRADS:
        err = (k_grads[name] - p_grads[name]).abs().max().item()
        tol = STEP_GRAD_RTOL * p_grads[name].abs().max().item()
        log(f"[train]   grad {name}: max_abs_err {err:.3g} (tolerance "
            f"{tol:.3g} = {STEP_GRAD_RTOL} x max|ref|) "
            f"{'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            raise AssertionError(f"gradient of {name} disagrees")
    log(f"[time] {card} | train step bf16 full width: "
        f"{np.round(trials, 3).tolist()} steps/s over trials of "
        f"{list(TRIAL_STEPS)} steps, median {float(np.median(trials)):.3f} "
        f"steps/s")
    return launches, trials, (costs, n1, n2)


def time_kernels(card, train_launches, serve_launches, errs, dtw_inputs):
    """Phase 5, kernels: ms per launch at the main path's shapes, against
    the bound and the plain version. Returns the kernels JSON entries."""
    import torch
    from silent_speech_tpu_torch.ops.dtw import (
        dtw_align_batch, dtw_align_batch_plain)
    from silent_speech_tpu_torch.ops.rel_attention import (
        attention_drop_threshold, rel_attention, rel_attention_bwd,
        rel_attention_plain)

    drop = attention_drop_threshold(0.2)
    for t in (256, 1024, 2048):
        q, k, v, e = attention_inputs(1, t, torch.bfloat16, seed=7)
        ms = cuda_time_ms(lambda: rel_attention(q, k, v, e, 100, t))
        plain_ms = cuda_time_ms(
            lambda: rel_attention_plain(q, k, v, e, 100, t), iters=10)
        bound_ms, bound_by = attention_bound(1, 8, t, 96, 100, t,
                                             "bfloat16")
        log(f"[time] {card} | rel_attention_fwd bf16 B=1 H=8 T={t} d_h=96 "
            f"m=100 (serving): kernel {ms:.4f} ms/launch, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"{bound_ms / ms:.2%} of bound")
        if t == HEADLINE_T:
            serve_ms = ms

    b, t = TRAIN_BT
    q, k, v, e = attention_inputs(b, t, torch.bfloat16, seed=8)
    fwd_ms = cuda_time_ms(
        lambda: rel_attention(q, k, v, e, 100, None, 3, drop), iters=20)
    fwd_plain = cuda_time_ms(
        lambda: rel_attention_plain(q, k, v, e, 100, None, 3, drop),
        iters=5)
    fwd_bound = attention_bound(b, 8, t, 96, 100, t, "bfloat16")
    g = torch.Generator(device="cuda").manual_seed(9)
    dout = torch.randn(q.shape, device="cuda", generator=g).to(q.dtype)
    bwd_ms = cuda_time_ms(
        lambda: rel_attention_bwd(q, k, v, e, dout, 100, None, 3, drop),
        iters=10)
    xs = [x.detach().requires_grad_() for x in (q, k, v, e)]
    out = rel_attention_plain(*xs, 100, None, 3, drop)
    bwd_plain = cuda_time_ms(lambda: torch.autograd.grad(
        out, xs, dout, retain_graph=True), iters=3)
    del out, xs
    bwd_bound = attention_bwd_bound(b, 8, t, 96, 100, "bfloat16")
    for name, ms, plain_ms, (bound_ms, bound_by) in (
            ("rel_attention_fwd", fwd_ms, fwd_plain, fwd_bound),
            ("rel_attention_bwd", bwd_ms, bwd_plain, bwd_bound)):
        log(f"[time] {card} | {name} bf16 B={b} H=8 T={t} d_h=96 m=100 "
            f"dropout 0.2 (training): kernel {ms:.4f} ms/launch, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"{bound_ms / ms:.2%} of bound")

    costs, n1, n2 = dtw_inputs
    costs = costs.to(torch.bfloat16)  # stored as the bf16 step stores it
    kk, t1, _ = costs.shape
    align, cost = dtw_align_batch(costs, n1, n2)
    dp_align, dp_cost = dtw_align_batch(costs, n1, n2, dp_only=True)
    ref_align, ref_cost = dtw_align_batch_plain(costs, n1, n2)
    dtw_err = (cost - ref_cost).abs().max().item()
    dp_err = (dp_cost - ref_cost).abs().max().item()
    rows = int((align != ref_align).any(1).sum())
    log(f"[kernel] dtw_align bf16 costs K={kk} T={t1} (the training batch's "
        f"silent slice): alignment rows differing {rows}, path cost "
        f"max_abs_err {dtw_err:.3g}, dp_only {dp_err:.3g} (tolerance 1e-5 "
        f"relative)")
    if rows or int(dp_align.abs().sum()) or not max(dtw_err, dp_err) <= (
            1e-5 * ref_cost.abs().max().item()):
        raise AssertionError("dtw_align disagrees with its plain version on "
                             "the training batch's costs")
    dtw_ms = cuda_time_ms(lambda: dtw_align_batch(costs, n1, n2), iters=10)
    dp_ms = cuda_time_ms(lambda: dtw_align_batch(costs, n1, n2,
                                                 dp_only=True), iters=10)
    dtw_plain = cuda_time_ms(lambda: dtw_align_batch_plain(costs, n1, n2),
                             iters=1, warmup=1)
    dp_plain = cuda_time_ms(lambda: dtw_align_batch_plain(
        costs, n1, n2, dp_only=True), iters=1, warmup=1)
    dtw_b = dtw_bound(n1.cpu().numpy(), n2.cpu().numpy(), t1, 2)
    log(f"[time] {card} | dtw_align bf16 costs K={kk} T={t1} (the training "
        f"batch's silent slice, n1 {n1.tolist()}, n2 {n2.tolist()}): "
        f"kernel {dtw_ms:.4f} ms/launch, dp_only {dp_ms:.4f} ms "
        f"(backtrace share {1 - dp_ms / dtw_ms:.1%}), plain {dtw_plain:.2f} "
        f"ms, plain dp_only {dp_plain:.2f} ms, bound {dtw_b[0]:.5f} ms "
        f"({dtw_b[1]}), {dtw_b[0] / dtw_ms:.2%} of bound")

    shape = f"B={b} H=8 T={t} d_h=96 m=100 bf16 dropout 0.2"

    def launches(name):
        return {"launches": serve_launches[name] + train_launches[name],
                "launches_by_path": {"serve": serve_launches[name],
                                     "train": train_launches[name]}}

    return [
        {"name": "rel_attention_fwd", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/rel_attention_fwd.cu",
         "replaces": "silent_speech_tpu/ops/pallas/rel_attention.py:386",
         "shape": shape, **launches("rel_attention_fwd"),
         "max_abs_err": errs[("rel_attention_fwd", "bfloat16")],
         "max_abs_err_f32": errs[("rel_attention_fwd", "float32")],
         "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1], "library_ms": None,
         "serve_ms_T1024": serve_ms},
        {"name": "rel_attention_bwd", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/rel_attention_bwd.cu",
         "replaces": "silent_speech_tpu/ops/pallas/rel_attention.py:414",
         "shape": shape, **launches("rel_attention_bwd"),
         "max_abs_err": errs[("rel_attention_bwd", "bfloat16")],
         "max_abs_err_f32": errs[("rel_attention_bwd", "float32")],
         "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], "library_ms": None},
        {"name": "dtw_align", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/dtw.cu",
         "replaces": "silent_speech_tpu/ops/pallas/dtw_kernel.py:209",
         "shape": f"K={kk} T={t1} bf16 costs", **launches("dtw_align"),
         "max_abs_err": dtw_err,
         "ms": dtw_ms, "plain_ms": dtw_plain, "bound_ms": dtw_b[0],
         "bound_by": dtw_b[1], "library_ms": None},
        {"name": "dtw_align_dp_only", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/dtw.cu",
         "replaces": "tools/prof_dtw.py:136",
         "shape": f"K={kk} T={t1} bf16 costs",
         **launches("dtw_align_dp_only"), "on_main_path": False,
         "max_abs_err": dp_err,
         "ms": dp_ms, "plain_ms": dp_plain, "bound_ms": dtw_b[0],
         "bound_by": dtw_b[1], "library_ms": None},
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import silent_speech_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        raise RuntimeError(f"silent_speech_tpu_torch resolved outside the "
                           f"checkout: {port.__file__}")
    from silent_speech_tpu_torch.ops import build
    from silent_speech_tpu_torch.utils.device import card_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info("cuda")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

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
    errs = check_kernels()

    # 3. serve -------------------------------------------------------------
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT,
                                                                   "build"))
    try:
        serve_launches = serve(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 4. train -------------------------------------------------------------
    train_launches, _, dtw_inputs = train(card)

    # 5. kernel timings ----------------------------------------------------
    kernels = time_kernels(card, train_launches, serve_launches, errs,
                           dtw_inputs)
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the card was "
        f"found")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
