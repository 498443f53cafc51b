#!/usr/bin/env python3
"""Drive the PyTorch port (``silent_speech_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. build every CUDA kernel from ``silent_speech_tpu_torch/csrc`` with nvcc,
   one process per source, all started together, and beside them the
   port's native library (the beam search and the FLAC decoder) with g++;
2. hold each kernel against its plain PyTorch version on the card: the
   attention forward (bf16 runs one WMMA kernel, f32 the f32 one; serving
   shapes and the training shapes with dropout, the recognition
   micro-step's B=64 among them; two bf16 calls at the transduction
   training shape must be bit-equal), the attention backward (bf16 and
   f32, dropout off and on, also at B=64; each dtype runs four staged
   kernels, bf16 on the tensor cores (WMMA), f32 on the CUDA cores with
   register-tiled FP32 products and f32 scratch; two calls at the training
   shape must be bit-equal in each dtype) and the DTW alignment with its
   DP-only mode (prof_dtw's shape with the n ∈ {1, 2} edge cases, T2 =
   1001 and integer costs with many exact ties; bf16 and f32) and the
   CTC forward and backward (optax's clamped lattice, ``csrc/ctc.cu``) at
   a recognition micro-step's shape with padding rows, a repeat and a last
   label of 0, with and without an infeasible row, and at the kernels'
   staging edges (rows of 1, F - 1, F, F + 1 frames of either kernel's
   chunk, 0 to 128 labels across the warp edges); two calls must be
   bit-equal, the gradient exactly 0 past each row's frames and exactly
   −weight at each live frame's blank on a row without labels; and the
   zero-phase
   filter chain (``csrc/filtfilt.cu``: seven notches and the 2 Hz
   high-pass in one launch) at 8 utterances x 8 channels of ragged lengths
   (one at the high-pass's padlen + 1), torch.equal to its plain version
   on the card, in one launch and split in two, and between two calls;
   and the attention kernels on a shard of a batch (rows 6.., heads 8.. of
   16, the dropout cells offset as a data and a model rank offset them):
   the shard's forward and dQ, dK, dV torch.equal to the whole batch's
   slices, each output against the plain version with the same offsets,
   and the default offsets torch.equal to (0, 0, H), bf16 and f32;
3. serve: init a full-width transduction model and a full-width
   recognition model from a seed, save each as a reference-layout
   ``model.pt``, export both with the export CLI, load the bundles on the
   card, start the HTTP server and answer transduce and recognize requests
   in every bucket. Every kernel's launch count is zeroed just before and
   read just after; the forward kernel must launch 6 times a request.
   Outputs are checked for shape and finiteness, against the same bundle
   with the plain attention on the card, and (f32) against the CPU. The
   transduction bundle carries a mel normalizer (the export CLI's
   ``--normalizers_file``); a full V1 HiFi-GAN generator from a seed is
   written as an official checkpoint (weight-norm pairs, ``config.json``),
   loaded through ``Vocoder``, held in f32 against itself on the CPU,
   bundled with mel buckets up to 2048 (JAX's default buckets refuse the
   1500-frame request) and attached to a second server: each vocoded
   ``/v1/transduce`` returns audio of T·256 samples, finite, within ±1 and
   equal to ``vocode(denormalize(mel))`` computed here, with 6 forward
   attention launches a request. Int8: both ``model.pt`` files exported
   again with ``--export_int8`` and loaded on the card, the quantized
   weights int8 CUDA tensors, the resident bytes of each bundle
   (``torch.cuda.memory_allocated`` around the load) printed beside the
   bf16 bundle's; every bucket served over HTTP from the int8 bundles with
   6 forward attention launches a request, each output torch.equal to a
   bf16 bundle of ``dequantize_state(quantize_state(state))`` and within
   a relative error of 0.05 of the bf16 bundle's;
4. train: a full-width transduction trainer (bf16 compute, dropout 0.2,
   shift augmentation, AdamW with bf16 moments) takes 2 warm-up and 10
   timed steps on the bench's 4 example sets packed on the host to the
   reference capacity (120 chunks of 200 frames, 64 utterances, t_cap
   1024), with the counts zeroed just before
   and read just after: 6 forward and 6 backward attention launches, 1
   DTW launch (when the batch has silent utterances) and 36 dropout
   launches (30 masks, 6 ReLU-dropout backwards; every training path
   counts them) and 36 BatchNorm launches (6 statistics, 12 finalizes, 6
   applies, 6 backward reductions and applies; 42 on a mesh; every
   training path counts them, the eval forward none) a step. Every loss is
   finite and the weights and BatchNorm statistics move. One eval step.
   Two steps from one state on one batch must give torch.equal gradients
   (the step runs under cuDNN's deterministic algorithms), and the step
   with cuDNN's default algorithms is timed against it in turns. Then one
   f32 step with the kernels against the same step with the plain
   versions swapped in (the attention, the DTW and the BatchNorm
   composition; same seeds, so the same dropout masks), and the
   ``--compute_dtype float32`` path timed: one warm-up step and 3 steps
   (ms a step), their launches counted (6 K1f and 6 K1b a step on the f32
   routes: the kernels line's ``f32-train`` path; every step with TF32 off,
   counted by ``utils.device.full_fp32``), then one step under the
   profiler (K1b f32's device ms in it);
5. the training run: the bench's device corpus of 4 example sets on the
   card (``silent_speech_tpu_torch/bench.py``), one batch gathered there
   held bit-equal to the upload of the same batch packed on the host, the
   bench's measurement (its JSON line printed) and ``train_step_ids``
   beside ``train_step`` with host packing (steps/s and idle share, in
   one call); ``fit()`` for 2 epochs with validation into a directory
   under ``build/`` (the idle share of its whole window, and of each
   epoch's steps and loss read alone), ``model.pt`` loaded
   strictly, a resume for a 3rd epoch whose state before its first step
   must equal the saved one; the counts zeroed before the first fit and
   read after the resume: every step on the device-corpus path, 6 forward
   and 6 backward attention launches and 1 DTW a step, 6 forward and 1
   DTW a validation batch (each with silent utterances for the DTW). Then
   ``get_aligned_prediction`` of a silent utterance: 6 forward attention
   launches at B=1 and one DTW at K=1 whose alignment equals the plain
   version's;
6. recognition: the same 4 sets with each text spelled from its character
   ids, a validation set, a bigram ARPA LM of the training texts (written
   here) and the native beam search (built in 1); a full-width recognizer
   (38 outputs, bf16, dropout 0.2, shift, gradient accumulation 2, 64
   chunks of 200) prints its micro-steps/s on the device corpus and,
   under the profiler, device busy per micro-step and per update and the
   idle share; two
   micro-steps from one state on one batch must give equal losses and
   torch.equal gradients (one CTC forward and backward each); ``fit()``
   for 2 epochs with beam-decoded validation WER, then a resumed 3rd epoch
   whose state before its first micro-step (accumulator included) must
   equal the saved one; the counts zeroed before the first fit and read
   after the resume: 6 forward and 6 backward attention launches and one
   CTC forward and backward a micro-step, 6 forward attention and no CTC
   a validation utterance; the weights must move at
   every second micro-step only; the native beam against the plain one on
   one utterance; an f32 micro-step with the kernels against the plain
   attention; the trained ``model.pt`` exported and one ``/v1/recognize``
   answered from it (6 forward launches);
6c. streaming at full width: phase 6's ``model.pt`` loaded strictly into
   the streaming recognizer, fed a seeded synthetic board in hops of a
   simulated clock; 6 forward attention launches a recompute, and the final
   transcript equal to the offline greedy decode of the same samples; the
   latency of a recompute at 5 s and 20 s buffers; the synthesizer (a
   full-width transducer from a seed, the seeded V1 vocoder) equal to the
   offline ``vocode(inverse(predict))``; ``python -m
   silent_speech_tpu_torch.eval.streaming --seconds 2 --model model.pt``
   exits 0;
6b. the vocoder: ``python -m silent_speech_tpu_torch.bench_vocoder``'s
   JSON line (full V1, batch 8 x 10 s); a full-width GAN trainer (V1
   generator, MPD 2/3/5/7/11 and a 3-scale MSD, batch 16 of 32-frame
   segments of wavs written under ``build/``) takes 2 warm-up and 3 timed
   steps (steps/s, then device busy a step and idle share under the
   profiler), every metric finite and both models moving, no ported kernel
   launched; from a saved state, a step repeated on one batch and the same
   step in a fresh trainer after ``load_state`` must equal the first, bit
   for bit;
7. from disk, through the entry points a user calls: the port's own
   generator writes a learnable FLAC corpus (2 voiced, 2 silent and 1
   non-parallel session of 4 utterances) under ``build/``;
   ``make_testset`` and ``make_normalizers`` run on it; the transduction
   CLI trains one epoch at the defaults (d=768, 6 layers, 8 heads), its
   corpus featurized on the card (one filter launch), with
   ``--hifigan_checkpoint`` at the seeded V1 generator: it writes
   ``model.pt``, the epoch's wav and every dev utterance's, and logs the
   absent ASR judge; ``featurize_on_device`` on the card is held to the
   host ``EMGDataset`` path and the corpus build is timed both ways in
   turns; every FLAC file of the corpus is decoded by the native decoder
   (the path of every corpus read) and by the plain Python one in turns,
   the samples equal, the seconds of each and their ratio printed beside
   the corpus build's; ``evaluate --models model.pt model.pt`` must give the numbers
   of ``model.pt`` alone (with the vocoder), with 2 x 6 forward attention
   launches an eval group, and one of its wavs must equal
   ``vocode(inverse(predict))`` computed here; the recognition CLI trains
   one epoch, its corpus featurized on the card (its
   validation WER printed as read) and ``--evaluate_saved`` scores its
   ``model.pt``; ``make_vocoder_trainset`` writes the aligned predictions
   of the training and dev utterances from the transduction CLI's
   ``model.pt`` (6 forward attention launches an utterance, one DTW a
   silent one), ``finetune_vocoder`` takes 2 steps on them from the seeded
   V1 checkpoint and resumes for a 3rd, and ``generator_finetuned.pt``
   vocodes one of the mels from a bundle; every CLI's launches are counted
   against its steps, validation batches and utterances, and the phase
   prints its wall time;
7b. capture: a book of three sentences under ``build/``; ``python -m
   silent_speech_tpu_torch.capture.session --debug`` records each from the
   synthetic board (Enter lines on its stdin, the book ends the session)
   and ``python -m silent_speech_tpu_torch.capture.clean_audio`` cleans
   it, both exit 0 on the host; every file's schema is checked; the
   port's ``EMGDataset`` reads the session and ``featurize_on_device``
   featurizes it on the card (one filter launch), held to the host path
   by phase 7's bounds; each utterance is served from phase 3's int8
   transduction bundle (6 forward attention launches each); the phase
   prints its wall time;
9. the mesh: a full-width transduction step on a 1x1 data x model mesh
   over a real NCCL process group torch.equal to the plain trainer's
   (loss, gradients, the state after the update), both timed in turns
   (steps/s, collectives a step; under the profiler, device busy and the
   host ops' self CPU time of a step);
   ``dryrun_multichip(torch.cuda.device_count(), full_width=True)``, the
   seven checks of the JAX dry run against one process, its lines printed
   as ``[mesh.dryrun]``; the process group destroyed; then ``entry()``'s
   full-width forward (6 forward attention launches) against the plain
   attention, and its time. The kernels line counts the launches of the
   mesh step and the dry run as ``mesh``, of ``entry()`` as ``entry``;
8. time the requests per bucket (mel-only as before, vocoded, and from
   the int8 bundles beside the bf16 ones), the forward and ``vocode()``
   per bucket (the int8 forward with and without its dequantization, and
   the dequantization alone; these serving timings run in phase 3, where
   the bundles are loaded), the training
   steps (median of 3 synced trials) and each kernel per launch at the
   main path's shapes against its bound and its plain version (the bf16
   attention forward also by its device time per launch under the
   profiler, the bf16 attention backward also stage by stage, the DTW's
   DP-only mode also in ns a diagonal and with its backtrace's share, both
   DTW modes also by device time per launch, the DTW also at
   get_aligned_prediction's K=1 f32 shape, both attention kernels also at
   the recognition micro-step's B=64 and in f32, the f32 backward also
   stage by stage and against its own bound, and PyTorch's
   scaled_dot_product_attention with the relative bias precomputed as a
   yardstick for the bf16 forward, not the same function and never
   called by the port), the CTC forward and backward on a recognition
   micro-step's own inputs (against ``F.ctc_loss`` forward and backward
   on its rows with text, timed as the library column, never called by
   the port), the filter chain at phase 7's corpus build's own inputs
   (saved to ``build/filtfilt_corpus_inputs.pt`` for ``python -m
   silent_speech_tpu_torch.ops.filtfilt_study``) and at S-corpus, a
   synthetic 256 MiB group of 512 utterances of up to 16,384 samples
   (its shortest and longest utterance held against the plain version in
   a worker process), both also in ns a step of the dependent chain
   and S-corpus against its scratch's traffic, both chain-bound kernels
   also against a latency bound (the chain's length times its dependent
   FP32 operations a step at the maximum SM clock), the dropout kernels
   (``csrc/dropout.cu``) at 24,000 token rows of widths 3072 and 768, bf16
   and f32, against their byte bound and the plain version, the AdamW
   kernels, the BatchNorm kernels (``csrc/batchnorm.cu``) at the first
   ResBlock's 120 x 768 x 800, bf16 and f32, forward and backward against
   their byte bound, the plain composition and ``F.batch_norm``'s, and
   profile one forward and one training step (device busy time, idle
   share, kernels by time).

The last lines are the card (``nvidia-smi`` name and power limit), one JSON
line describing each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import logging
import multiprocessing
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
TIMED_REQUESTS = 2                 # per kind and length, after one warm-up
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 tensor cores
            "float32": 67e12}      # f32 outside the tensor cores
# kernel vs plain: both compute in f32; a bf16 output may differ by one
# rounding step (2^-6 at |O| < 4), and the bf16 kernel rounds P' to bf16
# before ·V where the plain version does not
KERNEL_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
KERNEL_CASES = ((1, 256, 256), (1, 1024, 1024), (1, 2048, 2048),
                (1, 256, 37), (1, 64, 64))
TRAIN_BT = (120, 200)              # attention (B, T) of the training step
# a recognition micro-step's: 128,000 raw samples are 11,024 frames, 56 + 2
# chunks of 200, rounded up to the chunk bucket 8
REC_BT = (64, 200)
DROP_CASES = ((4, 200), TRAIN_BT, REC_BT, (1, 1024))  # (B, T), L = T
# backward vs autograd through the plain version, relative to each
# gradient's largest entry: f32 sums in another order (D, the band
# products by slices, dE as group partials summed in a fixed order); bf16
# rounds P', dS and dR to bf16 where the JAX kernel does, and each output
# once
BWD_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
HEADLINE_T = 1024
FWD_KERNEL = "::fwd_kernel("    # csrc/rel_attention_fwd_wmma.cu in a trace
DTW_KERNEL = "dtw_kernel<"       # csrc/dtw.cu in a trace
# a launch's device time from the profiler against the same call's queued
# CUDA events: no more than the events (5% for the spread of two runs), and
# no less than the events less the gap between two launches
PROFILE_AGREEMENT = (0.75, 1.05)
QUEUE_SLEEP_CYCLES = 100_000_000   # ~50 ms: longer than queueing 20 calls
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
F32_TIMED_STEPS = 3                # the float32 path's steps, after a warm-up
F32_BWD_KERNEL = "bwd_f32_"        # csrc/rel_attention_bwd.cu in a trace
F32_FWD_KERNEL = "::fwd_f32<"      # csrc/rel_attention_fwd.cu in a trace
COMPARED_GRADS = ("conv_blocks.0.conv1.weight",
                  "transformer.layers.0.self_attn.w_q",
                  "transformer.layers.5.self_attn.relative_positional"
                  ".embeddings",
                  "transformer.layers.3.linear1.weight", "w_out.weight",
                  "w_aux.weight")


FIT_EPOCHS = 2                     # then resumed for one more
DEV_FRAMES = 6000                  # the validation set: one eval batch
REC_PROFILED_STEPS = 8             # 4 updates at gradient accumulation 2
# CTC at a recognition micro-step: 64 utterance rows (19 real), t_cap frames,
# TEXT_CAP label positions, 38 classes
REC_CTC = dict(u=64, t=1024, s=128, n_real=19)
# where phase 6 saves the CTC inputs of its first micro-step
CTC_INPUTS = os.path.join(ROOT, "build", "ctc_micro_step_inputs.pt")
# where phase 7 saves its corpus build's filter-chain inputs
FILTER_INPUTS = os.path.join(ROOT, "build", "filtfilt_corpus_inputs.pt")
# CTC kernel vs plain: float32, the same operations; the NLL to 1e-6
# relative (an infeasible row's ~1e5 included), the gradient to 1e-5 of its
# largest entry (the backward's sums in another order)
# the dropout kernels' timing shape: the transduction step's token rows
DROPOUT_ROWS = 120 * 200
# the BatchNorm kernels' timing shape: a transduction micro-step's first
# ResBlock (B, C, L); the fused passes against the plain composition:
# outputs and input gradients by relative L2 (both round to the compute
# dtype; a few pre-activations within rounding of 0 take the other side of
# the ReLU, each ~3e-4 of the norm of a 120x768x200 tensor)
BN_TIMED = (120, 768, 800)
BN_L2 = 3e-3
# a channel's dβ and dγ against the sum of its terms' magnitudes, Σ|g| and
# Σ|g·x̂| (a flipped ReLU moves it by one term); running statistics by the
# largest error over the largest entry
BN_SUM_RTOL = 5e-4
BN_RUNNING_RTOL = 2e-5
CTC_NLL_RTOL = 1e-6
CTC_GRAD_RTOL = 1e-5
# the on-disk phase's corpus: the port's own generator, learnable signals,
# FLAC audio; then dev and test splits of DISK_SPLIT sentences each
DISK_CORPUS = dict(n_voiced_sessions=2, n_silent_sessions=2, n_nonparallel=1,
                   utterances_per_session=4, audio_format="flac",
                   learnable=True)
DISK_SPLIT = 3
# the filter chain's check: ragged lengths, one at the high-pass's padlen
# + 1 (3 x 4 taps + 1), several not a multiple of 32; the plain loop costs
# ~10 launches a step, so T stays short
FILTER_LENGTHS = [13, 1024, 1000, 777, 500, 31, 999, 1023]
FILTER_T = 1024
# the corpus featurized on the card against the host EMGDataset path: the
# float32 high-pass drifts from scipy's float64 in proportion to the
# signal. The JAX test's atol 5e-2 (tests/test_jax_featurize.py:72-83)
# holds on its noise corpus (max |raw| ~7); on this learnable corpus (max
# |raw| ~29) JAX's own featurize_on_device is 0.2016 from the host path
# and the port's 0.1954 (both on the CPU), so raw_emg is bound relative
# to the host signal's largest value, with the correlation of the
# port-vs-JAX bound; audio_features keep the JAX test's atol
HOST_RAW_REL, HOST_MIN_CORR, HOST_MEL_ATOL = 1e-2, 0.9999, 2e-2
# a wav read back against the audio it was written from: PCM16 truncates
# x * 32767 and reads back over 32768
WAV_ATOL = 2.0 / 32767
# streaming: hops of the simulated board clock, seconds streamed into the
# recognizer and the synthesizer, timed recomputes a buffer length
STREAM_HOP_S = 0.5
STREAM_SECONDS = 4.0
STREAM_SYNTH_SECONDS = 2.0
STREAM_TIMED = 3
# evaluate with model.pt twice against model.pt alone: the mean of two
# equal outputs is exact and every kernel of the eval forward is
# deterministic, so the loss to 1e-6 relative, accuracy and confusion equal
ENSEMBLE_RTOL = 1e-6
# the native and the plain beam search agree exactly at this width; at 100
# they can part on a near-tie of two prefixes (log1p against log of a sum)
REC_BEAM_CHECK = 16
# the vocoder bundle's mel buckets: up to 2048 frames, so that the
# 1500-frame request vocodes (JAX's default buckets stop at 1024)
VOCODER_BUCKETS = (128, 256, 512, 1024, 2048)
VOCODED_TIMED = 2                  # vocoded requests per length, after one
# the HiFi-GAN generator in f32 on the card vs on the CPU (TF32 off), on
# VOCODER_CPU_FRAMES frames: summation order only, at tanh outputs in ±1
VOCODER_ATOL = 1e-4
VOCODER_CPU_FRAMES = 64
# fault 12: the transduction step with cuDNN's default algorithms against
# the deterministic ones, in turns: rounds of steps per mode
AB_ROUNDS, AB_STEPS = 3, 3
# the GAN phase: the published batch of 16 segments of 32 frames, and
# wavs of the phase's own making
GAN_BATCH = 16
GAN_WARMUP, GAN_TIMED, GAN_PROFILED = 2, 3, 1
GAN_WAVS, GAN_WAV_SECONDS = 4, 2.0
# the capture phase: a book of three sentences, each recorded for
# CAPTURE_SECONDS from the synthetic board (one 256-frame bucket each)
CAPTURE_SENTENCES = ("The first sentence of the book.",
                     "A second one follows it.", "The third ends the book.")
CAPTURE_SECONDS = 1.5


# latency bounds of the two chain-bound kernels: the dependent chain's
# length times one step's dependent FP32 operations at DEP_CYCLES each (the
# issue-to-use latency of a dependent FP32 add or multiply on sm_80 and
# sm_90), at the card's maximum SM clock. A lower bound: a step's shared
# memory round trip, barrier and the rest of expf/log1pf's instruction
# sequences are not counted (each of those two counts as one operation).
DEP_CYCLES = 4
# csrc/filtfilt.cu df2t: z0 -> y = b0*e + z0 (add) -> a1*y (mul) -> z0' =
# (z1 + b1*e) - a1*y (sub); b0*e and z1 + b1*e are off the chain
FILT_DEP_OPS = 3
# csrc/ctc.cu forward, a frame: emit[n-1] + pen (add), lae (sub, expf,
# log1pf, add) = a, then a + le (add) and lae again = emit[n]
CTC_FWD_DEP_OPS = 10
# csrc/ctc.cu backward, a frame: g_emit -> g1 (mul) -> g_a (add) -> q =
# fma(g_a, e, g_c) -> to the neighbour, g_emit = g2 + q (add); the
# exponentials take stored states only
CTC_BWD_DEP_OPS = 4


def max_sm_clock_hz():
    """The card's maximum SM clock from nvidia-smi, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def latency_bound_ms(steps: int, dep_ops: int):
    """ms of ``steps`` dependent steps of ``dep_ops`` FP32 operations each
    at the card's maximum SM clock, or None without the clock."""
    hz = max_sm_clock_hz()
    return None if hz is None else steps * dep_ops * DEP_CYCLES / hz * 1e3


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


def ctc_bound(lp, utt_len, labels, text_len):
    """Least time for the CTC forward and backward on this run's data, and
    the bytes it counts: the log-probs of the live frames of rows with text
    read once (nothing else of them is needed), their labels, the counts
    and the NLL's cotangent read once, the dense (U, T, K) gradient and the
    NLL written once; or 61 f32 operations a live (frame, position) cell of
    a row with text over the f32 peak (``csrc/ctc.cu``: 24 forward, 35 in
    the backward's recursion, 2 in the gradient's sum; an exp or a log1p
    counted as one). The larger wins."""
    u, t, k = lp.shape
    frames = utt_len.long().clamp(0, t)
    text = text_len.long().clamp(0, labels.shape[1])
    live = text > 0
    nbytes = (4 * k * int(frames[live].sum()) + 4 * int(text.sum())
              + 3 * 4 * u + 4 * lp.numel() + 4 * u)
    cells = int((frames[live] * (text[live] + 1)).sum())
    return (*_bound(nbytes, 61 * cells, "float32"), nbytes)


def queued_ms(fn, iters: int = 20) -> float:
    """ms a call of ``fn`` by CUDA events, the calls queued behind a
    sleeping kernel so that the host's time per call does not show: the
    device's time for the call's launches and the gaps between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_per_launch(fn, kernel: str, launches: int = 20):
    """Median device time of one launch of the kernel whose profiler name
    contains ``kernel``: the kernel alone, where back-to-back launches from
    Python measure the host. ``fn`` launches that one kernel
    (``device_ms_by_kernel``)."""
    return device_ms_by_kernel(fn, (kernel,), launches)[kernel]


def device_ms_by_kernel(fn, kernels, launches: int = 20):
    """Median device time of each kernel named in ``kernels`` (substrings
    of the profiler's names) over ``launches`` calls of ``fn`` under the
    profiler; ``fn`` launches each once a call. A window's trace counts
    when every kernel shows in at least half the calls and the medians'
    sum lies within ``PROFILE_AGREEMENT`` of ``queued_ms`` of the same
    call: on the H100 machine a trace has come back empty, and once with
    launches of half their event-timed length. Up to 3 windows; each None
    (not measured) when none counts. Raises when no window saw a
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ref = queued_ms(fn)
    lo, hi = PROFILE_AGREEMENT
    seen = {k: 0 for k in kernels}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        times = {k: [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA and k in ev.name]
                 for k in kernels}
        for k, v in times.items():
            seen[k] += len(v)
        if not all(times.values()):
            continue
        medians = {k: float(np.median(v)) for k, v in times.items()}
        if (min(map(len, times.values())) >= launches // 2
                and lo * ref <= sum(medians.values()) <= hi * ref):
            return medians
        log(f"[profile] a trace of {', '.join(kernels)} refused: "
            f"{[len(v) for v in times.values()]} of {launches} launches, "
            f"medians {medians} ms against {ref:.4f} ms a call by queued "
            f"events")
    if not all(seen.values()):
        raise AssertionError(f"the profiler saw no launch of some of "
                             f"{', '.join(kernels)} in 3 windows: {seen}")
    log(f"[profile] device time of {', '.join(kernels)} not measured: no "
        f"trace agreed with the queued events")
    return {k: None for k in kernels}


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def sdpa_yardstick_ms(q, k, v, e) -> float:
    """ms of one ``scaled_dot_product_attention`` call on the same q, k, v,
    with the skewed relative logits and the band mask as one precomputed
    additive mask and no dropout: the nearest library call, timed as a
    yardstick only (it computes Q·Eᵀ and the skew outside the timer)."""
    import torch
    import torch.nn.functional as F

    b, h, t, _ = q.shape
    m = (e.shape[1] + 1) // 2
    with torch.no_grad():
        rel = torch.einsum("bhqd,hwd->bhqw", q.float(), e.float())
        pos = torch.arange(t, device=q.device)
        off = pos[None, :] - pos[:, None]
        bias = rel.gather(-1, (off + m - 1).clamp(0, 2 * m - 2).expand(
            b, h, t, t))
        bias = bias.masked_fill(off.abs() > m - 1, float("-inf")).to(q.dtype)
        del rel
    return cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias), iters=20)


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


def device_profile(card, what, fn, top=12, cpu=True, events=None):
    """Run ``fn`` once under the profiler; log wall time, device busy time
    (the union of the device events' intervals: kernels may overlap, as
    cuDNN's grouped convolutions do), idle share and the ``top`` kernels by
    device time, and return (wall ms, busy ms), or None when the profiler
    saw no device activity. ``cpu=False`` traces the card alone, which
    costs the host less. ``events``, a list, receives (name, start µs, end
    µs) of every device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if cpu else [])) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
            spans.append((ev.name, ev.time_range.start, ev.time_range.end))
    if events is not None:
        events.extend(spans)
    summed = sum(by_name.values())
    if summed == 0:
        log(f"[profile] {what}: device time not measured: the profiler saw "
            f"no CUDA activity")
        return None
    busy, reach = 0.0, -np.inf
    for _, start, end in sorted(spans, key=lambda e: e[1]):
        busy += max(0.0, end - max(start, reach)) / 1e3
        reach = max(reach, end)
    overlap = (f" (kernel times summed {summed:.3f} ms: kernels overlap)"
               if summed > 1.005 * busy else "")
    log(f"[profile] {card} | {what} under the profiler: wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms{overlap}, idle share "
        f"{1 - busy / wall_ms:.1%}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {ms:8.3f} ms {ms / summed:6.1%}  {name[:100]}")
    return wall_ms, busy


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
    rec_case = (*REC_BT, drop)
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
            err = unrounded = (out.float() - ref.float()).abs().max().item()
            bf16 = dtype == torch.bfloat16
            if bf16:  # the plain mirror of the kernel: P' to bf16 before ·V
                mirror = rel_attention_plain(q, k, v, e, 100, valid_len, 11,
                                             thresh, store_dtype=dtype)
                err = (out.float() - mirror.float()).abs().max().item()
            ok = max(err, unrounded) <= KERNEL_ATOL[name]
            log(f"[kernel] rel_attention_fwd {name} B={b} T={t} "
                f"L={valid_len} dropout {'0.2' if thresh else '0'}: "
                f"max_abs_err {err:.3g}"
                + (f", {unrounded:.3g} against the plain version with P' "
                   f"unrounded" if bf16 else "")
                + f" (tolerance {KERNEL_ATOL[name]}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"rel_attention_fwd disagrees with its "
                                     f"plain version: {name} B={b} T={t}")
            if (b, t, thresh) == rec_case:
                errs[("rel_attention_fwd_recognition", name)] = err
            if (b, t, thresh) == train_case:
                errs[("rel_attention_fwd", name)] = err
                errs[("rel_attention_fwd_unrounded", name)] = unrounded
                if bf16:
                    again = rel_attention(q, k, v, e, 100, valid_len, 11,
                                          thresh)
                    same = torch.equal(out, again)
                    log(f"[kernel] rel_attention_fwd bf16 B={b} H=8 T={t} "
                        f"dropout 0.2: two calls on the same inputs "
                        f"bit-equal: {same} {'ok' if same else 'FAIL'}")
                    if not same:
                        raise AssertionError("the bf16 attention forward "
                                             "is not deterministic")

        for b, t, thresh in ((4, 200, 0), (4, 200, drop), rec_case,
                             train_case):
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
                    if dtype == torch.bfloat16:
                        locate_bwd_stage(q, k, v, e, dout, thresh)
                    raise AssertionError(f"rel_attention_bwd disagrees with "
                                         f"autograd: {name} B={b} {gname}")
                case_err = max(case_err, err)
            if (b, t, thresh) == rec_case:
                errs[("rel_attention_bwd_recognition", name)] = case_err
            if (b, t, thresh) == train_case:
                errs[("rel_attention_bwd", name)] = case_err
                again = rel_attention_bwd(q, k, v, e, dout, 100, None, 13,
                                          thresh)
                same = all(torch.equal(x, y) for x, y in zip(grads, again))
                log(f"[kernel] rel_attention_bwd {name} B={b} H=8 T={t} "
                    f"dropout 0.2: two calls on the same inputs bit-equal "
                    f"in dQ, dK, dV and dE: {same} "
                    f"{'ok' if same else 'FAIL'}")
                if not same:
                    raise AssertionError(f"the {name} attention backward "
                                         f"is not deterministic")
                del again
            del q, k, v, e, dout, grads, xs

    # DTW at prof_dtw.py's shape (utterances 0-3 are the n ∈ {1, 2} edges),
    # at T2 = 1001 (rows not 16-byte aligned: scalar cost loads) and on
    # integer costs (many exact ties between up, left and diag)
    rng = np.random.default_rng(SEED)
    costs = torch.from_numpy(rng.uniform(0.1, 2.0, size=(16, 1024, 1024))
                             .astype(np.float32)).cuda()
    n1 = rng.integers(600, 1000, size=16)
    n2 = rng.integers(600, 1000, size=16)
    n1[:4], n2[:4] = (1, 1, 2, 2), (1, 2, 1, 2)
    n1, n2 = (torch.from_numpy(x).int().cuda() for x in (n1, n2))
    ties = torch.from_numpy(rng.integers(0, 3, size=(16, 1024, 1024))
                            .astype(np.float32)).cuda()
    dtw_cases = [("K=16 T=1024 n in [600, 1000) + n in {1, 2}", costs, n1,
                  n2),
                 ("K=16 T1=1000 T2=1001", costs[:, :1000, :1001]
                  .contiguous(), n1.clamp(max=1000), n2.clamp(max=1001)),
                 ("K=16 T=1024 integer costs in {0, 1, 2}", ties, n1, n2)]
    for label, case_costs, c_n1, c_n2 in dtw_cases:
        for dtype in (torch.float32, torch.bfloat16):
            c = case_costs.to(dtype)
            align, cost = dtw_align_batch(c, c_n1, c_n2)
            dp_align, dp_cost = dtw_align_batch(c, c_n1, c_n2, dp_only=True)
            torch.cuda.synchronize()
            ref_align, ref_cost = dtw_align_batch_plain(c, c_n1, c_n2)
            mismatched = int((align != ref_align).any(1).sum())
            finite = torch.isfinite(ref_cost)
            same_inf = bool((torch.isfinite(cost) == finite).all())
            rel = ((cost - ref_cost).abs()[finite]
                   / ref_cost.abs()[finite].clamp_min(1e-30)).max().item()
            dp_same = bool((dp_cost == cost).all()) and int(
                dp_align.abs().sum()) == 0
            ok = mismatched == 0 and same_inf and rel <= 1e-5 and dp_same
            log(f"[kernel] dtw_align {str(dtype)[6:]} {label}: alignment "
                f"rows differing {mismatched}, path cost max rel err "
                f"{rel:.3g} (tolerance 1e-5), dp_only cost equal and "
                f"alignment zero: {dp_same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"dtw_align disagrees with its plain "
                                     f"version: {label}")
    # prof_dtw's shape in bf16: the time scales with max(n1 + n2 - 1)
    c = costs.to(torch.bfloat16)
    diagonals = int((n1 + n2 - 1).max())
    ms = cuda_time_ms(lambda: dtw_align_batch(c, n1, n2), iters=10)
    dp_ms = cuda_time_ms(lambda: dtw_align_batch(c, n1, n2, dp_only=True),
                         iters=10)
    log(f"[time] dtw_align bf16 K=16 T=1024 n in [600, 1000) (prof_dtw's "
        f"shape, {diagonals} diagonals): kernel {ms:.4f} ms/launch, dp_only "
        f"{dp_ms:.4f} ms ({dp_ms * 1e6 / diagonals:.1f} ns a diagonal)")
    del c, costs, ties, dtw_cases
    check_ctc(errs)
    check_filtfilt(errs)
    return errs


# the attention kernels on a shard of the batch: rows b_offset.. and heads
# h_offset.. of a batch with H_total heads (parallel/: a data rank's
# chunks, a model rank's heads) at the training step's T and dropout
SHARD_CASE = dict(b=4, h_total=16, b_offset=6, h_offset=8)


def check_offsets(errs):
    """Phase 2, the dropout-cell offsets of K1f and K1b: a shard's forward
    and its dQ, dK, dV are torch.equal to the slice of the whole batch's
    (each (row, head) cell is computed alone), every output of the shard
    is held against the plain version with the same offsets, and a call
    with the defaults is torch.equal to one with (0, 0, H)."""
    import torch
    from silent_speech_tpu_torch.ops.rel_attention import (
        attention_drop_threshold, rel_attention, rel_attention_bwd,
        rel_attention_plain)

    drop = attention_drop_threshold(0.2)
    t, c = TRAIN_BT[1], SHARD_CASE
    b0, b, h0, ht = c["b_offset"], c["b"], c["h_offset"], c["h_total"]
    g = torch.Generator(device="cuda").manual_seed(21)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        whole = [torch.randn(b0 + b, ht, t, 96, device="cuda", generator=g)
                 for _ in range(4)]
        e_all = torch.randn(ht, 199, 96, device="cuda", generator=g) \
            * 96 ** -0.5
        q, k, v, dout = (x.to(dtype).contiguous() for x in whole)
        e = e_all.to(dtype).contiguous()
        rows, heads = slice(b0, b0 + b), slice(h0, h0 + 8)
        qs, ks, vs, ds = (x[rows, heads].contiguous()
                          for x in (q, k, v, dout))
        es = e[heads].contiguous()
        cells = dict(b_offset=b0, h_offset=h0, h_total=ht)
        out = rel_attention(qs, ks, vs, es, 100, t, 11, drop, **cells)
        full = rel_attention(q, k, v, e, 100, t, 11, drop)
        torch.cuda.synchronize()
        if not torch.equal(out, full[rows, heads]):
            raise AssertionError(f"rel_attention_fwd {name}: the shard's "
                                 f"output is not the whole batch's slice")
        ref = rel_attention_plain(
            qs, ks, vs, es, 100, t, 11, drop,
            store_dtype=dtype if dtype == torch.bfloat16 else None, **cells)
        err = (out.float() - ref.float()).abs().max().item()
        grads = rel_attention_bwd(qs, ks, vs, es, ds, 100, t, 11, drop,
                                  **cells)
        grads_full = rel_attention_bwd(q, k, v, e, dout, 100, t, 11, drop)
        for got, want in zip(grads[:3], grads_full[:3]):
            if not torch.equal(got, want[rows, heads]):
                raise AssertionError(f"rel_attention_bwd {name}: the "
                                     f"shard's dQ/dK/dV are not the whole "
                                     f"batch's slices")
        leaves = [x.detach().float().requires_grad_() for x in
                  (qs, ks, vs, es)]
        plain = rel_attention_plain(*leaves, 100, t, 11, drop, **cells)
        plain.backward(ds.float())
        bwd_err = max(
            ((a.float() - p.grad).abs().max()
             / p.grad.abs().max().clamp_min(1e-30)).item()
            for a, p in zip(grads, leaves))
        same = [rel_attention(qs, ks, vs, es, 100, t, 11, drop),
                rel_attention(qs, ks, vs, es, 100, t, 11, drop, b_offset=0,
                              h_offset=0, h_total=8)]
        if not torch.equal(*same):
            raise AssertionError("the default cells differ from (0, 0, H)")
        ok = err <= KERNEL_ATOL[name] and bwd_err <= BWD_RTOL[name]
        log(f"[kernel] rel_attention {name} shard rows {b0}+{b} heads "
            f"{h0}+8 of {ht}, T={t} dropout 0.2: forward and dQ/dK/dV "
            f"torch.equal to the whole batch's slices, defaults torch.equal "
            f"to (0, 0, H); forward max_abs_err {err:.3g} (tolerance "
            f"{KERNEL_ATOL[name]}), backward max err / max |grad| "
            f"{bwd_err:.3g} (tolerance {BWD_RTOL[name]}) against the plain "
            f"version with the same offsets")
        if not ok:
            raise AssertionError(f"rel_attention {name} with offsets "
                                 f"disagrees with its plain version")
        errs[("rel_attention_offsets", name)] = max(err, bwd_err)


def filter_inputs(lengths, t_pad, seed):
    """(B, t_pad, 8) float32 EMG of σ = 100 on the card, zero past each
    utterance's length, and the (B,) lengths."""
    import torch

    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), t_pad, 8), np.float32)
    for u, n in enumerate(lengths):
        x[u, :n] = rng.normal(size=(n, 8)) * 100
    return torch.from_numpy(x).cuda(), torch.tensor(lengths)


def check_filtfilt(errs):
    """Phase 2, the filter chain (csrc/filtfilt.cu): bit-equal to its plain
    version on the card at ragged lengths, in one launch and split in two,
    and between two calls."""
    import torch
    from silent_speech_tpu_torch.dsp.device_pipeline import filter_coeffs
    from silent_speech_tpu_torch.ops.filtfilt import (filtfilt_chain,
                                                      filtfilt_chain_plain)

    coeffs = filter_coeffs()
    x, lengths = filter_inputs(FILTER_LENGTHS, FILTER_T, SEED)
    out = filtfilt_chain(x, lengths, coeffs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = filtfilt_chain_plain(x, lengths, coeffs)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = (out - ref).abs().max().item()
    split = torch.cat([filtfilt_chain(x[:3], lengths[:3], coeffs),
                       filtfilt_chain(x[3:], lengths[3:], coeffs)])
    again = filtfilt_chain(x, lengths, coeffs)
    pad_zero = all(not out[u, n:].any()
                   for u, n in enumerate(FILTER_LENGTHS))
    ok = (torch.equal(out, ref) and torch.equal(out, split)
          and torch.equal(out, again) and pad_zero)
    log(f"[kernel] filtfilt_chain {len(coeffs)} filters B={len(lengths)} "
        f"T_pad={FILTER_T} C=8 lengths {FILTER_LENGTHS}: against the plain "
        f"version (on the card, {plain_s:.2f} s) torch.equal "
        f"{torch.equal(out, ref)} (max_abs_err {err:.3g}); one launch "
        f"against two {torch.equal(out, split)}; two calls "
        f"{torch.equal(out, again)}; rows past each length 0: {pad_zero} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("filtfilt_chain disagrees with its plain "
                             "version, or depends on the grouping")
    errs["filtfilt_chain"] = err


def ctc_inputs(seed, infeasible=False, u=64, t=1024, s=128, n_real=19):
    """CTC inputs at a recognition micro-step's shape, on the card: (U, T,
    38) log-probs, then per row its frames, its labels (padded with −1) and
    their count. Rows past ``n_real`` are padding rows (no frames, no
    labels); real rows have 200..t frames and about one label a 9 frames
    (the spoken rate at 86 frames a second). With ``infeasible``, row 2
    has 5 labels over 4 frames."""
    import torch

    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(u, t, 38)).astype(np.float32) * 2), -1)
    utt_len = np.zeros(u, np.int64)
    text_len = np.zeros(u, np.int64)
    labels = np.full((u, s), -1, np.int64)
    for i in range(n_real):
        utt_len[i] = rng.integers(200, t + 1)
        text_len[i] = min(s, utt_len[i] // 9)
        labels[i, :text_len[i]] = rng.integers(0, 37, size=text_len[i])
    labels[0, 1] = labels[0, 0]          # a repeat
    labels[1, text_len[1] - 1] = 0       # a last label of 0
    if infeasible:
        utt_len[2], text_len[2] = 4, 5
        labels[2] = -1
        labels[2, :5] = [1, 2, 3, 4, 5]
    return [lp.cuda()] + [torch.from_numpy(x).cuda()
                          for x in (utt_len, labels, text_len)]


def ctc_edge_inputs(seed):
    """CTC inputs at the kernels' staging edges, S=128, K=38: rows of 1,
    F - 1, F, F + 1 and T frames for the forward's chunk of F frames and
    the backward's, T no multiple of either; label counts 0, 31, 32, 33,
    63 (one warp of positions, then two) and 128, some rows infeasible."""
    import torch
    from silent_speech_tpu_torch.ops.ctc import chunk_frames

    f_fwd, f_bwd = chunk_frames(38, 128)
    t = 2 * max(f_fwd, f_bwd) + 37
    frames = [1, f_fwd - 1, f_fwd, f_fwd + 1, f_bwd - 1, f_bwd, f_bwd + 1,
              t]
    counts = [0, 31, 32, 33, 63, 128]
    rows = [(counts[i % len(counts)], n) for i, n in enumerate(frames)]
    rows += [(c, t) for c in counts] + [(1, 1), (40, 20)]
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(rng.normal(
        size=(len(rows), t, 38)).astype(np.float32) * 2), -1)
    labels = np.full((len(rows), 128), -1, np.int64)
    for i, (c, _) in enumerate(rows):
        labels[i, :c] = rng.integers(0, 37, size=c)
    return [lp.cuda()] + [torch.tensor(x).cuda() for x in (
        [n for _, n in rows], labels, [c for c, _ in rows])], (f_fwd, f_bwd)


def ctc_run(fn, lp, utt_len, labels, text_len, weights):
    """``fn``'s NLL and its gradient at ``lp`` of Σ weights · NLL."""
    x = lp.detach().clone().requires_grad_()
    nll = fn(x, utt_len, labels, text_len, 37)
    (nll * weights).sum().backward()
    return nll.detach(), x.grad


def check_ctc(errs):
    """Phase 2, CTC: the kernel against the plain version at a recognition
    micro-step's shape, with padding rows, with and without an infeasible
    row; two calls bit-equal; exact zeros past each row's frames, and a row
    without labels at exactly −weight on each live frame's blank."""
    import torch
    from silent_speech_tpu_torch.ops.ctc import ctc_nll, ctc_nll_plain

    edges, chunks = ctc_edge_inputs(SEED + 22)
    for infeasible in (False, True, "edges"):
        args = (edges if infeasible == "edges"
                else ctc_inputs(SEED + 20, infeasible, **REC_CTC))
        weights = torch.rand(args[0].shape[0], device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(21))
        nll, grad = ctc_run(ctc_nll, *args, weights)
        torch.cuda.synchronize()
        ref, ref_grad = ctc_run(ctc_nll_plain, *args, weights)
        again = ctc_run(ctc_nll, *args, weights)
        nll_rel = ((nll - ref).abs() / ref.abs().clamp_min(1e-30)).max(
            ).item()
        # every row against autograd through the plain lattice: a row
        # without labels (NLL −Σ_t lp[t, blank]) gets −weight at each live
        # frame's blank and 0 elsewhere, exactly
        grad_err = (grad - ref_grad).abs().max().item()
        tol = CTC_GRAD_RTOL * ref_grad.abs().max().item()
        utt_len, text_len = args[1], args[3]
        frames = torch.arange(grad.shape[1], device="cuda")
        live = frames[None, :] < utt_len[:, None]
        empty = live & (text_len == 0)[:, None]
        zeros = (not grad[~live].any()
                 and not grad[empty][:, :37].any()
                 and torch.equal(grad[empty][:, 37],
                                 -weights[:, None].expand_as(live)[empty]))
        same = torch.equal(nll, again[0]) and torch.equal(grad, again[1])
        ok = (bool(torch.isfinite(nll).all()) and nll_rel <= CTC_NLL_RTOL
              and grad_err <= tol and zeros and same)
        log(f"[kernel] ctc U={args[0].shape[0]} ({int((text_len > 0).sum())} "
            f"real rows, the rest padding) T={args[0].shape[1]} "
            f"S={args[2].shape[1]} K=38"
            + (f", the staging edges (chunks of {chunks[0]} frames forward "
               f"and {chunks[1]} backward; frames {args[1].tolist()}, "
               f"labels {args[3].tolist()})" if infeasible == "edges"
               else ", row 2 infeasible (NLL "
               f"{nll[2].item():.2f}, plain {ref[2].item():.2f})"
               if infeasible else "")
            + f": NLL max rel err {nll_rel:.3g} (tolerance {CTC_NLL_RTOL}), "
            f"gradient max_abs_err {grad_err:.3g} (tolerance {tol:.3g} = "
            f"{CTC_GRAD_RTOL} x max|ref|), exact zeros past each row's "
            f"frames and -weight at the blank of rows without labels: "
            f"{zeros}, two calls "
            f"bit-equal: {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the CTC kernel disagrees with its plain "
                                 "version, or is not deterministic")
        errs[("ctc", infeasible)] = grad_err


def locate_bwd_stage(q, k, v, e, dout, thresh):
    """Log how far stage A's scratch (P', dS, dR) of the bf16 backward lies
    from the staged mirror's, to tell stage A's faults from the later
    stages'."""
    import torch
    from silent_speech_tpu_torch.ops.rel_attention import (
        _staged_bwd, rel_attention_bwd_staged_plain)

    t, m = q.shape[2], (e.shape[1] + 1) // 2
    _, stages, scratch = _staged_bwd(q, k, v, e, dout, m, t, 13, thresh)
    stages[0][1]()
    _, ref = rel_attention_bwd_staged_plain(
        q, k, v, e, dout, m, None, 13, thresh, store_dtype=torch.bfloat16,
        return_scratch=True)
    for name, ours, r in zip(("P'", "dS", "dR"), scratch, ref):
        ours = ours[:, :, :t, :r.shape[-1]].float()
        log(f"[kernel]   stage A scratch {name} vs the staged mirror: "
            f"max_abs_err {(ours - r).abs().max().item():.3g} of "
            f"max|ref| {r.abs().max().item():.3g}")


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
        # the mel normalizer the export CLI embeds in the transduction
        # bundle: the vocoded route denormalizes with it
        norm_path = os.path.join(work, "normalizers.pkl")
        write_normalizers(norm_path)
        bundles, resident = {}, {}
        for i, (kind, heads) in enumerate((("transduction", (80, 48)),
                                           ("recognition", (38, None)))):
            model = EMGEncoder(*heads, ModelConfig()).init_weights(
                torch.Generator().manual_seed(SEED + i))
            path = os.path.join(work, f"{kind}.pt")
            torch.save(model.state_dict(), path)
            argv = ["--models", path, "--output_directory",
                    os.path.join(work, kind),
                    "--t_buckets", ",".join(map(str, BUCKETS)),
                    "--normalizers_file", norm_path]
            export.main(argv + (["--recognition"]
                                if kind == "recognition" else []))
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            bundles[kind] = export.ServingBundle.load(
                os.path.join(work, kind), device="cuda")
            resident[kind] = torch.cuda.memory_allocated() - before
        if not bundles["transduction"].has_normalizer \
                or bundles["recognition"].has_normalizer:
            raise AssertionError("the export CLI did not embed the mel "
                                 "normalizer in the transduction bundle "
                                 "alone")
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
        if launches != launch_counts(rel_attention_fwd=layers * n_requests):
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
    int8_launches, int8_bundle = serve_int8(card, work, bundles, resident,
                                            requests, replies, latency)
    vocoded = serve_vocoded(card, bundles["transduction"], work)
    return launches, vocoded, int8_launches, int8_bundle


def resident_tensor_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def serve_int8(card, work, bundles, resident, requests, replies, latency):
    """Phase 3, int8: the same two full-width model.pt files exported with
    ``--export_int8`` and loaded on the card (the quantized weights int8
    CUDA tensors, resident bytes beside the bf16 bundles'), every bucket
    served over HTTP (6 forward attention launches a request), each output
    torch.equal to a bf16 bundle of ``dequantize_state(quantize_state(
    state))`` and within SERVED_RTOL relative error of the plain bf16
    bundle's (phase 3's replies); then the int8 request p50 per bucket
    beside the bf16 one, and the forward per bucket with and without the
    dequantization. Returns the launches and the int8 transduction
    bundle, which phase 7b serves from."""
    import torch
    from silent_speech_tpu_torch.eval import export
    from silent_speech_tpu_torch.eval.server import ServingServer
    from silent_speech_tpu_torch.models.encoder import EMGEncoder

    t_phase = time.perf_counter()
    int8, twins = {}, {}
    for kind in ("transduction", "recognition"):
        model_pt = os.path.join(work, f"{kind}.pt")
        export.main(["--models", model_pt, "--output_directory",
                     os.path.join(work, f"{kind}_int8"), "--t_buckets",
                     ",".join(map(str, BUCKETS)), "--normalizers_file",
                     os.path.join(work, "normalizers.pkl"), "--export_int8"]
                    + (["--recognition"] if kind == "recognition" else []))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        int8[kind] = export.ServingBundle.load(
            os.path.join(work, f"{kind}_int8"), device="cuda")
        q_resident = torch.cuda.memory_allocated() - before
        state = torch.load(model_pt, map_location="cpu", weights_only=True)
        quantized = [k for k, v in export.quantize_state(state).items()
                     if export.is_quantized_leaf(v)]
        originals = {n: p for n, p in int8[kind].model.named_parameters()
                     if n.endswith(".original")}
        ok = (int8[kind].manifest["quantize"] == "int8"
              and len(originals) == len(quantized)
              and all(p.dtype == torch.int8 and p.is_cuda
                      for p in originals.values()))
        log(f"[serve.int8] {kind}: {len(quantized)} of {len(state)} tensors "
            f"quantized, int8 CUDA tensors: {ok}; resident on the card "
            f"(torch.cuda.memory_allocated around the load) int8 bundle "
            f"{q_resident} B against the bf16 bundle's {resident[kind]} B "
            f"({q_resident / resident[kind]:.3f}x); tensor bytes "
            f"{resident_tensor_bytes(int8[kind].model)} against "
            f"{resident_tensor_bytes(bundles[kind].model)} ({card})")
        if not ok:
            raise AssertionError(f"the int8 {kind} bundle does not hold its "
                                 f"quantized weights as int8 on the card")
        twin = EMGEncoder.from_state_dict(
            export.dequantize_state(export.quantize_state(state)))
        export.save_serving_bundle(twin, kind,
                                   os.path.join(work, f"{kind}_twin"),
                                   t_buckets=BUCKETS)
        twins[kind] = export.ServingBundle.load(
            os.path.join(work, f"{kind}_twin"), device="cuda")
        del state, twin

    # every request once to each server, then timed in turns (int8, bf16,
    # bf16, int8), so that the two p50s share the host's conditions
    servers = {side: ServingServer(recognition=b["recognition"],
                                   transduction=b["transduction"]).start()
               for side, b in (("int8", int8), ("bf16", bundles))}
    try:
        reset_launches()
        timed, q_replies = {}, {}
        for t, route, body in requests:
            q_replies[(route, t)] = post(servers["int8"].port, route, body)
            post(servers["bf16"].port, route, body)
            for side in ("int8", "bf16", "bf16", "int8"):
                t0 = time.perf_counter()
                post(servers[side].port, route, body)
                timed.setdefault((route, t, side), []).append(
                    time.perf_counter() - t0)
        launches = read_launches()
    finally:
        for server in servers.values():
            server.stop()
    n_requests = len(requests) * 6
    layers = int8["transduction"].model.cfg.num_layers
    log(f"[serve.int8] {n_requests} requests (half int8, half bf16), "
        f"launches {launches}")
    if launches != launch_counts(rel_attention_fwd=layers * n_requests):
        raise AssertionError(f"expected {layers} forward attention launches "
                             f"per request and no other kernel")
    for t, route, body in requests:
        kind, key = (("transduction", "mel") if route == "/v1/transduce"
                     else ("recognition", "log_probs"))
        got = np.asarray(q_replies[(route, t)][key], np.float32)
        emg = np.asarray(body["emg"], np.float32)
        raw = np.asarray(body["raw_emg"], np.float32)
        twin_out = twins[kind].predict(emg, raw, np.zeros(t, np.int64))
        plain = np.asarray(replies[(route, t)][key], np.float32)
        rel = float(np.linalg.norm(got - plain) / np.linalg.norm(plain))
        same = torch.equal(torch.from_numpy(got), torch.from_numpy(twin_out))
        log(f"[serve.int8] {route} t={t}: shape {got.shape}, torch.equal to "
            f"the dequantized twin: {same}; relative error to the bf16 "
            f"bundle {rel:.4g} (tolerance {SERVED_RTOL})")
        if (got.shape != plain.shape or not np.isfinite(got).all()
                or not same or not rel <= SERVED_RTOL):
            raise AssertionError(f"int8 {route} t={t} is wrong")
        if route == "/v1/recognize" and not isinstance(
                q_replies[(route, t)]["text"], str):
            raise AssertionError("int8 recognize reply has no text")

    for t, route, _ in sorted(requests, key=lambda r: (r[1], r[0])):
        bucket = next(b for b in BUCKETS if t <= b)
        log(f"[time] {card} | {route} bucket {bucket} (t={t}): request p50 "
            f"int8 {median_ms(timed[(route, t, 'int8')]):.2f} ms, bf16 "
            f"{median_ms(timed[(route, t, 'bf16')]):.2f} ms, in turns, 2 "
            f"each")
    # the forward alone: the int8 bundle's (it dequantizes every quantized
    # weight first) against its twin's (the same float32 weights
    # resident), back to back (the host's issue time included) and by the
    # device's busy time under the profiler; and the dequantization alone,
    # also queued behind a sleeping kernel (the device's time)
    model, twin_model = int8["transduction"].model, \
        twins["transduction"].model
    leaves = [(model.get_submodule(n.rsplit(".parametrizations.", 1)[0]),
               n.rsplit(".", 2)[-2])
              for n, _ in model.named_parameters() if n.endswith(".original")]
    with torch.inference_mode():
        def dequantize():
            return [getattr(m, n) for m, n in leaves]

        deq = (cuda_time_ms(dequantize, iters=10),
               queued_ms(dequantize, iters=10))
        log(f"[time] {card} | the dequantization of the {len(leaves)} int8 "
            f"weights alone (int8 · scale to float32): {deq[0]:.4f} ms back "
            f"to back, {deq[1]:.4f} ms queued")
        for t in REQUEST_T:
            bucket = next(b for b in BUCKETS if t <= b)
            raw = torch.from_numpy(utterance(bucket, SEED + t)[1]).to(
                int8["transduction"].device)[None]
            row = {}
            for name, m in (("int8", model), ("float32", twin_model)):
                prof = device_profile(
                    card, f"transduction forward bucket {bucket}, {name} "
                    f"weights", lambda: m(raw, valid_len=t), top=0,
                    cpu=False)
                row[name] = (cuda_time_ms(lambda: m(raw, valid_len=t),
                                          iters=10),
                             fmt_ms(None if prof is None else prof[1]))
            log(f"[time] {card} | transduction forward bucket {bucket} "
                f"(t={t}): int8 bundle {row['int8'][0]:.4f} ms back to back, "
                f"device busy {row['int8'][1]}; the same weights resident "
                f"in float32 {row['float32'][0]:.4f} ms, device busy "
                f"{row['float32'][1]}")
    del twins
    torch.cuda.empty_cache()
    log(f"[serve.int8] phase wall time {time.perf_counter() - t_phase:.1f} "
        f"s")
    return launches, int8["transduction"]


def write_normalizers(path):
    """A normalizers pickle with seeded statistics: (1, 80) mel means and
    stddevs, and (1, 112) EMG ones."""
    from silent_speech_tpu_torch.data.normalizers import (FeatureNormalizer,
                                                          save_normalizers)

    rng = np.random.default_rng(SEED)
    norms = []
    for dim in (80, 112):
        n = FeatureNormalizer()
        n.feature_means = rng.normal(size=(1, dim)).astype(np.float32)
        n.feature_stddevs = rng.uniform(0.5, 2.0, size=(1, dim)).astype(
            np.float32)
        norms.append(n)
    save_normalizers(path, *norms)


def write_seeded_vocoder(directory):
    """A full V1 HiFi-GAN generator from SEED, written as an official
    checkpoint (every conv a weight_g/weight_v pair) with its config.json.
    Returns the checkpoint's path and the generator on the CPU."""
    import torch
    from silent_speech_tpu_torch.models.hifigan import (
        HiFiGANConfig, init_generator, weight_norm_state)

    os.makedirs(directory, exist_ok=True)
    cfg = HiFiGANConfig()
    gen = init_generator(cfg, torch.Generator().manual_seed(SEED))
    path = os.path.join(directory, "generator")
    torch.save({"generator": weight_norm_state(gen.state_dict())}, path)
    cfg.to_json(os.path.join(directory, "config.json"))
    return path, gen


def serve_vocoded(card, trans, work):
    """Phase 3, vocoded: the seeded V1 generator loaded from its official
    checkpoint, held against itself on the CPU, bundled and attached to the
    server; each /v1/transduce then answers with audio. Returns the
    launches."""
    import torch
    from silent_speech_tpu_torch.eval import export
    from silent_speech_tpu_torch.eval.server import ServingServer
    from silent_speech_tpu_torch.models.hifigan import Vocoder

    path, gen = write_seeded_vocoder(os.path.join(work, "hifigan"))
    vocoder = Vocoder(path, device="cuda")
    folded = vocoder.generator.state_dict()
    fold_err = max((folded[k].cpu() - v).abs().max().item()
                   for k, v in gen.state_dict().items())
    n_params = sum(p.numel() for p in gen.parameters())
    n_tensors = len(torch.load(path, weights_only=True)["generator"])
    log(f"[serve.voc] V1 generator, {n_params} parameters, from an "
        f"official checkpoint of {n_tensors} tensors (weight-norm "
        f"pairs): folded weights within {fold_err:.3g} "
        f"of the seeded ones (tolerance 1e-6)")
    if not fold_err <= 1e-6:
        raise AssertionError("folding the weight norm did not give the "
                             "generator's weights")

    # the generator on the card against the same one on the CPU, f32
    mel = (0.5 * np.random.default_rng(SEED + 5).normal(
        size=(VOCODER_CPU_FRAMES, 80))).astype(np.float32)
    with torch.no_grad():
        ref = gen(torch.from_numpy(mel)[None])[0].numpy()
    err = float(np.abs(vocoder(mel) - ref).max())
    log(f"[serve.voc] generator f32 card vs CPU, {VOCODER_CPU_FRAMES} "
        f"frames: max_abs_err {err:.3g} (tolerance {VOCODER_ATOL})")
    if not err <= VOCODER_ATOL:
        raise AssertionError("the generator on the card disagrees with the "
                             "CPU")

    # JAX's default buckets refuse the longest request; these serve it
    default = export.ServingBundle.load(export.save_vocoder_bundle(
        vocoder, os.path.join(work, "vocoder_default")), device="cuda")
    try:
        default.vocode(np.zeros((REQUEST_T[-1], 80), np.float32))
        raise AssertionError("a mel over the largest bucket vocoded")
    except ValueError as e:
        log(f"[serve.voc] default buckets {default.manifest['t_buckets']}, "
            f"{REQUEST_T[-1]} frames: refused ({e})")
    del default
    voc = export.ServingBundle.load(export.save_vocoder_bundle(
        vocoder, os.path.join(work, "vocoder"), VOCODER_BUCKETS),
        device="cuda")
    del vocoder
    hop = voc.manifest["hop_length"]

    server = ServingServer(transduction=trans, vocoder=voc).start()
    latency, replies = {}, {}
    try:
        reset_launches()
        for t in REQUEST_T:
            emg, raw = utterance(t, seed=SEED + t)
            body = {"emg": emg.tolist(), "raw_emg": raw.tolist(),
                    "session_ids": [0] * t}
            for rep in range(1 + VOCODED_TIMED):
                t0 = time.perf_counter()
                reply = post(server.port, "/v1/transduce", body)
                if rep:
                    latency.setdefault(t, []).append(
                        time.perf_counter() - t0)
            replies[t] = reply
        launches = read_launches()
    finally:
        server.stop()
    n_requests = len(REQUEST_T) * (1 + VOCODED_TIMED)
    layers = trans.model.cfg.num_layers
    log(f"[serve.voc] {n_requests} vocoded requests, launches {launches}")
    if launches != launch_counts(rel_attention_fwd=layers * n_requests):
        raise AssertionError(f"expected {layers} forward attention launches "
                             f"per vocoded request, got {launches}")
    for t, reply in replies.items():
        mel = np.asarray(reply["mel"], np.float32)
        audio = np.asarray(reply["audio"], np.float32)
        ref = voc.vocode(trans.denormalize(mel))
        same = audio.shape == ref.shape and np.array_equal(audio, ref)
        ok = (audio.shape == (t * hop,) and np.isfinite(audio).all()
              and np.abs(audio).max() <= 1.0 and same)
        log(f"[serve.voc] t={t}: audio {audio.shape}, max |audio| "
            f"{np.abs(audio).max():.4f}, equal to vocode(denormalize(mel)) "
            f"computed here: {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"vocoded reply at t={t} is wrong")

    for t in REQUEST_T:
        bucket = next(b for b in VOCODER_BUCKETS if t <= b)
        mel = trans.denormalize(np.asarray(replies[t]["mel"], np.float32))
        voc.vocode(mel)
        samples = []
        for _ in range(TIMED_REQUESTS):
            t0 = time.perf_counter()
            voc.vocode(mel)
            samples.append(time.perf_counter() - t0)
        log(f"[time] {card} | /v1/transduce with audio, vocoder bucket "
            f"{bucket} (t={t}): request p50 {median_ms(latency[t]):.2f} ms "
            f"over {len(latency[t])}; vocode() alone p50 "
            f"{median_ms(samples):.2f} ms (generator incl. host copies, no "
            f"HTTP/JSON)")
    device_profile(card, f"vocode() bucket {bucket} (t={t})",
                   lambda: voc.vocode(mel))
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
    from silent_speech_tpu_torch.ops.adamw import adamw_fold, adamw_update
    from silent_speech_tpu_torch.ops.ctc import ctc_nll
    from silent_speech_tpu_torch.ops.dropout import mask_scale, relu_dropout
    from silent_speech_tpu_torch.ops.dtw import dtw_align_batch
    from silent_speech_tpu_torch.ops.filtfilt import filtfilt_chain
    from silent_speech_tpu_torch.ops.rel_attention import (
        rel_attention, rel_attention_bwd)
    from silent_speech_tpu_torch.utils.device import full_fp32

    rel_attention.launches = rel_attention_bwd.launches = 0
    rel_attention.f32_launches = rel_attention_bwd.f32_launches = 0
    dtw_align_batch.launches = dtw_align_batch.dp_only_launches = 0
    ctc_nll.launches = ctc_nll.backward_launches = 0
    filtfilt_chain.launches = 0
    mask_scale.launches = relu_dropout.backward_launches = 0
    adamw_update.launches = adamw_fold.launches = 0
    for counter in _batch_norm_counters():
        counter.launches = 0
    full_fp32.steps = 0


def read_launches():
    from silent_speech_tpu_torch.ops.adamw import adamw_fold, adamw_update
    from silent_speech_tpu_torch.ops.ctc import ctc_nll
    from silent_speech_tpu_torch.ops.dropout import mask_scale, relu_dropout
    from silent_speech_tpu_torch.ops.dtw import dtw_align_batch
    from silent_speech_tpu_torch.ops.filtfilt import filtfilt_chain
    from silent_speech_tpu_torch.ops.rel_attention import (
        rel_attention, rel_attention_bwd)
    from silent_speech_tpu_torch.utils.device import full_fp32

    return Launches({"rel_attention_fwd": rel_attention.launches,
                     "rel_attention_bwd": rel_attention_bwd.launches,
                     "dtw_align": dtw_align_batch.launches,
                     "dtw_align_dp_only": dtw_align_batch.dp_only_launches,
                     "ctc": ctc_nll.launches,
                     "ctc_bwd": ctc_nll.backward_launches,
                     "filtfilt_chain": filtfilt_chain.launches,
                     "dropout": mask_scale.launches,
                     "dropout_relu_bwd": relu_dropout.backward_launches,
                     "adamw_update": adamw_update.launches,
                     "adamw_fold": adamw_fold.launches,
                     **{name: counter.launches for name, counter in zip(
                         BATCH_NORM_KEYS, _batch_norm_counters())}},
                    f32={"rel_attention_fwd": rel_attention.f32_launches,
                         "rel_attention_bwd":
                             rel_attention_bwd.f32_launches},
                    full_fp32_steps=full_fp32.steps)


class Launches(dict):
    """Launches by kernel; ``f32`` holds how many of the attention
    launches took the f32 routes (``csrc/rel_attention_fwd.cu``,
    ``csrc/rel_attention_bwd.cu``), and ``full_fp32_steps`` how many
    training steps ran under ``utils.device.full_fp32`` (TF32 off).
    Comparisons look at the dict alone."""

    def __init__(self, counts, f32=None, full_fp32_steps=0):
        super().__init__(counts)
        self.f32 = dict(f32 or {"rel_attention_fwd": 0,
                                "rel_attention_bwd": 0})
        self.full_fp32_steps = full_fp32_steps

    def add(self, other):
        """Add ``other``'s counts, and its f32 share where it has one
        (else this one's f32 share is no longer known)."""
        for k, v in other.items():
            self[k] += v
        self.full_fp32_steps += getattr(other, "full_fp32_steps", 0)
        theirs = getattr(other, "f32", None)
        self.f32 = (None if self.f32 is None or theirs is None
                    else {k: v + theirs[k] for k, v in self.f32.items()})


def launch_counts(**counts):
    """A ``read_launches()`` dict with ``counts`` and 0 for the rest."""
    names = ("rel_attention_fwd", "rel_attention_bwd", "dtw_align",
             "dtw_align_dp_only", "ctc", "ctc_bwd", "filtfilt_chain",
             "dropout", "dropout_relu_bwd", "adamw_update", "adamw_fold",
             *BATCH_NORM_KEYS)
    return Launches({name: counts.get(name, 0) for name in names})


# the conv stack's BatchNorm kernels (csrc/batchnorm.cu), by read_launches()
# key: statistics, finalize (forward and backward), apply, the backward's
# reduction and apply
BATCH_NORM_KEYS = ("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_reduce",
                   "bn_bwd_apply")


def _batch_norm_counters():
    from silent_speech_tpu_torch.ops import batch_norm as bn

    return (bn.batch_norm_stats, bn.batch_norm_finalize, bn.batch_norm_apply,
            bn.batch_norm_bwd_reduce, bn.batch_norm_bwd_apply)


def batch_norm_counts(steps: int, mesh: bool = False) -> dict:
    """The BatchNorm kernels' launches of ``steps`` training steps or
    micro-steps (``csrc/batchnorm.cu``): each of the three ResBlocks runs
    two fused BNs (BN1 + ReLU; BN2 and the residual BN + add + ReLU), each
    a statistics pass, a finalize and an apply forward and a reduction, a
    finalize and an apply backward; a mesh sums the statistics over its
    data axis between two finalizes (one more a BN): 36 a step, 42 on a
    mesh. The eval forward launches none."""
    bns = 6 * steps
    return {"bn_stats": bns, "bn_finalize": (3 if mesh else 2) * bns,
            "bn_apply": bns, "bn_bwd_reduce": bns, "bn_bwd_apply": bns}


def dropout_counts(layers: int, steps: int) -> dict:
    """The dropout kernels' launches of ``steps`` training steps or
    micro-steps at rate > 0 (``csrc/dropout.cu``): a layer's two residual
    masks forward and regenerated backward and its FFN's ReLU dropout
    forward (``dropout``, 5 a layer), and the ReLU dropout's backward
    (``dropout_relu_bwd``, 1 a layer): 36 a step at 6 layers."""
    return {"dropout": 5 * layers * steps,
            "dropout_relu_bwd": layers * steps}


def adamw_counts(updates: int, micro_steps: int = 0) -> dict:
    """The AdamW kernels' launches (``csrc/adamw.cu``) of ``updates``
    optimizer updates and, with accumulation, ``micro_steps`` folds: one
    launch each, every trainer's leaves fitting one launch."""
    return {"adamw_update": updates, "adamw_fold": micro_steps}


def train(card):
    """Phase 4: full-width training steps through the kernels, the eval
    step, and the f32 step against its plain twin. Returns the main path's
    launches, the steps/s trials, and the inputs the timings use."""
    import torch
    from silent_speech_tpu_torch.bench import example_sets
    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.models import encoder, transformer
    from silent_speech_tpu_torch.ops.batch_norm import (bn_add_relu_plain,
                                                         bn_relu_plain)
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
    batches = [trainer._pack(s) for s in example_sets()]
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
    # (dtw_align_dp_only: a timing mode, off the path)
    expected = launch_counts(
        rel_attention_fwd=layers * n_steps,
        rel_attention_bwd=layers * n_steps,
        dtw_align=sum(1 for b in order if b.num_silent),
        **dropout_counts(layers, n_steps), **batch_norm_counts(n_steps),
        **adamw_counts(n_steps))
    log(f"[train] {n_steps} steps, launches {launches} (expected "
        f"{expected})")
    if launches != expected or not all(expected[k] for k in (
            "rel_attention_fwd", "rel_attention_bwd", "dtw_align",
            "dropout", "dropout_relu_bwd", "adamw_update", "bn_stats")):
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

    transduction_determinism(card, trainer, order)

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

    def plain_bn_relu(c, bn, train, mesh=None, store=None):
        return bn_relu_plain(c, bn, train, mesh)

    def plain_bn_add_relu(c, bn, res, res_bn, train, mesh=None, store=None,
                          forks=1):
        out = bn_add_relu_plain(c, bn, res, res_bn, train, mesh)
        return out if forks == 1 else (out, out)

    swaps = {"kernels": [(losses, "dtw_align_batch", capture)],
             "plain": [(losses, "dtw_align_batch", dtw_align_batch_plain),
                       (transformer, "rel_attention", rel_attention_plain),
                       (encoder, "bn_relu", plain_bn_relu),
                       (encoder, "bn_add_relu", plain_bn_add_relu)]}
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
    f32_launches, f32_step = f32_train(card, batch, cfg.learning_rate)
    log(f"[time] {card} | train step bf16 full width: "
        f"{np.round(trials, 3).tolist()} steps/s over trials of "
        f"{list(TRIAL_STEPS)} steps, median {float(np.median(trials)):.3f} "
        f"steps/s")
    return launches, trials, (costs, n1, n2), f32_launches, f32_step


def f32_train(card, batch, lr):
    """Phase 4's float32 path (``--compute_dtype float32``) at full width,
    through the kernels: one warm-up step, then ``F32_TIMED_STEPS`` steps
    timed by the host clock around synchronized work with the counts
    zeroed just before and read just after (6 K1f and 6 K1b a step, all on
    the f32 routes, and the DTW), then one step under the profiler for K1f
    and K1b f32's device time in it. Returns the timed steps' launches and
    the step's numbers."""
    import torch
    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.train.transduction import (
        TransductionTrainer)

    tr = TransductionTrainer(ModelConfig(compute_dtype="float32"))
    tr.init_state(SEED)
    layers = tr.model_cfg.num_layers
    tr.train_step(batch, lr)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(F32_TIMED_STEPS):
        out = tr.train_step(batch, lr)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / F32_TIMED_STEPS
    launches = read_launches()
    n = F32_TIMED_STEPS
    expected = launch_counts(rel_attention_fwd=layers * n,
                             rel_attention_bwd=layers * n,
                             dtw_align=n if batch.num_silent else 0,
                             **dropout_counts(layers, n),
                             **batch_norm_counts(n),
                             **adamw_counts(n))
    f32_expected = {"rel_attention_fwd": layers * n,
                    "rel_attention_bwd": layers * n}
    log(f"[train.f32] {n} float32 steps: launches {launches}, on the f32 "
        f"routes {launches.f32} (expected {expected}, f32 {f32_expected}); "
        f"{launches.full_fp32_steps} steps with TF32 off; loss "
        f"{out.loss.item():.6f}")
    if (launches != expected or launches.f32 != f32_expected
            or not np.isfinite(out.loss.item())):
        raise AssertionError(f"float32 training launches {launches} (f32 "
                             f"{launches.f32}), expected {expected} (f32 "
                             f"{f32_expected}), and a finite loss")
    if launches.full_fp32_steps != n:
        raise AssertionError(f"{n} float32 steps ran, "
                             f"{launches.full_fp32_steps} of them with TF32 "
                             f"off (utils.device.full_fp32)")
    events = []
    prof = device_profile(card, "one float32 training step (B=120 chunks x "
                          "200)", lambda: tr.train_step(batch, lr), cpu=False,
                          events=events)
    k1b = [(end - start) / 1e3 for name, start, end in events
           if F32_BWD_KERNEL in name]
    k1f = [(end - start) / 1e3 for name, start, end in events
           if F32_FWD_KERNEL in name]
    k1b_ms = sum(k1b) if k1b else None
    k1f_ms = sum(k1f) if k1f else None
    busy = prof[1] if prof else None
    log(f"[time] {card} | train step f32 full width: {step_ms:.1f} ms a "
        f"step over {n} steps after one warm-up; K1b f32 device time in "
        f"one step (profiler, {len(k1b)} kernel launches of its "
        f"{layers} calls): {fmt_ms(k1b_ms)}, K1f f32 ({len(k1f)} "
        f"launches): {fmt_ms(k1f_ms)}, of {fmt_ms(busy)} device busy")
    del tr, out
    torch.cuda.empty_cache()
    return launches, {"steps": n, "step_ms": step_ms,
                      "k1b_device_ms": k1b_ms, "k1f_device_ms": k1f_ms,
                      "device_busy_ms": busy}


def _snapshot(trainer):
    """A copy of everything a transduction step reads and writes: weights
    and statistics, the AdamW moments and count, the step generator."""
    opt = trainer.optimizer
    return ({k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()},
            [m.clone() for m in opt.mu + opt.nu], opt.count,
            trainer.generator.get_state())


def _restore(trainer, snap):
    import torch

    state, moments, count, gen_state = snap
    opt = trainer.optimizer
    with torch.no_grad():
        trainer.model.load_state_dict(state)
        for dst, src in zip(opt.mu + opt.nu, moments):
            dst.copy_(src)
    opt.count = count
    trainer.generator.set_state(gen_state)


def transduction_determinism(card, trainer, order):
    """Phase 4, fault 12: two full-width steps from one state on one batch
    give torch.equal gradients; then the step under cuDNN's deterministic
    algorithms against the default ones, timed in turns in this call."""
    import torch
    from silent_speech_tpu_torch.train import encoder_trainer

    lr = trainer.train_cfg.learning_rate
    snap = _snapshot(trainer)
    runs = []
    for _ in range(2):
        _restore(trainer, snap)
        out = trainer.train_step(order[0], lr)
        runs.append((out.loss.detach().clone(),
                     {n: p.grad.detach().clone()
                      for n, p in trainer.model.named_parameters()}))
    differ = [n for n, g in runs[0][1].items()
              if not torch.equal(g, runs[1][1][n])]
    same_loss = torch.equal(runs[0][0], runs[1][0])
    shown = f" (differ: {', '.join(differ[:6])})" if differ else ""
    log(f"[train] two steps from one state on one batch: loss equal "
        f"{same_loss}, {len(runs[0][1]) - len(differ)}/{len(runs[0][1])} "
        f"parameter gradients torch.equal{shown}")
    if differ or not same_loss:
        raise AssertionError("the transduction step is not deterministic")
    del runs
    _restore(trainer, snap)
    del snap

    def default_algorithms():
        return swapped(encoder_trainer, "deterministic_cudnn",
                       contextlib.nullcontext)

    with default_algorithms():   # the default algorithms' first call
        trainer.train_step(order[1], lr)
    rates = {"default": [], "deterministic": []}
    step = 0
    for _ in range(AB_ROUNDS):
        for mode in rates:
            with contextlib.ExitStack() as stack:
                if mode == "default":
                    stack.enter_context(default_algorithms())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(AB_STEPS):
                    trainer.train_step(order[step % len(order)], lr)
                    step += 1
                torch.cuda.synchronize()
                rates[mode].append(AB_STEPS / (time.perf_counter() - t0))
    busy = {}
    for mode in rates:
        with contextlib.ExitStack() as stack:
            if mode == "default":
                stack.enter_context(default_algorithms())
            prof = device_profile(
                card, f"one bf16 training step, cuDNN {mode} algorithms",
                lambda: trainer.train_step(order[0], lr), top=4, cpu=False)
        busy[mode] = None if prof is None else prof[1]
    med = {m: float(np.median(r)) for m, r in rates.items()}
    log(f"[time] {card} | train step, cuDNN default vs deterministic "
        f"algorithms in turns ({AB_ROUNDS} rounds of {AB_STEPS} steps "
        f"each): default {np.round(rates['default'], 3).tolist()} steps/s, "
        f"deterministic {np.round(rates['deterministic'], 3).tolist()}; "
        f"medians {med['default']:.3f} vs {med['deterministic']:.3f} "
        f"({med['deterministic'] / med['default'] - 1:+.1%}); device busy a "
        f"step {fmt_ms(busy['default'])} vs {fmt_ms(busy['deterministic'])}")


def _state_equal(a, b) -> bool:
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k].cpu(),
                                                    b[k].cpu()) for k in a)


# torch.cuda._sleep's kernel: a mark of a host call on the card's timeline
MARK_KERNEL = "spin_kernel"


def _spy(obj, name, calls, marks=None):
    """Wrap ``obj.name`` so that each call's arguments and result are
    appended to ``calls``; with ``marks``, each call first launches a mark
    kernel and appends ``name`` there."""
    import torch

    fn = getattr(obj, name)

    def wrapped(*args):
        if marks is not None:
            torch.cuda._sleep(100)
            marks.append(name)
        out = fn(*args)
        calls.append((args, out))
        return out

    setattr(obj, name, wrapped)


def step_windows(events, marks):
    """(wall ms, busy ms) of each epoch's step window in a profiled fit():
    from the card's start of the epoch's first step mark to that of the
    validation's first, which holds the steps and the epoch's loss read.
    The card is idle at both marks (after the corpus build or a checkpoint,
    and after the loss read), so each runs when the host reaches it. None
    when the marks on the card are not the calls made."""
    starts = sorted(s for n, s, _ in events if MARK_KERNEL in n)
    if len(starts) != len(marks):
        return None
    windows, begin = [], None
    for name, t in zip(marks, starts):
        if name != "eval_step":
            begin = t if begin is None else begin
        elif begin is not None:
            windows.append((begin, t))
            begin = None
    return [((b - a) / 1e3,
             sum(min(e, b) - s for _, s, e in events if a <= s < b) / 1e3)
            for a, b in windows]


def train_run(card, work):
    """Phase 5: the training run on a device-resident corpus, full width.
    Returns the launches of the fit() and resume window and of
    get_aligned_prediction, and the DTW inputs of the latter."""
    import torch
    from silent_speech_tpu_torch import bench
    from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                                TransductionTrainConfig)
    from silent_speech_tpu_torch.data.dataset import ExampleList
    from silent_speech_tpu_torch.data.normalizers import FeatureNormalizer
    from silent_speech_tpu_torch.data.packing import upload
    from silent_speech_tpu_torch.models.encoder import EMGEncoder
    from silent_speech_tpu_torch.ops.dtw import (
        dtw_align_batch, dtw_align_batch_plain)
    from silent_speech_tpu_torch.train import transduction
    from silent_speech_tpu_torch.train.transduction import (
        TransductionTrainer)

    # fit()'s log lines on stdout
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[fit.log] %(message)s"))
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)

    # the bench's corpus and trainer, and one gathered batch against the
    # upload of the same batch packed on the host
    t0 = time.perf_counter()
    sets = bench.example_sets()
    trainer, corpus, id_sets = bench.setup(device="cuda", sets=sets)
    nbytes = sum(a.numel() * a.element_size() for a in corpus.arrays)
    log(f"[fit] device corpus of {corpus.num_examples} utterances "
        f"({sum(len(s) for s in sets)} in 4 sets), {nbytes / 2**20:.1f} "
        f"MiB on the card, built in {time.perf_counter() - t0:.2f} s")
    ids = corpus.order_silent_first(id_sets[0])
    gathered = trainer.assemble(corpus, ids)
    packed = upload(trainer._pack(sets[0]), "cuda")
    differ = [f for f in packed._fields if not (
        getattr(gathered, f).dtype == getattr(packed, f).dtype
        and torch.equal(getattr(gathered, f), getattr(packed, f)))]
    log(f"[fit] assembled batch vs the packed upload of set 0 "
        f"({packed.raw_emg.shape[0]} chunks, {len(ids)} utterances): "
        f"fields differing {differ} (must be none)")
    if differ:
        raise AssertionError(f"assemble_batch differs from pack_batch in "
                             f"{differ}")

    # the bench's measurement, then train_step_ids beside train_step with
    # host packing, on the same trainer in one call
    ids_rates = bench.measure(bench.ids_steps(trainer, corpus, id_sets),
                              trainer.device)
    host_rates = bench.measure(
        lambda i: trainer.train_step(trainer._pack(sets[i % 4]), 1e-3),
        trainer.device)
    print(json.dumps(bench.result_line(ids_rates)), flush=True)
    shares = {}
    for what, rates, step in (
            ("train_step_ids (device corpus)", ids_rates,
             bench.ids_steps(trainer, corpus, id_sets)),
            ("train_step (host packing)", host_rates,
             lambda i: trainer.train_step(trainer._pack(sets[i % 4]),
                                          1e-3))):
        prof = device_profile(
            card, f"{bench.TRIAL_STEPS} steps of {what}",
            lambda: [step(i) for i in range(bench.TRIAL_STEPS)], top=0,
            cpu=False)
        shares[what] = None if prof is None else 1 - prof[1] / prof[0]
        log(f"[time] {card} | {what}: {np.round(rates, 3).tolist()} "
            f"steps/s over trials of {bench.TRIAL_STEPS}, median "
            f"{float(np.median(rates)):.3f}; idle share "
            f"{'not measured' if prof is None else f'{shares[what]:.1%}'}")
    del trainer, corpus
    torch.cuda.empty_cache()

    # fit() for 2 epochs over the 4 sets with validation, then resume
    out_dir = os.path.join(work, "fit")
    rng = np.random.default_rng(SEED + 4)
    train_set = ExampleList([e for s in sets for e in s])
    dev_set = ExampleList(bench.build_examples(rng, DEV_FRAMES))

    def fit_trainer(seed, marks=None):
        tr = TransductionTrainer(ModelConfig(), DataConfig(),
                                 TransductionTrainConfig(
                                     output_directory=out_dir),
                                 device="cuda")
        tr.init_state(seed)
        calls = {"ids": [], "host": [], "eval": []}
        for name, key in (("train_step_ids", "ids"), ("train_step", "host"),
                          ("eval_step", "eval")):
            _spy(tr, name, calls[key], marks)
        return tr, calls

    marks, events = [], []
    first, calls = fit_trainer(SEED, marks)
    reset_launches()
    t0 = time.perf_counter()
    prof = device_profile(
        card, f"fit(), {FIT_EPOCHS} epochs on the device corpus with "
        f"validation and checkpoints",
        lambda: first.fit(train_set, dev_set, epochs=FIT_EPOCHS,
                          seed=SEED), top=0, cpu=False, events=events)
    fit_s = time.perf_counter() - t0
    windows = step_windows(events, marks)
    log(f"[fit] {card} | step windows of fit() (each epoch's first step "
        f"to its validation, the once-an-epoch loss read included): " + (
            "not measured: the marks on the card are not the calls made"
            if not windows else "; ".join(
                f"epoch {i + 1}: wall {w:.3f} ms, device busy {b:.3f} ms, "
                f"idle share {1 - b / w:.1%}"
                for i, (w, b) in enumerate(windows))))
    saved = {k: v.detach().clone() for k, v in
             first.model.state_dict().items()}
    saved_opt = [m.clone() for m in first.optimizer.mu + first.optimizer.nu]
    saved_gen = first.generator.get_state()
    saved_count = first.optimizer.count
    whole = ("not measured" if prof is None
             else f"{1 - prof[1] / prof[0]:.1%}")
    log(f"[fit] {FIT_EPOCHS} epochs: {len(calls['ids'])} train_step_ids "
        f"steps, {len(calls['host'])} host-packed, {len(calls['eval'])} "
        f"eval batches in {fit_s:.2f} s; idle share in the whole fit() "
        f"window (corpus build, validations and checkpoints included) "
        f"{whole}")
    state = torch.load(os.path.join(out_dir, "model.pt"), map_location="cpu",
                       weights_only=True)
    model = EMGEncoder(80, 48, ModelConfig())
    model.load_state_dict(state, strict=True)
    if not _state_equal(model.state_dict(), saved):
        raise AssertionError("model.pt is not the trained state")
    del first, model, state
    torch.cuda.empty_cache()

    resumed, calls_2 = fit_trainer(SEED + 1)
    restored = {}
    step_ids = resumed.train_step_ids

    def first_step(*args):
        if not restored:
            restored.update(
                model=_state_equal(resumed.model.state_dict(), saved),
                moments=all(torch.equal(a, b) for a, b in zip(
                    resumed.optimizer.mu + resumed.optimizer.nu,
                    saved_opt)),
                generator=torch.equal(resumed.generator.get_state(),
                                      saved_gen),
                count=resumed.optimizer.count == saved_count)
        return step_ids(*args)

    resumed.train_step_ids = first_step
    resumed.fit(train_set, dev_set, epochs=FIT_EPOCHS + 1, seed=SEED,
                resume=True)
    fit_launches = read_launches()
    log(f"[fit] resumed for epoch {FIT_EPOCHS + 1}: "
        f"{len(calls_2['ids'])} steps; the state before its first step "
        f"equals the saved one: {restored}")
    if not restored or not all(restored.values()):
        raise AssertionError(f"resume restored another state: {restored}")

    steps = calls["ids"] + calls_2["ids"]
    evals = calls["eval"] + calls_2["eval"]
    host_steps = calls["host"] + calls_2["host"]
    silent = [sum(bool(train_set[i]["silent"]) for i in args[1])
              for args, _ in steps]
    layers = ModelConfig().num_layers
    expected = launch_counts(
        rel_attention_fwd=layers * (len(steps) + len(evals)),
        rel_attention_bwd=layers * len(steps),
        dtw_align=sum(1 for n in silent if n)
        + sum(1 for (batch, *_), _ in evals if batch.num_silent),
        **dropout_counts(layers, len(steps)),
        **batch_norm_counts(len(steps)), **adamw_counts(len(steps)))
    log(f"[fit] launches in the fit() and resume windows {fit_launches} "
        f"(expected {expected}: 6 forward and 6 backward attention and a "
        f"DTW a step, 6 forward attention and a DTW a validation batch)")
    if host_steps or not steps or any(o is None for _, o in steps):
        raise AssertionError(f"fit() left the device-corpus path: "
                             f"{len(host_steps)} host-packed steps")
    if fit_launches != expected:
        raise AssertionError(f"fit() launches {fit_launches}, expected "
                             f"{expected}")
    losses = torch.stack([o.loss for _, o in steps]).cpu().numpy()
    log(f"[fit] step losses {np.round(losses, 4).tolist()}")
    if not np.isfinite(losses).all():
        raise AssertionError("a fit() loss is not finite")

    # get_aligned_prediction on a silent example: K1f at B=1, K2 at K=1
    example = next(e for e in dev_set if e["silent"])
    norm = FeatureNormalizer()
    norm.feature_means = rng.normal(size=(1, 80)).astype(np.float32)
    norm.feature_stddevs = np.float32(2.0)
    captured = {}

    def capture(costs, n1, n2, **kw):
        out = dtw_align_batch(costs, n1, n2, **kw)
        captured["args"] = (costs.clone(), n1.clone(), n2.clone(),
                            out[0].clone())
        return out

    reset_launches()
    with swapped(transduction, "dtw_align_batch", capture):
        aligned = resumed.get_aligned_prediction(example, norm)
    aligned_launches = read_launches()
    costs, n1, n2, ours = captured["args"]
    plain = dtw_align_batch_plain(costs, n1, n2)[0]
    t_tgt = example["parallel_voiced_audio_features"].shape[0]
    ok = (aligned.shape == (t_tgt, 80) and np.isfinite(aligned).all()
          and torch.equal(ours, plain) and aligned_launches == launch_counts(
              rel_attention_fwd=layers, dtw_align=1))
    log(f"[fit] get_aligned_prediction of a silent utterance (T "
        f"{example['emg'].shape[0]} frames, target {t_tgt}): output "
        f"{aligned.shape}, finite {np.isfinite(aligned).all()}, DTW K=1 "
        f"f32 costs {tuple(costs.shape)} alignment equal to the plain "
        f"version's: {torch.equal(ours, plain)}; launches "
        f"{aligned_launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("get_aligned_prediction failed")
    logging.getLogger().removeHandler(handler)
    return fit_launches, aligned_launches, (costs, n1, n2)


def write_bigram_arpa(sentences, path) -> None:
    """A word bigram ARPA LM of ``sentences``: maximum-likelihood
    probabilities, back-off weights of 1, and ``<unk>`` at half a count."""
    import math
    from collections import Counter

    uni, bi = Counter(), Counter()
    for sentence in sentences:
        words = ["<s>", *sentence.split(), "</s>"]
        uni.update(words)
        bi.update(zip(words, words[1:]))
    total = sum(uni.values())
    lines = ["\\data\\", f"ngram 1={len(uni) + 1}", f"ngram 2={len(bi)}",
             "", "\\1-grams:", f"{math.log10(0.5 / total):.6f}\t<unk>\t0"]
    lines += [f"{math.log10(c / total):.6f}\t{w}\t0"
              for w, c in sorted(uni.items())]
    lines += ["", "\\2-grams:"]
    lines += [f"{math.log10(c / uni[a]):.6f}\t{a} {b}"
              for (a, b), c in sorted(bi.items())]
    with open(path, "w") as f:
        f.write("\n".join(lines + ["", "\\end\\", ""]))


def recognition_run(card, work):
    """Phase 6: recognition training and evaluation at full width. Returns
    the launches of the fit() and resume window and of one served
    request."""
    import types

    import torch
    from silent_speech_tpu_torch import bench
    from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                                RecognitionTrainConfig)
    from silent_speech_tpu_torch.data.dataset import ExampleList
    from silent_speech_tpu_torch.data.sampler import SizeAwareSampler
    from silent_speech_tpu_torch.eval import export
    from silent_speech_tpu_torch.eval.decode import (beam_ctc_decode,
                                                     beam_ctc_decode_plain)
    from silent_speech_tpu_torch.eval.server import ServingServer
    from silent_speech_tpu_torch.models import transformer
    from silent_speech_tpu_torch.models.encoder import EMGEncoder
    from silent_speech_tpu_torch.ops.ctc import ctc_nll
    from silent_speech_tpu_torch.ops.rel_attention import rel_attention_plain
    from silent_speech_tpu_torch.text import TextTransform
    from silent_speech_tpu_torch.train import losses
    from silent_speech_tpu_torch.train.recognition import RecognitionTrainer
    from silent_speech_tpu_torch.utils import native

    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[rec.log] %(message)s"))
    logging.getLogger().addHandler(handler)

    # the bench's 4 sets and a validation set, each text spelled from its
    # characters, and a bigram LM of the training texts
    tt = TextTransform()

    def spelled(examples):
        return [dict(e, text=tt.int_to_text(e["text_int"]))
                for e in examples]

    train_set = ExampleList([e for s in bench.example_sets()
                             for e in spelled(s)])
    dev_set = ExampleList(spelled(bench.build_examples(
        np.random.default_rng(SEED + 5), DEV_FRAMES)))
    lm_path = os.path.join(work, "lm.arpa")
    write_bigram_arpa([e["text"] for e in train_set], lm_path)
    t0 = time.perf_counter()
    lib = native.build()
    log(f"[rec] native beam search {os.path.basename(lib)} ready in "
        f"{time.perf_counter() - t0:.2f} s; {len(train_set)} training and "
        f"{len(dev_set)} validation utterances, bigram LM of the training "
        f"texts")
    out_dir = os.path.join(work, "fit")

    def trainer(seed, **model_kw):
        tr = RecognitionTrainer(
            ModelConfig(**model_kw), DataConfig(),
            RecognitionTrainConfig(output_directory=out_dir,
                                   lm_path=lm_path), device="cuda")
        tr.init_state(seed)
        return tr

    # micro-steps a second of train_step_ids on the device corpus
    tr = trainer(SEED)
    corpus = tr.build_corpus(train_set)
    id_batches = list(SizeAwareSampler(train_set, tr.train_cfg.max_batch_len,
                                       seed=SEED))
    caps = tr._cache_caps()
    if (caps["n_chunks"], caps["seq_len"]) != REC_BT or not all(
            tr._cache_fits(corpus, ids) for ids in id_batches):
        raise AssertionError(f"recognition caps {caps} are not {REC_BT}, or "
                             f"a batch does not fit them")

    def step(i):
        out = tr.train_step_ids(corpus, id_batches[i % len(id_batches)],
                                1e-4)
        return types.SimpleNamespace(loss=out)

    rates = bench.measure(step, tr.device)
    if tr.optimizer.mini_step:
        step(0)   # start the profiled window on a group's first micro-step
    prof = device_profile(
        card, f"{REC_PROFILED_STEPS} recognition micro-steps of "
        f"train_step_ids", lambda: [step(i) for i in
                                    range(REC_PROFILED_STEPS)],
        top=0, cpu=False)
    busy = "not measured" if prof is None else (
        f"device busy {prof[1] / REC_PROFILED_STEPS:.3f} ms a micro-step, "
        f"{2 * prof[1] / REC_PROFILED_STEPS:.3f} ms an update, idle share "
        f"{1 - prof[1] / prof[0]:.1%}")
    log(f"[time] {card} | recognition train_step_ids (B={REC_BT[0]} chunks "
        f"x {REC_BT[1]}, bf16, dropout 0.2, accumulation 2): "
        f"{np.round(rates, 3).tolist()} micro-steps/s over trials of "
        f"{bench.TRIAL_STEPS}, median {float(np.median(rates)):.3f} "
        f"({float(np.median(rates)) / 2:.3f} updates/s); {busy}")
    del tr
    torch.cuda.empty_cache()

    # two micro-steps from one state (the same seeds) on one batch: equal
    # losses and gradients (the port's CTC and deterministic convolutions);
    # the first one's CTC inputs are kept for the kernel's timing
    captured, twins = {}, []

    def capture(lp, *rest):
        captured.setdefault("args", (lp.detach().clone(), *rest))
        return ctc_nll(lp, *rest)

    for _ in range(2):
        twin = trainer(SEED)
        reset_launches()
        with swapped(losses, "ctc_nll", capture):
            loss = twin.train_step_ids(corpus, id_batches[0], 1e-4)
        twins.append((loss, read_launches(),
                      {n: p.grad.detach().clone()
                       for n, p in twin.model.named_parameters()}))
        del twin
        torch.cuda.empty_cache()
    (loss_a, counts, grads_a), (loss_b, _, grads_b) = twins
    differ = [n for n, g in grads_a.items() if not torch.equal(g,
                                                                grads_b[n])]
    layers = ModelConfig().num_layers
    ok = (torch.equal(loss_a, loss_b) and not differ
          and counts == launch_counts(rel_attention_fwd=layers,
                                      rel_attention_bwd=layers, ctc=1,
                                      ctc_bwd=1, **dropout_counts(layers, 1),
                                      **batch_norm_counts(1),
                                      **adamw_counts(0, 1)))
    log(f"[rec] two micro-steps from one state on one batch: losses "
        f"{loss_a.item():.6f} and {loss_b.item():.6f}, all {len(grads_a)} "
        f"gradients torch.equal: {not differ}"
        + (f" (differ: {differ})" if differ else "")
        + f"; launches a micro-step {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("two recognition micro-steps from one state "
                             "differ, or launched other kernels")
    del corpus, twins, grads_a, grads_b
    torch.cuda.empty_cache()

    # fit() for 2 epochs with validation WER, then a resumed 3rd epoch;
    # each micro-step's weights before and after it
    def watched(tr):
        calls = {"ids": [], "host": [], "wer": [], "moves": []}
        ids_step, host_step, wer = (tr.train_step_ids, tr.train_step,
                                    tr.evaluate_wer)

        def flat():
            return torch.cat([p.detach().flatten()
                              for p in tr.model.parameters()])

        def on_ids(*args):
            before = flat()
            out = ids_step(*args)
            calls["moves"].append((tr.optimizer.mini_step == 0,
                                   not torch.equal(before, flat())))
            calls["ids"].append(out)
            return out

        def on_host(*args):
            calls["host"].append(args)
            return host_step(*args)

        def on_wer(*args):
            calls["wer"].append(wer(*args))
            return calls["wer"][-1]

        tr.train_step_ids, tr.train_step, tr.evaluate_wer = (
            on_ids, on_host, on_wer)
        return calls

    first = trainer(SEED)
    calls = watched(first)
    reset_launches()
    t0 = time.perf_counter()
    first.fit(train_set, dev_set, epochs=FIT_EPOCHS, seed=SEED)
    fit_s = time.perf_counter() - t0
    opt = first.optimizer
    saved = ({k: v.detach().clone() for k, v in
              first.model.state_dict().items()},
             [m.clone() for m in opt.mu + opt.nu + opt.acc],
             (opt.count, opt.mini_step), first.generator.get_state())
    state = torch.load(os.path.join(out_dir, "model.pt"), map_location="cpu",
                       weights_only=True)
    if not _state_equal(EMGEncoder.from_state_dict(state).state_dict(),
                        saved[0]):
        raise AssertionError("model.pt is not the trained state")
    del first, state
    torch.cuda.empty_cache()

    resumed = trainer(SEED + 1)
    calls_2 = watched(resumed)
    restored = {}
    ids_step = resumed.train_step_ids

    def first_step(*args):
        if not restored:
            o = resumed.optimizer
            restored.update(
                model=_state_equal(resumed.model.state_dict(), saved[0]),
                moments_and_accumulator=all(torch.equal(a, b) for a, b in zip(
                    o.mu + o.nu + o.acc, saved[1])),
                count_and_micro_step=(o.count, o.mini_step) == saved[2],
                generator=torch.equal(resumed.generator.get_state(),
                                      saved[3]))
        return ids_step(*args)

    resumed.train_step_ids = first_step
    t0 = time.perf_counter()
    resumed.fit(train_set, dev_set, epochs=FIT_EPOCHS + 1, seed=SEED,
                resume=True)
    resume_s = time.perf_counter() - t0
    fit_launches = read_launches()
    steps = calls["ids"] + calls_2["ids"]
    moves = calls["moves"] + calls_2["moves"]
    wers = calls["wer"] + calls_2["wer"]
    layers = ModelConfig().num_layers
    # one CTC forward and backward a micro-step; none in validation
    expected = launch_counts(
        rel_attention_fwd=layers * (len(steps) + len(wers) * len(dev_set)),
        rel_attention_bwd=layers * len(steps), ctc=len(steps),
        ctc_bwd=len(steps), **dropout_counts(layers, len(steps)),
        **batch_norm_counts(len(steps)),
        **adamw_counts(len(steps) // 2, len(steps)))
    losses = torch.stack(steps).cpu().numpy()
    emit = [i % 2 == 1 for i in range(len(steps))]
    log(f"[rec] fit(): {len(calls['ids'])} micro-steps in {FIT_EPOCHS} "
        f"epochs in {fit_s:.2f} s, then {len(calls_2['ids'])} resumed in "
        f"{resume_s:.2f} s, {len(calls['host']) + len(calls_2['host'])} "
        f"host-packed; validation WER {np.round(wers, 4).tolist()}; "
        f"losses {np.round(losses, 3).tolist()}")
    log(f"[rec] launches in the fit() and resume windows {fit_launches} "
        f"(expected {expected}: 6 forward and 6 backward attention and one "
        f"CTC forward and backward a micro-step, 6 forward attention and "
        f"no CTC a validation utterance)")
    log(f"[rec] the weights moved at micro-steps "
        f"{[i + 1 for i, (_, m) in enumerate(moves) if m]} of "
        f"{len(moves)} (every second); the resumed state before its first "
        f"micro-step equals the saved one: {restored}")
    if calls["host"] or calls_2["host"] or any(o is None for o in steps):
        raise AssertionError("fit() left the device-corpus path")
    if fit_launches != expected:
        raise AssertionError(f"fit() launches {fit_launches}, expected "
                             f"{expected}")
    if [e for e, _ in moves] != emit or [m for _, m in moves] != emit:
        raise AssertionError(f"the weights must move at every second "
                             f"micro-step only: {moves}")
    if not restored or not all(restored.values()):
        raise AssertionError(f"resume restored another state: {restored}")
    if not np.isfinite(losses).all() or len(wers) != FIT_EPOCHS + 1:
        raise AssertionError("a recognition loss is not finite, or an "
                             "epoch was not validated")

    # the native beam search against the plain one on one utterance
    example = min(dev_set, key=lambda e: e["emg"].shape[0])
    lp = resumed.predict_logits(example)
    lm = resumed._get_lm()
    cfg = resumed.train_cfg
    beams = {}
    for name, fn in (("native", beam_ctc_decode),
                     ("plain", beam_ctc_decode_plain)):
        t0 = time.perf_counter()
        ids = fn(lp, tt.chars, resumed.blank_id, beam_width=REC_BEAM_CHECK,
                 lm=lm, alpha=cfg.lm_alpha, beta=cfg.lm_beta)
        beams[name] = (ids, time.perf_counter() - t0)
    same = beams["native"][0] == beams["plain"][0]
    log(f"[rec] beam width {REC_BEAM_CHECK} with the bigram LM over "
        f"{lp.shape[0]} frames: native {beams['native'][1] * 1e3:.1f} ms, "
        f"plain {beams['plain'][1] * 1e3:.1f} ms, "
        f"{tt.int_to_text(beams['native'][0])!r}; identical ids: {same}")
    if not same:
        raise AssertionError("the native beam search disagrees with the "
                             "plain one")
    del resumed
    torch.cuda.empty_cache()

    # an f32 micro-step with the kernels, then with the plain attention
    batch_ids = id_batches[0]
    runs = {}
    for mode in ("kernels", "plain"):
        tr = trainer(SEED, compute_dtype="float32")
        batch = tr._pack([train_set[i] for i in batch_ids])
        with contextlib.ExitStack() as stack:
            if mode == "plain":
                stack.enter_context(swapped(transformer, "rel_attention",
                                            rel_attention_plain))
            loss = tr.train_step(batch, 1e-4)
        params = dict(tr.model.named_parameters())
        runs[mode] = (loss.item(), {n: params[n].grad.detach().clone()
                                    for n in COMPARED_GRADS
                                    if n in params})
        del tr, params
        torch.cuda.empty_cache()
    (k_loss, k_grads), (p_loss, p_grads) = runs["kernels"], runs["plain"]
    rel = abs(k_loss - p_loss) / abs(p_loss)
    log(f"[rec] f32 micro-step, kernels vs plain: loss {k_loss:.6f} vs "
        f"{p_loss:.6f}, rel err {rel:.3g} (tolerance {STEP_LOSS_RTOL})")
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError("the f32 recognition micro-step with the "
                             "kernels disagrees with the plain version")
    for name, ref in p_grads.items():
        err = (k_grads[name] - ref).abs().max().item()
        tol = STEP_GRAD_RTOL * ref.abs().max().item()
        log(f"[rec]   grad {name}: max_abs_err {err:.3g} (tolerance "
            f"{tol:.3g} = {STEP_GRAD_RTOL} x max|ref|) "
            f"{'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            raise AssertionError(f"gradient of {name} disagrees")

    # the trained model.pt, exported and served: one /v1/recognize
    bundle_dir = export.main(["--models", os.path.join(out_dir, "model.pt"),
                              "--output_directory",
                              os.path.join(work, "serving"),
                              "--recognition"])
    server = ServingServer(recognition=export.ServingBundle.load(
        bundle_dir, device="cuda")).start()
    try:
        reset_launches()
        reply = post(server.port, "/v1/recognize",
                     {"emg": example["emg"].tolist(),
                      "raw_emg": example["raw_emg"].tolist()})
        serve_launches = read_launches()
    finally:
        server.stop()
    out = np.asarray(reply["log_probs"], np.float32)
    ok = (out.shape == lp.shape and np.isfinite(out).all()
          and isinstance(reply["text"], str)
          and serve_launches["rel_attention_fwd"] == layers
          and sum(serve_launches.values()) == layers)
    log(f"[rec] /v1/recognize from the trained model.pt: log-probs "
        f"{out.shape}, text {reply['text']!r}, launches {serve_launches} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the recognize request failed")
    logging.getLogger().removeHandler(handler)
    return fit_launches, serve_launches, captured["args"]


def streaming_run(card, model_pt, work):
    """Phase 6c, streaming at full width: phase 6's trained recognizer fed
    a seeded synthetic board in hops on a simulated clock (6 forward
    attention launches a recompute), its final transcript against the
    offline greedy decode of the same samples; the synthesizer with the
    seeded V1 vocoder against the offline vocode(inverse(predict)); the
    latency of a recompute at 5 s and 20 s buffers; the demo CLI. Returns
    the launches of the streamed recomputes."""
    import subprocess
    import types

    import torch
    from silent_speech_tpu_torch.capture import recorder
    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.data.normalizers import load_normalizers
    from silent_speech_tpu_torch.eval import streaming
    from silent_speech_tpu_torch.eval.decode import greedy_ctc_decode
    from silent_speech_tpu_torch.models.hifigan import Vocoder
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer

    t_phase = time.perf_counter()
    layers = ModelConfig().num_layers
    # the demo as a user runs it, in a process of its own beside the
    # checks below (the latency is timed after it has ended)
    t_demo = time.perf_counter()
    demo = subprocess.Popen(
        [sys.executable, "-m", "silent_speech_tpu_torch.eval.streaming",
         "--seconds", "2", "--model", model_pt], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        rec = streaming.demo_trainer(model_pt, "cuda")   # strict, full width

        def board_chunks(seconds):
            """The board's samples, one (n, 8) chunk a hop of a simulated
            clock."""
            clock = [0.0]
            fake_time = types.SimpleNamespace(monotonic=lambda: clock[0])
            with swapped(recorder, "time", fake_time):
                board = recorder.SyntheticBoard(seed=SEED)
                board.start_stream()
                for _ in range(int(round(seconds / STREAM_HOP_S))):
                    clock[0] += STREAM_HOP_S
                    yield board.get_board_data()[:8].T

        recomputes = []
        predict = rec.predict_logits
        rec.predict_logits = lambda ex: recomputes.append(1) or predict(ex)
        stream = streaming.StreamingRecognizer(rec, hop_s=STREAM_HOP_S)
        fed = []
        reset_launches()
        for chunk in board_chunks(STREAM_SECONDS):
            fed.append(chunk)
            stream.feed(chunk)
            stream.transcript()
        text = stream.transcript(force=True)
        torch.cuda.synchronize()
        launches = read_launches()
        del rec.predict_logits
        window = np.concatenate(fed)[-stream.max_window:]
        offline = rec.text_transform.int_to_text(greedy_ctc_decode(
            rec.predict_logits(streaming.featurize_raw_window(window)),
            rec.blank_id))
        expected = launch_counts(rel_attention_fwd=layers * len(recomputes))
        ok = text == offline and launches == expected and len(recomputes) > 1
        log(f"[stream] recognizer from phase 6's model.pt (d=768, {layers} "
            f"layers), a seeded board in hops of {STREAM_HOP_S} s for "
            f"{STREAM_SECONDS} s ({window.shape[0]} samples, "
            f"{len(recomputes)} recomputes): transcript {text[:40]!r} equal to "
            f"the offline greedy decode: {text == offline}; launches {launches} "
            f"(expected {expected}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the streamed transcript is not the offline "
                                 "decode, or launched otherwise")

        # the synthesizer: a full-width transducer from SEED, the seeded V1
        trans = TransductionTrainer(device="cuda")
        trans.init_state(SEED)
        norm_path = os.path.join(work, "stream_normalizers.pkl")
        write_normalizers(norm_path)
        mfcc_norm, _ = load_normalizers(norm_path)
        voc_path, _ = write_seeded_vocoder(os.path.join(work, "stream_hifigan"))
        vocoder = Vocoder(voc_path, device="cuda")
        synth = streaming.StreamingSynthesizer(trans, mfcc_norm, vocoder,
                                               hop_s=STREAM_HOP_S)
        fed = []
        for chunk in board_chunks(STREAM_SYNTH_SECONDS):
            fed.append(chunk)
            synth.feed(chunk)
            synth.audio()
        audio = synth.audio(force=True)
        window = np.concatenate(fed)[-synth.max_window:]
        ex = streaming.featurize_raw_window(window)
        offline = np.asarray(vocoder(mfcc_norm.inverse(trans.predict(ex))),
                             np.float32).reshape(-1)
        ok = (audio.shape == (ex["emg"].shape[0] * 256,)
              and np.isfinite(audio).all() and np.array_equal(audio, offline))
        log(f"[stream] synthesizer (d=768 transducer from seed {SEED}, seeded "
            f"V1 vocoder), {STREAM_SYNTH_SECONDS} s in hops: audio "
            f"{audio.shape[0]} samples, equal to the offline "
            f"vocode(inverse(predict)): {np.array_equal(audio, offline)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the streamed audio is not the offline audio")
        del trans, vocoder, synth
        torch.cuda.empty_cache()

        out, err = demo.communicate(timeout=300)
    finally:
        if demo.poll() is None:   # a check above failed, or the demo hung
            demo.kill()
            demo.wait()
    last = out.strip().split("\r")[-1] if out else ""
    log(f"[stream] python -m silent_speech_tpu_torch.eval.streaming "
        f"--seconds 2 --model model.pt (beside the checks above): exit "
        f"{demo.returncode} in {time.perf_counter() - t_demo:.2f} s, last "
        f"line {last[:60]!r}")
    if demo.returncode != 0:
        raise AssertionError(f"the streaming demo failed:\n{err[-2000:]}")

    latency = {}
    for seconds in (5, 20):
        x = np.random.default_rng(SEED).normal(size=(seconds * 1000, 8)) * 30
        s = streaming.StreamingRecognizer(rec, hop_s=STREAM_HOP_S,
                                          max_window_s=seconds)
        s.feed(x)
        times = []
        for _ in range(1 + STREAM_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.transcript(force=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        latency[seconds] = median_ms(times[1:])
    log(f"[time] {card} | streaming recompute latency (host featurization "
        f"in float64, the full-width forward, the greedy decode), median of "
        f"{STREAM_TIMED} after one: 5 s buffer {latency[5]:.2f} ms, 20 s "
        f"buffer {latency[20]:.2f} ms")
    del rec
    torch.cuda.empty_cache()

    log(f"[stream] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, latency


def _gan_weights(trainer):
    import torch

    return {**{f"generator.{k}": v.detach().clone()
               for k, v in trainer.generator.state_dict().items()},
            **{f"disc.{k}": v.detach().clone()
               for k, v in trainer.disc.state_dict().items()}}


def vocoder_run(card, work):
    """The vocoder phase: bench_vocoder's line, then the full-width GAN
    trainer (V1 generator, MPD 2/3/5/7/11 + 3-scale MSD) on segments of
    wavs written here: steps/s, device busy and idle share, moving
    weights, two steps from one state bit-equal, an exact resume. Returns
    the launches of the GAN steps (none of the ported kernels)."""
    import torch
    from silent_speech_tpu_torch import bench_vocoder
    from silent_speech_tpu_torch.train.vocoder import (VocoderDataSource,
                                                       VocoderTrainer)
    from silent_speech_tpu_torch.utils.audio_io import write_wav

    t_phase = time.perf_counter()
    line = bench_vocoder.main([])
    log(f"[voc] bench_vocoder: {line['value']} x real time, TF32 "
        f"convolutions {line['tf32_conv']}")

    rng = np.random.default_rng(SEED)
    n = int(GAN_WAV_SECONDS * 22050)
    t = np.arange(n) / 22050
    for i in range(GAN_WAVS):
        audio = 0.4 * np.sin(2 * np.pi * (120 + 45 * i) * t) \
            + 0.02 * rng.normal(size=n)
        write_wav(os.path.join(work, f"{i}.wav"), audio.astype(np.float32),
                  22050)
    batches = VocoderDataSource(work, seed=SEED).batches(GAN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer = VocoderTrainer(device="cuda")
    n_gen = sum(p.numel() for p in trainer.generator.parameters())
    n_disc = sum(p.numel() for p in trainer.disc.parameters())
    before = _gan_weights(trainer)

    reset_launches()
    metrics = []
    step = 0
    for n_steps, timed in ((GAN_WARMUP, False), (GAN_TIMED, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            mels, audio = next(batches)
            metrics.append(trainer.train_step(
                mels, audio, trainer.learning_rate(step, 1000)))
            step += 1
        torch.cuda.synchronize()
        if timed:
            rate = n_steps / (time.perf_counter() - t0)
    launches = read_launches()
    values = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    after = _gan_weights(trainer)
    moved = {part: sum(not torch.equal(before[k], after[k])
                       for k in before if k.startswith(part))
             for part in ("generator.", "disc.")}
    counts = {part: sum(k.startswith(part) for k in before)
              for part in moved}
    finite = all(np.isfinite(v).all() for v in values.values())
    log(f"[voc] GAN trainer: generator {n_gen} and discriminators {n_disc} "
        f"parameters, batch {GAN_BATCH} x 32 frames; metrics "
        f"{ {k: np.round(v, 4).tolist() for k, v in values.items()} }; "
        f"moved: {moved['generator.']}/{counts['generator.']} generator and "
        f"{moved['disc.']}/{counts['disc.']} discriminator tensors; "
        f"launches {launches}")
    if (not finite or not all(moved.values())
            or launches != launch_counts(**adamw_counts(2 * step))):
        raise AssertionError("the GAN steps failed: a metric not finite, "
                             "a model that did not move, or a kernel "
                             "launched but the two updates a step")

    def profiled():
        for _ in range(GAN_PROFILED):
            trainer.train_step(*next(batches), trainer.learning_rate(0, 1000))

    prof = device_profile(card, f"{GAN_PROFILED} GAN steps (batch "
                          f"{GAN_BATCH} x 32 frames)", profiled, top=8)
    busy, idle = "not measured", "not measured"
    if prof is not None:
        busy = fmt_ms(prof[1] / GAN_PROFILED)
        idle = f"{1 - prof[1] / prof[0]:.1%}"
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[time] {card} | GAN step, V1 generator + MPD + MSD, batch "
        f"{GAN_BATCH} x 32 frames, cuDNN deterministic: {rate:.3f} steps/s "
        f"over {GAN_TIMED} after {GAN_WARMUP}; under the profiler device "
        f"busy a step {busy}, idle share {idle}; peak memory "
        f"{peak / 2**30:.2f} GiB over the {base / 2**30:.2f} GiB held "
        f"before the phase")

    # one state, one batch: two steps bit-equal, and a resume in a fresh
    # trainer equal to the uninterrupted step
    state_dir = os.path.join(work, "state")
    trainer.save_state(state_dir, step=step)
    mels, audio = next(batches)
    lr = trainer.learning_rate(step, 1000)
    runs = []
    for resumed in (False, False, True):
        if resumed:
            del trainer
            torch.cuda.empty_cache()
            trainer = VocoderTrainer(seed=SEED + 1, device="cuda")
        if trainer.load_state(state_dir) != step:
            raise AssertionError("the saved step did not come back")
        m = trainer.train_step(mels, audio, lr)
        runs.append((m, _gan_weights(trainer)))
    for name, (m, w) in (("repeat", runs[1]), ("resume", runs[2])):
        same_m = all(torch.equal(m[k], runs[0][0][k]) for k in m)
        differ = [k for k in w if not torch.equal(w[k], runs[0][1][k])]
        log(f"[voc] {name} of step {step + 1} from the saved state: metrics "
            f"equal {same_m}, {len(w) - len(differ)}/{len(w)} weight "
            f"tensors torch.equal")
        if not same_m or differ:
            raise AssertionError(f"the GAN step's {name} is not bit-equal: "
                                 f"{differ[:6]}")
    del trainer, runs
    torch.cuda.empty_cache()
    log(f"[voc] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return launches


def counted(cls, name, sink, silent_of):
    """Wrap the method ``cls.name`` in the block: each call that returns
    something appends ``silent_of(*args)`` (whether its batch has silent
    rows) to ``sink``."""
    orig = getattr(cls, name)

    def wrapped(self, *args):
        out = orig(self, *args)
        if out is not None:
            sink.append(silent_of(*args))
        return out

    return swapped(cls, name, wrapped)


def log_lines(path, prefix):
    with open(path) as f:
        return [line.strip() for line in f if line.startswith(prefix)]


def held_to_host(got_examples, want_examples):
    """``featurize_on_device``'s examples against the host ``EMGDataset``
    path's, by HOST_RAW_REL, HOST_MIN_CORR and HOST_MEL_ATOL; the metadata
    must be equal (raises otherwise). Returns (largest error by key, least
    raw_emg correlation, max |raw|, within the bounds)."""
    worst = {"raw_emg": 0.0, "audio_features": 0.0}
    corr, scale = 1.0, 0.0
    for i, (got, want) in enumerate(zip(got_examples, want_examples)):
        scale = max(scale, float(np.abs(want["raw_emg"]).max()))
        for key in worst:
            if got[key].shape != want[key].shape:
                raise AssertionError(f"example {i}: {key} shapes differ")
            worst[key] = max(worst[key],
                             float(np.abs(got[key] - want[key]).max()))
        corr = min(corr, float(np.corrcoef(got["raw_emg"].ravel(),
                                           want["raw_emg"].ravel())[0, 1]))
        for key in ("text_int", "session_ids", "phonemes"):
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(f"example {i}: {key} differs")
    ok = (worst["raw_emg"] <= HOST_RAW_REL * scale and corr > HOST_MIN_CORR
          and worst["audio_features"] <= HOST_MEL_ATOL)
    return worst, corr, scale, ok


def time_flac_decode(card, cfg, build_s):
    """Phase 7, the FLAC reads: every FLAC file of the disk corpus decoded
    by the native decoder (``utils/flac.read_flac``, the path of every
    corpus read) and by the plain one (``read_flac_bytes``), in turns
    native, plain, plain, native; each file's samples equal both ways.
    Returns the seconds of each pass by decoder."""
    from silent_speech_tpu_torch.utils import flac

    files = sorted(os.path.join(root, f) for d in (
        cfg.silent_data_directories + cfg.voiced_data_directories)
        for root, _, names in os.walk(d) for f in names
        if f.endswith(".flac"))
    secs, kept = {"native": [], "plain": []}, {}
    for way in ("native", "plain", "plain", "native"):
        t0 = time.perf_counter()
        out = []
        for path in files:
            if way == "native":
                out.append(flac.read_flac(path))
            else:
                with open(path, "rb") as f:
                    out.append(flac.read_flac_bytes(f.read()))
        secs[way].append(time.perf_counter() - t0)
        kept.setdefault(way, out)
    equal = all(a[1] == b[1] and np.array_equal(a[0], b[0])
                for a, b in zip(kept["native"], kept["plain"]))
    samples = sum(a[0].shape[0] for a in kept["native"])
    native_s, plain_s = min(secs["native"]), min(secs["plain"])
    log(f"[time] {card} | FLAC decode of the disk corpus's {len(files)} "
        f"files ({samples} samples, {samples / 22050:.1f} s at 22.05 kHz), "
        f"in turns native, plain, plain, native: native {secs['native']} s,"
        f" plain {secs['plain']} s; plain / native {plain_s / native_s:.1f}"
        f"x (best of two each); samples equal: {equal} "
        f"{'ok' if equal else 'FAIL'}; beside the corpus build (device "
        f"{build_s['device']} s, host {build_s['host']} s), whose file "
        f"reads take the native decoder")
    if not equal or not files:
        raise AssertionError("the native FLAC decoder disagrees with the "
                             "plain one on the disk corpus")
    return secs


def disk_run(card, work):
    """Phase 7: the entry points a user calls, on a corpus on disk, at full
    width. Returns the launches of the whole phase."""
    import torch
    from silent_speech_tpu_torch import (evaluate, make_normalizers,
                                         make_testset, recognition_model,
                                         transduction_model)
    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.data.dataset import EMGDataset
    from silent_speech_tpu_torch.data import device_featurize
    from silent_speech_tpu_torch.data.device_cache import DeviceCorpus
    from silent_speech_tpu_torch.data.device_featurize import \
        featurize_on_device
    from silent_speech_tpu_torch.data.synthetic import generate_corpus
    from silent_speech_tpu_torch.models.hifigan import Vocoder
    from silent_speech_tpu_torch.ops.filtfilt import filtfilt_chain
    from silent_speech_tpu_torch.train.recognition import RecognitionTrainer
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer
    from silent_speech_tpu_torch.utils.audio_io import read_audio

    t_phase = time.perf_counter()
    layers = ModelConfig().num_layers
    total = launch_counts()

    def add(counts):
        total.add(counts)

    t0 = time.perf_counter()
    cfg = generate_corpus(os.path.join(work, "corpus"), seed=SEED,
                          **DISK_CORPUS)
    gen_s = time.perf_counter() - t0
    data = ["--silent_data_directories",
            ",".join(cfg.silent_data_directories),
            "--voiced_data_directories",
            ",".join(cfg.voiced_data_directories),
            "--testset_file", cfg.testset_file,
            "--text_align_directory", cfg.text_align_directory,
            "--normalizers_file", cfg.normalizers_file]
    t0 = time.perf_counter()
    split = make_testset.main(data + ["--dev_size", str(DISK_SPLIT),
                                      "--test_size", str(DISK_SPLIT),
                                      "--split_seed", str(SEED)])
    make_normalizers.main(data)
    tools_s = time.perf_counter() - t0
    trainset = EMGDataset(cfg)
    devset, testset = EMGDataset(cfg, dev=True), EMGDataset(cfg, test=True)
    n_utts = sum(len(os.listdir(os.path.join(d, s)))
                 for d in (cfg.silent_data_directories
                           + cfg.voiced_data_directories)
                 for s in os.listdir(d)) // 3
    log(f"[disk] corpus of {n_utts} utterances (learnable, FLAC; "
        f"{DISK_CORPUS['n_voiced_sessions']} voiced, "
        f"{DISK_CORPUS['n_silent_sessions']} silent and "
        f"{DISK_CORPUS['n_nonparallel']} non-parallel session(s) of "
        f"{DISK_CORPUS['utterances_per_session']}) written in "
        f"{gen_s:.2f} s; make_testset ({len(split['dev'])} dev and "
        f"{len(split['test'])} test sentences) and make_normalizers in "
        f"{tools_s:.2f} s; splits of {len(trainset)} training, "
        f"{len(devset)} dev and {len(testset)} test utterances")

    # the transduction CLI: one epoch at the defaults (d=768, 6 layers),
    # its corpus featurized on the card, with the seeded V1 vocoder: the
    # epoch's wav and every dev utterance's, the judge absent
    run = os.path.join(work, "transduction")
    voc_path, _ = write_seeded_vocoder(os.path.join(work, "hifigan"))
    steps, evals, corpus_inputs = [], [], []

    def capture_chain(x, lengths, coeffs):
        corpus_inputs.append((x, lengths.clone(), coeffs))
        return filtfilt_chain(x, lengths, coeffs)

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(counted(
            TransductionTrainer, "train_step_ids", steps,
            lambda corpus, ids, lr: bool(corpus.silent_mask[list(ids)].any())))
        stack.enter_context(counted(TransductionTrainer, "train_step", steps,
                                    lambda b, lr: b.num_silent > 0))
        stack.enter_context(counted(TransductionTrainer, "eval_step", evals,
                                    lambda b, model=None: b.num_silent > 0))
        stack.enter_context(swapped(device_featurize, "filtfilt_chain",
                                    capture_chain))
        trainer = transduction_model.main(data + [
            "--output_directory", run, "--epochs", "1",
            "--hifigan_checkpoint", voc_path])
    torch.cuda.synchronize()
    tr_s = time.perf_counter() - t0
    launches = read_launches()
    add(launches)
    width = (trainer.model_cfg.model_size, trainer.model_cfg.num_layers,
             trainer.model_cfg.num_heads)
    del trainer
    torch.cuda.empty_cache()
    # a predict a vocoded utterance: the epoch's and each dev utterance's
    expected = launch_counts(
        rel_attention_fwd=layers * (len(steps) + len(evals) + 1
                                    + len(devset)),
        rel_attention_bwd=layers * len(steps),
        dtw_align=sum(steps) + sum(evals), filtfilt_chain=1,
        **dropout_counts(layers, len(steps)),
        **batch_norm_counts(len(steps)), **adamw_counts(len(steps)))
    finished = log_lines(os.path.join(run, "log.txt"), "finished epoch")
    built = log_lines(os.path.join(run, "log.txt"), "building the device")
    skipped = log_lines(os.path.join(run, "log.txt"), "ASR WER skipped")
    wavs = ["epoch_0_output.wav"] + [f"example_output_{i}.wav"
                                     for i in range(len(devset))]
    missing = [w for w in wavs if not os.path.isfile(os.path.join(run, w))]
    model_pt = os.path.join(run, "model.pt")
    log(f"[disk] transduction CLI, 1 epoch at d={width[0]}, {width[1]} "
        f"layers, {width[2]} heads, --hifigan_checkpoint (seeded V1): "
        f"{len(steps)} step(s), {len(evals)} validation batch(es) in "
        f"{tr_s:.2f} s; {built}; {finished}; {len(wavs) - len(missing)} of "
        f"{len(wavs)} wavs written (the epoch's, {len(devset)} dev); judge: "
        f"{[line[:60] for line in skipped]}; launches {launches} (expected "
        f"{expected}: one filter launch for the corpus, 6 forward attention "
        f"a vocoded utterance)")
    if (width != (768, 6, 8) or not steps or not finished
            or launches != expected or not os.path.isfile(model_pt)
            or missing or not skipped or len(corpus_inputs) != 1
            or "device featurization" not in " ".join(built)):
        raise AssertionError("the transduction CLI's epoch failed")

    # the corpus build (featurization and upload) timed both ways in turns,
    # on fresh datasets (the host path caches its examples); the first
    # examples of each way are then held to each other
    build_s, kept = {"device": [], "host": []}, {}
    for way in ("device", "host", "host", "device"):
        fresh = EMGDataset(cfg, cache=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        examples = (featurize_on_device(fresh, device="cuda")
                    if way == "device"
                    else [fresh[i] for i in range(len(fresh))])
        DeviceCorpus.build(examples, "cuda")
        torch.cuda.synchronize()
        build_s[way].append(time.perf_counter() - t0)
        kept.setdefault(way, examples)
    log(f"[time] {card} | corpus build of {len(trainset)} training "
        f"examples (files, featurization, upload), in turns device, host, "
        f"host, device: device {build_s['device']} s, host "
        f"{build_s['host']} s")
    decode_s = time_flac_decode(card, cfg, build_s)
    worst, corr, scale, ok = held_to_host(kept["device"], kept["host"])
    log(f"[disk] featurize_on_device on the card against the host "
        f"EMGDataset, {len(kept['device'])} training examples: raw_emg "
        f"max_abs_err {worst['raw_emg']:.4g} (tolerance {HOST_RAW_REL} x "
        f"max|raw| {scale:.4g}), correlation {corr:.6f} (> "
        f"{HOST_MIN_CORR}), audio_features max_abs_err "
        f"{worst['audio_features']:.4g} (tolerance {HOST_MEL_ATOL}); "
        f"metadata equal {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the device featurization disagrees with the "
                             "host path")

    # evaluate: model.pt twice, then alone with the vocoder
    groups = TransductionTrainer(data_cfg=cfg, device="cuda").eval_groups(
        testset)
    silent_groups = sum(any(testset[i]["silent"] for i in g)
                        for g in groups)
    results = {}
    for n in (2, 1):
        out_dir = os.path.join(work, f"eval{n}")
        reset_launches()
        t0 = time.perf_counter()
        loss, acc, confusion = evaluate.main(
            data + ["--output_directory", out_dir, "--models",
                    *[model_pt] * n]
            + (["--hifigan_checkpoint", voc_path] if n == 1 else []))
        results[n] = (loss, acc, confusion, read_launches(),
                      time.perf_counter() - t0,
                      log_lines(os.path.join(out_dir, "eval_log.txt"),
                                "loss: "))
        add(results[n][3])
    (loss, acc, confusion, launches, secs, line), single = \
        results[2], results[1]
    expected = launch_counts(rel_attention_fwd=2 * layers * len(groups),
                             dtw_align=silent_groups)
    rel = abs(loss - single[0]) / abs(single[0])
    ok = (np.isfinite(loss) and rel <= ENSEMBLE_RTOL and acc == single[1]
          and np.array_equal(confusion, single[2]) and launches == expected
          and single[3] == launch_counts(
              rel_attention_fwd=layers * (len(groups) + len(testset)),
              dtw_align=silent_groups)
          and line)
    log(f"[disk] evaluate --models model.pt model.pt on {len(testset)} test "
        f"utterances in {len(groups)} eval group(s), {secs:.2f} s: {line}; "
        f"alone: loss {single[0]:.6f}, accuracy {single[1]:.6f}; loss rel "
        f"diff {rel:.3g} (tolerance {ENSEMBLE_RTOL}), accuracy and confusion "
        f"equal: {acc == single[1] and np.array_equal(confusion, single[2])}"
        f"; launches {launches} (expected {expected}: 2 x {layers} forward "
        f"attention a group), alone {single[3]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the 2-model ensemble of one model.pt differs "
                             "from the model alone, or launched otherwise")

    # one of evaluate's wavs against vocode(inverse(predict)) computed here
    ref = TransductionTrainer(data_cfg=cfg, device="cuda")
    ref.init_state(SEED)
    ref.model.load_state_dict(torch.load(model_pt, map_location="cpu",
                                         weights_only=True), strict=True)
    want = np.clip(Vocoder(voc_path, device="cuda")(
        testset.mfcc_norm.inverse(ref.predict(testset[0]))), -1.0, 1.0)
    del ref
    got, rate = read_audio(os.path.join(work, "eval1",
                                        "example_output_0.wav"))
    n_wavs = sum(os.path.isfile(os.path.join(work, "eval1",
                                             f"example_output_{i}.wav"))
                 for i in range(len(testset)))
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    skipped = log_lines(os.path.join(work, "eval1", "eval_log.txt"),
                        "ASR WER skipped")
    ok = (rate == 22050 and err <= WAV_ATOL and n_wavs == len(testset)
          and skipped)
    log(f"[disk] evaluate --models model.pt --hifigan_checkpoint: {n_wavs} "
        f"of {len(testset)} wavs; example_output_0.wav ({got.shape[0]} "
        f"samples) against vocode(inverse(predict)) computed here: "
        f"max_abs_err {err:.3g} (tolerance {WAV_ATOL:.3g}, PCM16); judge "
        f"skipped: {bool(skipped)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("evaluate's vocoded wavs are wrong")

    vocoder_launches = disk_vocoder(work, data, model_pt, layers)

    # the recognition CLI: one epoch, then --evaluate_saved on its model.pt
    lm_path = os.path.join(work, "lm.arpa")
    write_bigram_arpa([trainset.example_meta(i)["text"]
                       for i in range(len(trainset))], lm_path)
    rec_run = os.path.join(work, "recognition")
    steps = []
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for name in ("train_step_ids", "train_step"):
            stack.enter_context(counted(RecognitionTrainer, name, steps,
                                        lambda *args: False))
        rec = recognition_model.main(data + [
            "--output_directory", rec_run, "--epochs", "1", "--lm_path",
            lm_path])
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    launches = read_launches()
    add(launches)
    updates = rec.optimizer.count
    del rec
    torch.cuda.empty_cache()
    expected = launch_counts(
        rel_attention_fwd=layers * (len(steps) + len(devset)),
        rel_attention_bwd=layers * len(steps), ctc=len(steps),
        ctc_bwd=len(steps), filtfilt_chain=1,
        **dropout_counts(layers, len(steps)),
        **batch_norm_counts(len(steps)),
        **adamw_counts(len(steps) // 2, len(steps)))
    finished = log_lines(os.path.join(rec_run, "log.txt"), "finished epoch")
    log(f"[disk] recognition CLI, 1 epoch: {len(steps)} micro-step(s), "
        f"{updates} update(s), {len(devset)} validation utterances in "
        f"{rec_s:.2f} s; {finished}; launches {launches} (expected "
        f"{expected}: one CTC forward and backward a micro-step)")
    if not steps or not finished or launches != expected:
        raise AssertionError("the recognition CLI's epoch failed")
    reset_launches()
    t0 = time.perf_counter()
    wer = recognition_model.main(data + [
        "--evaluate_saved", os.path.join(rec_run, "model.pt"),
        "--lm_path", lm_path, "--output_directory", rec_run])
    launches = read_launches()
    add(launches)
    expected = launch_counts(rel_attention_fwd=layers * len(testset))
    log(f"[disk] recognition --evaluate_saved model.pt: test WER {wer} over "
        f"{len(testset)} utterances in {time.perf_counter() - t0:.2f} s; "
        f"launches {launches} (expected {expected})")
    if not np.isfinite(wer) or launches != expected:
        raise AssertionError("--evaluate_saved failed")
    log(f"[disk] phase wall time {time.perf_counter() - t_phase:.1f} s "
        f"(of it the FLAC decode timing's {sum(map(sum, decode_s.values())):.1f}"
        f" s); launches {total} (the vocoder CLIs' apart)")
    return total, vocoder_launches, corpus_inputs[0], build_s


def capture_run(card, work, int8_bundle):
    """Phase 7b: the data-collection tree as a user runs it. A book of
    CAPTURE_SENTENCES sentences under ``build/``; the session CLI records
    each from the synthetic board (Enter lines on its stdin; the book ends
    the session) and the cleaning CLI writes the clean audio, both on the
    host; every file's schema is checked; the port's ``EMGDataset`` reads
    the session and ``featurize_on_device`` featurizes it on the card (one
    filter launch), held to the host path by phase 7's bounds; each
    utterance is served over HTTP from phase 3's int8 transduction bundle
    (6 forward attention launches each). Returns the launches."""
    import subprocess

    import torch
    from silent_speech_tpu_torch.config import DataConfig
    from silent_speech_tpu_torch.data.dataset import EMGDataset
    from silent_speech_tpu_torch.data.device_featurize import \
        featurize_on_device
    from silent_speech_tpu_torch.eval.server import ServingServer
    from silent_speech_tpu_torch.utils.audio_io import read_audio

    t_phase = time.perf_counter()
    book = os.path.join(work, "book.txt")
    with open(book, "w") as f:
        f.write(" ".join(CAPTURE_SENTENCES))
    sess = os.path.join(work, "voiced", "session0")
    runs = {}
    for name, argv, stdin in (
            ("session", ["silent_speech_tpu_torch.capture.session",
                         "--debug", "--seconds", str(CAPTURE_SECONDS),
                         "--book_file", book, "--output_directory", sess],
             "\n" * len(CAPTURE_SENTENCES)),
            ("clean_audio", ["silent_speech_tpu_torch.capture.clean_audio",
                             sess], "")):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", *argv], input=stdin,
                             capture_output=True, text=True, cwd=ROOT,
                             timeout=300)
        runs[name] = time.perf_counter() - t0
        log(f"[capture] python -m {argv[0]}: exit {run.returncode} in "
            f"{runs[name]:.2f} s; {run.stdout.strip().splitlines()[-1:]}")
        if run.returncode != 0:
            raise AssertionError(f"the {name} CLI failed: {run.stderr}")

    # the schema of every file
    n = len(CAPTURE_SENTENCES)
    problems = []
    for i in range(n):
        with open(os.path.join(sess, f"{i}_info.json")) as f:
            info = json.load(f)
        emg = np.load(os.path.join(sess, f"{i}_emg.npy"))
        button = np.load(os.path.join(sess, f"{i}_button.npy"))
        audio, rate = read_audio(os.path.join(sess, f"{i}_audio.flac"))
        clean, clean_rate = read_audio(os.path.join(
            sess, f"{i}_audio_clean.flac"))
        e_len, a_len, _ = info["chunks"][0]
        if (set(info) != {"text", "book", "sentence_index", "chunks"}
                or info["text"] != CAPTURE_SENTENCES[i]
                or info["sentence_index"] != i or info["book"] != "book"
                or emg.shape != (e_len, 8) or button.shape != (e_len,)
                or rate != 16000 or audio.shape != (a_len,)
                or clean_rate != 22050 or not np.abs(clean).max() <= 1.0
                or e_len < 0.95 * 1000 * CAPTURE_SECONDS):
            problems.append(i)
    with open(book + ".bookmark") as f:
        bookmark = f.read()
    log(f"[capture] {n} utterances of {CAPTURE_SECONDS} s: emg, button, "
        f"audio (16 kHz), info and clean audio (22.05 kHz) per the schema: "
        f"{'ok' if not problems else f'FAIL {problems}'}; bookmark "
        f"{bookmark}")
    if problems or bookmark != str(n):
        raise AssertionError("the captured session's files are wrong")

    # read as the trainers read a session; featurize it on the card
    data = EMGDataset(DataConfig(silent_data_directories=[],
                                 voiced_data_directories=[
                                     os.path.dirname(sess)]),
                      no_testset=True, no_normalizers=True)
    host = [data[i] for i in range(len(data))]
    total = launch_counts()
    reset_launches()
    dev = featurize_on_device(data, device="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    worst, corr, scale, held = held_to_host(dev, host)
    ok = (held and len(dev) == n
          and launches == launch_counts(filtfilt_chain=1))
    log(f"[capture] EMGDataset of the session, {len(dev)} examples of "
        f"{[ex['raw_emg'].shape[0] // 8 for ex in dev]} frames, featurized "
        f"on the card: launches {launches}; raw_emg max_abs_err "
        f"{worst['raw_emg']:.4g} (tolerance {HOST_RAW_REL} x max|raw| "
        f"{scale:.4g}), correlation {corr:.6f} (> {HOST_MIN_CORR}), "
        f"audio_features max_abs_err {worst['audio_features']:.4g} "
        f"(tolerance {HOST_MEL_ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the captured session's device featurization "
                             "failed")
    total.add(launches)

    # each utterance from phase 3's int8 transduction bundle
    layers = int8_bundle.model.cfg.num_layers
    server = ServingServer(transduction=int8_bundle).start()
    try:
        reset_launches()
        outs = [np.asarray(post(server.port, "/v1/transduce", {
            "emg": h["emg"].tolist(), "raw_emg": d["raw_emg"].tolist(),
            "session_ids": h["session_ids"].tolist()})["mel"], np.float32)
            for h, d in zip(host, dev)]
        launches = read_launches()
    finally:
        server.stop()
    ok = (launches == launch_counts(rel_attention_fwd=layers * n)
          and all(o.shape == (h["emg"].shape[0], 80) and np.isfinite(o).all()
                  for o, h in zip(outs, host)))
    log(f"[capture] {n} utterances served from the int8 transduction "
        f"bundle: mel shapes {[o.shape for o in outs]}, finite; launches "
        f"{launches} (expected {layers} forward attention each) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("serving the captured session failed")
    total.add(launches)
    log(f"[capture] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return total


def disk_vocoder(work, data, model_pt, layers):
    """Phase 7, the vocoder CLIs: make_vocoder_trainset from the
    transduction CLI's model.pt, finetune_vocoder for 2 steps from the
    seeded V1 checkpoint and a resume for a 3rd, and the fine-tuned
    generator bundled and vocoding one mel. Returns the launches by
    CLI."""
    import torch
    from silent_speech_tpu_torch import (finetune_vocoder,
                                         make_vocoder_trainset)
    from silent_speech_tpu_torch.eval import export
    from silent_speech_tpu_torch.models.hifigan import Vocoder
    from silent_speech_tpu_torch.train.transduction import \
        TransductionTrainer

    out = {}
    voc_data = os.path.join(work, "voc_data")
    utts = []
    reset_launches()
    t0 = time.perf_counter()
    with counted(TransductionTrainer, "get_aligned_prediction", utts,
                 lambda ex, norm: bool(ex["silent"])):
        n = make_vocoder_trainset.main(data + [
            "--model", model_pt, "--output_directory", voc_data])
    torch.cuda.synchronize()
    out["make_vocoder_trainset"] = launches = read_launches()
    expected = launch_counts(rel_attention_fwd=layers * len(utts),
                             dtw_align=sum(utts))
    names = sorted(os.listdir(os.path.join(voc_data, "mels")))
    mel = np.load(os.path.join(voc_data, "mels", names[0]))
    ok = (n == len(utts) == len(names) > 0 and sum(utts) > 0
          and launches == expected and mel.dtype == np.float32
          and mel.shape[:2] == (1, 80) and np.isfinite(mel).all())
    log(f"[disk] make_vocoder_trainset: {n} utterances ({sum(utts)} "
        f"silent) in {time.perf_counter() - t0:.2f} s, {names[0]} "
        f"{mel.shape} {mel.dtype}; launches {launches} (expected "
        f"{expected}: {layers} forward attention an utterance, one DTW a "
        f"silent one) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("make_vocoder_trainset failed")

    ckpt, _ = write_seeded_vocoder(os.path.join(work, "hifigan"))
    run = os.path.join(work, "finetune")
    args = ["--data_directory", voc_data, "--hifigan_checkpoint", ckpt,
            "--output_directory", run]
    reset_launches()
    t0 = time.perf_counter()
    first = finetune_vocoder.main(args + ["--steps", "2"])
    logged = log_lines(os.path.join(run, "log.txt"), "finetune done")
    final = finetune_vocoder.main(args + ["--steps", "1", "--resume"])
    out["finetune_vocoder"] = launches = read_launches()
    resumed = (log_lines(os.path.join(run, "log.txt"), "resumed")
               + log_lines(os.path.join(run, "log.txt"), "finetune done"))
    ok = (np.isfinite(list(first.values()) + list(final.values())).all()
          and any("at 2 total" in x for x in logged)
          and any("at step 2" in x for x in resumed)
          and any("at 3 total" in x for x in resumed)
          and launches == launch_counts(**adamw_counts(2 * 3)))
    log(f"[disk] finetune_vocoder --steps 2, then --resume --steps 1, in "
        f"{time.perf_counter() - t0:.2f} s: {logged}; {resumed}; launches "
        f"{launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("finetune_vocoder failed or did not resume")

    vocoder = Vocoder(os.path.join(run, "generator_finetuned.pt"),
                      config_path=os.path.join(work, "hifigan",
                                               "config.json"),
                      device="cuda")
    bundle = export.ServingBundle.load(export.save_vocoder_bundle(
        vocoder, os.path.join(work, "vocoder_finetuned")), device="cuda")
    mel = mel[0].T
    audio = bundle.vocode(mel)
    ok = (audio.shape == (mel.shape[0] * 256,) and np.isfinite(audio).all()
          and np.abs(audio).max() <= 1.0)
    log(f"[disk] generator_finetuned.pt bundled: {names[0]} vocoded to "
        f"{audio.shape} samples, max |audio| {np.abs(audio).max():.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fine-tuned generator did not vocode")
    return out


def time_ctc(card, rec_ctc, errs):
    """Phase 8, CTC: ms a launch of the forward and of the backward on a
    recognition micro-step's own inputs (captured in phase 6), against the
    bound, the plain version and ``F.ctc_loss`` forward and backward on the
    same rows. Returns the JSON entry's numbers."""
    import torch
    import torch.nn.functional as F
    from silent_speech_tpu_torch.ops.ctc import ctc_nll, ctc_nll_plain

    lp, utt_len, labels, text_len, blank = rec_ctc
    u, t, k = lp.shape
    s = labels.shape[1]
    weights = torch.ones(u, device="cuda")

    def forward():
        return ctc_nll(lp, utt_len, labels, text_len, blank)

    # the backward alone: one graph's backward, run again and again
    lp_bwd = lp.detach().clone().requires_grad_()
    graph = ctc_nll(lp_bwd, utt_len, labels, text_len, blank)

    def backward():
        return torch.autograd.grad(graph, lp_bwd, weights,
                                   retain_graph=True)[0]

    def both():
        return ctc_run(ctc_nll, lp, utt_len, labels, text_len, weights)

    # queued behind a sleeping kernel, so that the host's time a call does
    # not show; back to back for the time with it
    fwd_ms, bwd_ms, ms = (queued_ms(f) for f in (forward, backward, both))
    host_ms = cuda_time_ms(both, iters=20)
    # by kernel: the forward, and the backward's recursion and its
    # fixed-order gradient sum
    kernel_ms = {"ctc_fwd": device_ms_per_launch(forward, "ctc_fwd_kernel"),
                 **{k[:-7]: v for k, v in device_ms_by_kernel(
                     backward, ("ctc_bwd_kernel", "ctc_grad_kernel")).items()}}
    # no warm-up: the plain version ran at this shape in phase 2
    plain_ms = cuda_time_ms(lambda: ctc_run(ctc_nll_plain, lp, utt_len,
                                            labels, text_len, weights),
                            iters=1, warmup=0)
    real = (text_len > 0).nonzero()[:, 0]
    x = lp[real].detach().clone().requires_grad_()
    lib_targets = labels[real].clamp_min(0)

    def library():
        nll = F.ctc_loss(x.transpose(0, 1), lib_targets,
                         utt_len[real].long(), text_len[real].long(),
                         blank=blank, reduction="none")
        return nll, torch.autograd.grad(nll.sum(), x)[0]

    lib_nll, _ = library()
    ours = ctc_nll(lp, utt_len, labels, text_len, blank)[real]
    lib_rel = ((lib_nll - ours).abs() / ours.abs()).max().item()
    library_ms = queued_ms(library)
    library_host_ms = cuda_time_ms(library, iters=20)
    bound_ms, bound_by, bound_bytes = ctc_bound(lp, utt_len, labels,
                                                text_len)
    frames = int(utt_len.max())
    lat_ms = latency_bound_ms(frames, CTC_FWD_DEP_OPS + CTC_BWD_DEP_OPS)
    log(f"[kernel] ctc at a recognition micro-step's inputs: U={u} rows "
        f"({len(real)} with text), T={t}, S={s}, K={k}, longest "
        f"{frames} frames; F.ctc_loss on the {len(real)} rows with text "
        f"agrees with the kernel's NLL to {lib_rel:.3g} relative")
    log(f"[time] {card} | ctc (csrc/ctc.cu) U={u} T={t} S={s} K={k}, "
        f"device time a call (queued): forward {fwd_ms:.4f} ms (the "
        f"wrapper's int32 casts included), backward {bwd_ms:.4f} ms, "
        f"forward and backward through autograd {ms:.4f} ms ({host_ms:.4f} "
        f"ms back to back, the host's time included); by kernel (profiler) "
        + ", ".join(f"{n} {fmt_ms(v)}" for n, v in kernel_ms.items())
        + f"; plain {plain_ms:.2f} ms; F.ctc_loss forward and backward on "
        f"the {len(real)} rows with text {library_ms:.4f} ms "
        f"({library_host_ms:.4f} back to back); bound {bound_ms:.5f} ms "
        f"({bound_by}: {bound_bytes} bytes, the live frames' log-probs in "
        f"and the dense gradient out), {bound_ms / ms:.2%} of bound; what "
        f"limits it is the "
        f"chain of {frames} dependent frames each way: "
        f"{fwd_ms * 1e6 / frames:.0f} ns a frame forward, "
        f"{bwd_ms * 1e6 / frames:.0f} ns backward; latency bound "
        f"{fmt_ms(lat_ms)} ({frames} frames x {CTC_FWD_DEP_OPS} + "
        f"{CTC_BWD_DEP_OPS} dependent FP32 operations x {DEP_CYCLES} cycles "
        f"at the maximum SM clock {max_sm_clock_hz()} Hz)")
    return {"shape": f"U={u} ({len(real)} with text) T={t} S={s} K={k} "
                     f"f32, longest {frames} frames",
            "max_abs_err": max(errs[("ctc", c)]
                               for c in (False, True, "edges")),
            "ms": ms, "ms_forward": fwd_ms, "ms_backward": bwd_ms,
            "ms_back_to_back": host_ms,
            "device_ms_by_kernel": kernel_ms,
            "ns_per_frame_forward": fwd_ms * 1e6 / frames,
            "ns_per_frame_backward": bwd_ms * 1e6 / frames,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "latency_bound_ms": lat_ms, "library_ms": library_ms,
            "library_ms_back_to_back": library_host_ms,
            "library_rows": len(real)}


def time_kernels(card, path_launches, errs, dtw_inputs, aligned_inputs,
                 rec_ctc, f32_step):
    """Phase 8, kernels: ms per launch at the main path's shapes, against
    the bound and the plain version. Returns the kernels JSON entries."""
    import torch
    from silent_speech_tpu_torch.ops.dtw import (
        dtw_align_batch, dtw_align_batch_plain)
    from silent_speech_tpu_torch.ops.rel_attention import (
        STAGES, _staged_bwd, attention_drop_threshold, rel_attention,
        rel_attention_bwd, rel_attention_plain)

    drop = attention_drop_threshold(0.2)
    for t in (256, 1024, 2048):
        q, k, v, e = attention_inputs(1, t, torch.bfloat16, seed=7)
        ms = cuda_time_ms(lambda: rel_attention(q, k, v, e, 100, t))
        dev_ms = device_ms_per_launch(
            lambda: rel_attention(q, k, v, e, 100, t), FWD_KERNEL)
        plain_ms = cuda_time_ms(
            lambda: rel_attention_plain(q, k, v, e, 100, t), iters=10)
        bound_ms, bound_by = attention_bound(1, 8, t, 96, 100, t,
                                             "bfloat16")
        log(f"[time] {card} | rel_attention_fwd bf16 B=1 H=8 T={t} d_h=96 "
            f"m=100 (serving): kernel {ms:.4f} ms/launch back to back "
            f"(the wrapper's host time included), {fmt_ms(dev_ms)} device "
            f"time per launch (profiler), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / (dev_ms or ms):.2%} "
            f"of bound ({'device time' if dev_ms else 'back to back'})")
        if t == HEADLINE_T:
            serve_ms, serve_dev_ms = ms, dev_ms

    b, t = TRAIN_BT
    q, k, v, e = attention_inputs(b, t, torch.bfloat16, seed=8)
    fwd_ms = cuda_time_ms(
        lambda: rel_attention(q, k, v, e, 100, None, 3, drop), iters=20)
    fwd_dev_ms = device_ms_per_launch(
        lambda: rel_attention(q, k, v, e, 100, None, 3, drop), FWD_KERNEL)
    log(f"[time] {card} | rel_attention_fwd bf16 B={b} H=8 T={t} (training): "
        f"{fmt_ms(fwd_dev_ms)} device time per launch (profiler)")
    fwd_plain = cuda_time_ms(
        lambda: rel_attention_plain(q, k, v, e, 100, None, 3, drop),
        iters=5)
    fwd_bound = attention_bound(b, 8, t, 96, 100, t, "bfloat16")
    sdpa_ms = sdpa_yardstick_ms(q, k, v, e)
    log(f"[time] {card} | yardstick: torch scaled_dot_product_attention "
        f"bf16 B={b} H=8 T={t} d_h=96, the skewed relative bias and the "
        f"band mask precomputed as one (B, H, T, T) bf16 mask, dropout off "
        f"(not the same function; the port never calls it): {sdpa_ms:.4f} "
        f"ms/call against the kernel's {fwd_ms:.4f} ms")
    g = torch.Generator(device="cuda").manual_seed(9)
    dout = torch.randn(q.shape, device="cuda", generator=g).to(q.dtype)
    bwd_ms = cuda_time_ms(
        lambda: rel_attention_bwd(q, k, v, e, dout, 100, None, 3, drop),
        iters=10)
    _, stages, _ = _staged_bwd(q, k, v, e, dout, 100, t, 3, drop)
    stages_ms = {name: cuda_time_ms(launch, iters=10)
                 for name, launch in stages}
    del stages
    log(f"[time] {card} | rel_attention_bwd bf16 B={b} H=8 T={t} d_h=96 "
        f"m=100 dropout 0.2, by stage: "
        + ", ".join(f"{n} {stages_ms[n]:.4f} ms" for n in STAGES)
        + f" (sum {sum(stages_ms.values()):.4f} ms)")
    # the recognition micro-step's shape
    rb, rt = REC_BT
    rq, rk, rv, re_ = attention_inputs(rb, rt, torch.bfloat16, seed=10)
    rdout = torch.randn(rq.shape, device="cuda", generator=g).to(rq.dtype)
    rxs = [x.detach().requires_grad_() for x in (rq, rk, rv, re_)]
    rout = rel_attention_plain(*rxs, 100, None, 3, drop)
    rec = {}
    for name, ms, plain_ms, (bound_ms, bound_by) in (
            ("rel_attention_fwd",
             cuda_time_ms(lambda: rel_attention(rq, rk, rv, re_, 100, None,
                                                3, drop), iters=20),
             cuda_time_ms(lambda: rel_attention_plain(
                 rq, rk, rv, re_, 100, None, 3, drop), iters=5),
             attention_bound(rb, 8, rt, 96, 100, rt, "bfloat16")),
            ("rel_attention_bwd",
             cuda_time_ms(lambda: rel_attention_bwd(
                 rq, rk, rv, re_, rdout, 100, None, 3, drop), iters=10),
             cuda_time_ms(lambda: torch.autograd.grad(
                 rout, rxs, rdout, retain_graph=True), iters=3),
             attention_bwd_bound(rb, 8, rt, 96, 100, "bfloat16"))):
        rec[name] = {"shape": f"B={rb} H=8 T={rt} d_h=96 m=100 bf16 dropout "
                              f"0.2",
                     "max_abs_err": errs[(f"{name}_recognition",
                                          "bfloat16")],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        log(f"[time] {card} | {name} bf16 B={rb} H=8 T={rt} d_h=96 m=100 "
            f"dropout 0.2 (recognition micro-step): kernel {ms:.4f} "
            f"ms/launch, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), {bound_ms / ms:.2%} of bound")
    rec32 = [x.float() for x in (rq, rk, rv, re_, rdout)]
    rec_bwd_f32 = cuda_time_ms(lambda: rel_attention_bwd(
        *rec32, 100, None, 3, drop), iters=5)
    rec["rel_attention_bwd"].update(
        ms_f32=rec_bwd_f32, bound_ms_f32=attention_bwd_bound(
            rb, 8, rt, 96, 100, "float32")[0])
    log(f"[time] {card} | rel_attention_bwd f32 B={rb} H=8 T={rt} d_h=96 "
        f"m=100 dropout 0.2 (recognition micro-step under --compute_dtype "
        f"float32): {rec_bwd_f32:.4f} ms/launch, bound "
        f"{rec['rel_attention_bwd']['bound_ms_f32']:.5f} ms")
    del rq, rk, rv, re_, rdout, rxs, rout, rec32

    q32, k32, v32, e32, dout32 = (x.float() for x in (q, k, v, e, dout))
    fwd_f32_ms = cuda_time_ms(
        lambda: rel_attention(q32, k32, v32, e32, 100, None, 3, drop),
        iters=10)
    fwd_f32_bound = attention_bound(b, 8, t, 96, 100, t, "float32")
    log(f"[time] {card} | rel_attention_fwd f32 B={b} H=8 T={t} d_h=96 "
        f"m=100 dropout 0.2 (csrc/rel_attention_fwd.cu, the "
        f"--compute_dtype float32 path): {fwd_f32_ms:.4f} ms/launch, bound "
        f"{fwd_f32_bound[0]:.5f} ms ({fwd_f32_bound[1]}), "
        f"{fwd_f32_bound[0] / fwd_f32_ms:.2%} of bound")
    bwd_f32_ms = cuda_time_ms(
        lambda: rel_attention_bwd(q32, k32, v32, e32, dout32, 100, None, 3,
                                  drop), iters=5)
    _, stages, _ = _staged_bwd(q32, k32, v32, e32, dout32, 100, t, 3, drop)
    stages_f32_ms = {name: cuda_time_ms(launch, iters=5)
                     for name, launch in stages}
    del stages
    xs = [x.detach().requires_grad_() for x in (q32, k32, v32, e32)]
    out = rel_attention_plain(*xs, 100, None, 3, drop)
    bwd_f32_plain = cuda_time_ms(lambda: torch.autograd.grad(
        out, xs, dout32, retain_graph=True), iters=3)
    del q32, k32, v32, e32, dout32, xs, out
    bwd_f32_bound = attention_bwd_bound(b, 8, t, 96, 100, "float32")
    log(f"[time] {card} | rel_attention_bwd f32 B={b} H=8 T={t} d_h=96 "
        f"m=100 dropout 0.2 (four staged kernels, the --compute_dtype "
        f"float32 path): {bwd_f32_ms:.4f} ms/launch, by stage "
        + ", ".join(f"{n} {stages_f32_ms[n]:.4f} ms" for n in STAGES)
        + f"; plain (autograd) {bwd_f32_plain:.4f} ms, bound "
        f"{bwd_f32_bound[0]:.5f} ms ({bwd_f32_bound[1]}), "
        f"{bwd_f32_bound[0] / bwd_f32_ms:.2%} of bound")
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
    dtw_dev_ms = device_ms_per_launch(
        lambda: dtw_align_batch(costs, n1, n2), DTW_KERNEL)
    dp_dev_ms = device_ms_per_launch(
        lambda: dtw_align_batch(costs, n1, n2, dp_only=True), DTW_KERNEL)
    dtw_plain = cuda_time_ms(lambda: dtw_align_batch_plain(costs, n1, n2),
                             iters=1, warmup=1)
    dp_plain = cuda_time_ms(lambda: dtw_align_batch_plain(
        costs, n1, n2, dp_only=True), iters=1, warmup=1)
    dtw_b = dtw_bound(n1.cpu().numpy(), n2.cpu().numpy(), t1, 2)
    diagonals = int((n1 + n2 - 1).max())
    dp_ns_diag = dp_ms * 1e6 / diagonals
    log(f"[time] {card} | dtw_align bf16 costs K={kk} T={t1} (the training "
        f"batch's silent slice, n1 {n1.tolist()}, n2 {n2.tolist()}): "
        f"kernel {dtw_ms:.4f} ms/launch, dp_only {dp_ms:.4f} ms "
        f"(backtrace share {1 - dp_ms / dtw_ms:.1%}), plain {dtw_plain:.2f} "
        f"ms, plain dp_only {dp_plain:.2f} ms, bound {dtw_b[0]:.5f} ms "
        f"({dtw_b[1]}), {dtw_b[0] / dtw_ms:.2%} of bound")
    log(f"[time] {card} | dtw_align, {diagonals} diagonals (max n1 + n2 - "
        f"1): dp_only {dp_ns_diag:.1f} ns a diagonal, backtrace "
        f"{dtw_ms - dp_ms:.4f} ms; device time per launch (profiler) "
        f"{fmt_ms(dtw_dev_ms)}, dp_only {fmt_ms(dp_dev_ms)}")

    shape = f"B={b} H=8 T={t} d_h=96 m=100 bf16 dropout 0.2"

    # the DTW of get_aligned_prediction: K = 1, f32 costs
    a_costs, a_n1, a_n2 = aligned_inputs
    a_ms = cuda_time_ms(lambda: dtw_align_batch(a_costs, a_n1, a_n2),
                        iters=10)
    a_plain = cuda_time_ms(lambda: dtw_align_batch_plain(a_costs, a_n1,
                                                         a_n2),
                           iters=1, warmup=1)
    a_bound = dtw_bound(a_n1.cpu().numpy(), a_n2.cpu().numpy(),
                        a_costs.shape[1], 4)
    a_shape = f"K=1 T1={a_costs.shape[1]} T2={a_costs.shape[2]} f32 costs"
    log(f"[time] {card} | dtw_align {a_shape} (get_aligned_prediction): "
        f"kernel {a_ms:.4f} ms/launch, plain {a_plain:.2f} ms, bound "
        f"{a_bound[0]:.5f} ms ({a_bound[1]}), {a_bound[0] / a_ms:.2%} of "
        f"bound")

    def launches(name):
        by_path = {path: counts[name]
                   for path, counts in path_launches.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    def f32_launches(name):
        """Of an attention kernel's launches, those of the f32 route by
        path (None where a path's count lost its f32 share)."""
        by_path = {path: (None if getattr(counts, "f32", None) is None
                          else counts.f32[name])
                   for path, counts in path_launches.items()}
        return {"launches_f32": sum(v for v in by_path.values() if v),
                "launches_f32_by_path": by_path}

    return [
        {"name": "rel_attention_fwd", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/rel_attention_fwd_wmma.cu",
         "source_f32": "silent_speech_tpu_torch/csrc/rel_attention_fwd.cu",
         "replaces": "silent_speech_tpu/ops/pallas/rel_attention.py:386",
         "shape": shape, **launches("rel_attention_fwd"),
         **f32_launches("rel_attention_fwd"),
         "max_abs_err": errs[("rel_attention_fwd", "bfloat16")],
         "max_abs_err_unrounded_plain": errs[("rel_attention_fwd_unrounded",
                                              "bfloat16")],
         "max_abs_err_f32": errs[("rel_attention_fwd", "float32")],
         "max_err_offsets": errs[("rel_attention_offsets", "bfloat16")],
         "ms": fwd_ms, "device_ms": fwd_dev_ms, "ms_f32": fwd_f32_ms,
         "bound_ms_f32": fwd_f32_bound[0], "bound_by_f32": fwd_f32_bound[1],
         "plain_ms": fwd_plain,
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
         "library_ms": None, "sdpa_yardstick_ms": sdpa_ms,
         "serve_ms_T1024": serve_ms,
         "serve_device_ms_T1024": serve_dev_ms,
         "recognition": rec["rel_attention_fwd"]},
        {"name": "rel_attention_bwd", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/rel_attention_bwd_wmma.cu",
         "source_f32": "silent_speech_tpu_torch/csrc/rel_attention_bwd.cu",
         "replaces": "silent_speech_tpu/ops/pallas/rel_attention.py:414",
         "shape": shape, **launches("rel_attention_bwd"),
         **f32_launches("rel_attention_bwd"),
         "max_abs_err": errs[("rel_attention_bwd", "bfloat16")],
         "max_abs_err_f32": errs[("rel_attention_bwd", "float32")],
         "max_err_offsets": errs[("rel_attention_offsets", "bfloat16")],
         "ms": bwd_ms, "stages_ms": stages_ms, "ms_f32": bwd_f32_ms,
         "stages_ms_f32": stages_f32_ms, "plain_ms_f32": bwd_f32_plain,
         "bound_ms_f32": bwd_f32_bound[0], "bound_by_f32": bwd_f32_bound[1],
         "f32_train_step": f32_step,
         "plain_ms": bwd_plain, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], "library_ms": None,
         "recognition": rec["rel_attention_bwd"]},
        {"name": "dtw_align", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/dtw.cu",
         "replaces": "silent_speech_tpu/ops/pallas/dtw_kernel.py:209",
         "shape": f"K={kk} T={t1} bf16 costs", **launches("dtw_align"),
         "max_abs_err": dtw_err, "ms": dtw_ms, "device_ms": dtw_dev_ms,
         "ns_per_diagonal": dtw_ms * 1e6 / diagonals,
         "backtrace_ms": dtw_ms - dp_ms,
         "plain_ms": dtw_plain, "bound_ms": dtw_b[0],
         "bound_by": dtw_b[1], "library_ms": None,
         "aligned_prediction": {"shape": a_shape, "ms": a_ms,
                                "plain_ms": a_plain, "bound_ms": a_bound[0],
                                "bound_by": a_bound[1]}},
        {"name": "dtw_align_dp_only", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/dtw.cu",
         "replaces": "tools/prof_dtw.py:136",
         "shape": f"K={kk} T={t1} bf16 costs",
         **launches("dtw_align_dp_only"), "on_main_path": False,
         "max_abs_err": dp_err, "ms": dp_ms, "device_ms": dp_dev_ms,
         "ns_per_diagonal": dp_ns_diag,
         "ns_per_diagonal_device": (None if dp_dev_ms is None
                                    else dp_dev_ms * 1e6 / diagonals),
         "plain_ms": dp_plain, "bound_ms": dtw_b[0],
         "bound_by": dtw_b[1], "library_ms": None},
        # not a Pallas kernel: the JAX package's CTC is optax.ctc_loss
        # under XLA; this kernel repairs the port's (ROADMAP.md faults 8, 11)
        {"name": "ctc", "route": "cuda",
         "source": "silent_speech_tpu_torch/csrc/ctc.cu",
         "replaces": "silent_speech_tpu/train/losses.py:233",
         "pallas": False, **launches("ctc"),
         "launches_backward": launches("ctc_bwd")["launches"],
         **time_ctc(card, rec_ctc, errs)},
    ]


def time_dropout(card, path_launches=None):
    """Phase 8, the dropout kernels (``csrc/dropout.cu``) at the
    transduction step's sites, ``DROPOUT_ROWS`` token rows at width 3072
    (the FFN's ReLU dropout and its backward) and 768 (the residual
    masks), bf16 and f32: each output torch.equal to the plain version's,
    then ms a launch queued behind a sleeping kernel (the device's time)
    against the byte bound (each input read once, the output written
    once) and the plain version's ms. Runs alone too (``path_launches``
    None). Returns the kernels JSON entry."""
    import torch
    from silent_speech_tpu_torch.ops.dropout import (
        _launch_relu_bwd, dropout_threshold, mask_scale, mask_scale_plain,
        relu_dropout_backward_plain)

    thr, seed = dropout_threshold(0.2), 2 ** 31 - 7
    timings = []
    for dtype in (torch.bfloat16, torch.float32):
        item = torch.finfo(dtype).bits // 8
        for width, relu in ((3072, True), (768, False)):
            g = torch.Generator(device="cuda").manual_seed(width)
            x, dy = (torch.randn(DROPOUT_ROWS, width, device="cuda",
                                 generator=g).to(dtype) for _ in range(2))
            y = mask_scale(x, seed, thr, relu=relu)
            cases = [("relu_mask_scale" if relu else "mask_scale", 2,
                      lambda: mask_scale(x, seed, thr, relu=relu),
                      lambda: mask_scale_plain(x, seed, thr, relu=relu))]
            if relu:
                cases.append(("relu_dropout_bwd", 3,
                              lambda: _launch_relu_bwd(dy, y, thr),
                              lambda: relu_dropout_backward_plain(dy, y,
                                                                  thr)))
            for name, passes, kernel, plain in cases:
                same = torch.equal(kernel(), plain())
                ms = queued_ms(kernel)
                plain_ms = cuda_time_ms(plain, iters=5, warmup=1)
                bound_ms = passes * x.numel() * item / HBM_BYTES_PER_S * 1e3
                shape = f"{DROPOUT_ROWS}x{width} {str(dtype)[6:]}"
                log(f"[time] {card} | dropout {name} (csrc/dropout.cu) "
                    f"{shape}, dropout 0.2: torch.equal to the plain "
                    f"version: {same}; kernel {ms:.4f} ms/launch (queued: "
                    f"the device's time), plain {plain_ms:.4f} ms, bound "
                    f"{bound_ms:.5f} ms (bytes: {passes} x "
                    f"{x.numel() * item} B), {bound_ms / ms:.2%} of bound")
                if not same:
                    raise AssertionError(f"dropout {name} at {shape} "
                                         f"differs from the plain version")
                timings.append({"kernel": name, "shape": shape, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": "bytes"})
            del x, dy, y
    by_path = {path: (counts["dropout"], counts["dropout_relu_bwd"])
               for path, counts in (path_launches or {}).items()}
    return {"name": "dropout", "route": "cuda",
            "source": "silent_speech_tpu_torch/csrc/dropout.cu",
            "replaces": "silent_speech_tpu/ops/dropout.py",
            "pallas": False,
            "launches": sum(sum(v) for v in by_path.values()),
            "launches_by_path": {k: sum(v) for k, v in by_path.items()},
            "launches_relu_bwd": sum(v[1] for v in by_path.values()),
            "library_ms": None, "timings": timings}


def time_batch_norm(card, path_launches=None):
    """Phase 8, the conv stack's BatchNorm kernels (``csrc/batchnorm.cu``)
    at a transduction micro-step's first ResBlock, B=120, C=768, L=800,
    bf16 and f32: BN1 + ReLU and the block's end (BN2 and the residual BN +
    add + ReLU), forward (statistics, finalize, apply) and backward
    (reduction, finalize, apply). The fused output, input and parameter
    gradients and running statistics against the plain composition's
    (``batch_norm_plain`` and autograd, the output cast to the compute
    dtype), printed as relative L2 and largest-error gaps, and two calls
    torch.equal; then ms by CUDA events queued behind a sleeping kernel
    (the device's time) against the byte bound (each (B, C, L) tensor read
    or written once a pass: 3 + 5 forward, 5 + 8 backward), the plain
    composition's forward and backward, and ``F.batch_norm`` in training
    + ReLU forward and backward (cuDNN's BatchNorm of the compute-dtype
    input, its running variance unbiased: a yardstick, not the same
    function, never called by the port). Runs alone too (``path_launches``
    None). Returns the kernels JSON entry."""
    import copy

    import torch
    import torch.nn.functional as F
    from silent_speech_tpu_torch.ops import batch_norm as bn_ops

    b, c, length = BN_TIMED
    timings = []
    for dtype in (torch.bfloat16, torch.float32):
        item = torch.finfo(dtype).bits // 8
        g = torch.Generator(device="cuda").manual_seed(SEED)
        xs = [(torch.randn(b, c, length, device="cuda", generator=g) * 1.5
               + 0.2).to(dtype) for _ in range(2)]
        grad = torch.randn(b, c, length, device="cuda", generator=g).to(dtype)
        bns = []
        for i in range(2):
            bn = torch.nn.BatchNorm1d(c, eps=1e-5).cuda()
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5, generator=g)
                bn.bias.normal_(0.0, 0.3, generator=g)
            bns.append(bn)
        count = float(b * length)
        for name, n_x, fwd_passes, bwd_passes in (("bn_relu", 1, 3, 5),
                                                  ("bn_bn_add_relu", 2, 5,
                                                   8)):
            ins, norms = xs[:n_x], bns[:n_x]

            def run(fused):
                leaves = [x.clone().requires_grad_() for x in ins]
                mods = [copy.deepcopy(m) for m in norms]
                if n_x == 1:
                    fn = bn_ops.bn_relu if fused else bn_ops.bn_relu_plain
                    out = fn(leaves[0], mods[0], True)
                else:
                    fn = (bn_ops.bn_add_relu if fused
                          else bn_ops.bn_add_relu_plain)
                    out = fn(leaves[0], mods[0], leaves[1], mods[1], True)
                out = out.to(dtype)
                out.backward(grad)
                return ([out.detach()] + [x.grad for x in leaves],
                        [t for m in mods
                         for t in (m.weight.grad, m.bias.grad)],
                        [t for m in mods
                         for t in (m.running_mean, m.running_var)])

            (k_t, k_p, k_r), (k2_t, k2_p, k2_r), (p_t, p_p, p_r) = (
                run(True), run(True), run(False))
            same = all(torch.equal(a, b_) for a, b_ in zip(
                k_t + k_p + k_r, k2_t + k2_p + k2_r))
            l2 = max(float((a.double() - r.double()).norm()
                           / r.double().norm()) for a, r in zip(k_t, p_t))
            plain_stats = bn_ops.statistics_plain(ins, norms)
            sums = []
            for i, x in enumerate(ins):
                mean, rstd = (plain_stats[j, i * c:(i + 1) * c, None]
                              for j in (0, 1))
                xhat = (x.float() - mean) * rstd
                sums += [(grad.float() * xhat).abs().sum((0, 2)),
                         grad.float().abs().sum((0, 2))]
            worst = max(float(((a - r).abs() / s_).max())
                        for a, r, s_ in zip(k_p, p_p, sums))
            running = max(float((a - r).abs().max() / r.abs().max())
                          for a, r in zip(k_r, p_r))

            def fwd():
                part = bn_ops.batch_norm_stats(ins)
                stats = bn_ops.batch_norm_finalize(part, c, norms, count)
                return bn_ops.batch_norm_apply(ins, None, stats, dtype), stats

            stats = fwd()[1]

            def bwd():
                part = bn_ops.batch_norm_bwd_reduce([grad], ins, None, stats)
                tot, _ = bn_ops.batch_norm_bwd_finalize(part)
                return bn_ops.batch_norm_bwd_apply([grad], ins, None, stats,
                                                   tot, count)

            leaves = [x.clone().requires_grad_() for x in ins]
            mods = [copy.deepcopy(m) for m in norms]
            if n_x == 1:
                plain_out = bn_ops.bn_relu_plain(leaves[0], mods[0], True)
            else:
                plain_out = bn_ops.bn_add_relu_plain(leaves[0], mods[0],
                                                     leaves[1], mods[1], True)
            plain_out = plain_out.to(dtype)

            def plain_fwd():
                if n_x == 1:
                    return bn_ops.bn_relu_plain(ins[0], mods[0], True)
                return bn_ops.bn_add_relu_plain(ins[0], mods[0], ins[1],
                                                mods[1], True)

            def library():
                leaves = [x.detach().requires_grad_() for x in ins]
                out = sum(F.batch_norm(x, None, None, m.weight, m.bias, True,
                                       0.1, m.eps) for x, m in zip(leaves,
                                                                   norms))
                F.relu(out).backward(grad)

            fwd_ms, bwd_ms = queued_ms(fwd), queued_ms(bwd)
            plain_fwd_ms = cuda_time_ms(plain_fwd, iters=5, warmup=1)
            plain_bwd_ms = cuda_time_ms(lambda: plain_out.backward(
                grad, retain_graph=True), iters=5, warmup=1)
            library_ms = cuda_time_ms(library, iters=10, warmup=2)
            tensor = b * c * length * item
            for phase, ms, plain_ms, passes in (
                    ("forward", fwd_ms, plain_fwd_ms, fwd_passes),
                    ("backward", bwd_ms, plain_bwd_ms, bwd_passes)):
                bound_ms = passes * tensor / HBM_BYTES_PER_S * 1e3
                shape = f"{b}x{c}x{length} {str(dtype)[6:]}"
                log(f"[time] {card} | batch_norm {name} {phase} "
                    f"(csrc/batchnorm.cu) {shape}: kernels {ms:.4f} ms a "
                    f"call (queued: the device's time, 3 launches), plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes: "
                    f"{passes} x {tensor} B), {bound_ms / ms:.2%} of bound")
                timings.append({"kernel": f"{name}_{phase}", "shape": shape,
                                "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": "bytes"})
            log(f"[time] {card} | batch_norm {name} {b}x{c}x{length} "
                f"{str(dtype)[6:]}: against the plain composition, output "
                f"and input gradients' relative L2 {l2:.3g} (tolerance "
                f"{BN_L2}), parameter gradients' largest error over their "
                f"channel's sum of magnitudes {worst:.3g} ({BN_SUM_RTOL}), "
                f"running statistics' largest error over the largest entry "
                f"{running:.3g} ({BN_RUNNING_RTOL}); two calls torch.equal: "
                f"{same}; F.batch_norm training + ReLU, forward and "
                f"backward (yardstick) {library_ms:.4f} ms against the "
                f"kernels' {fwd_ms + bwd_ms:.4f} ms")
            timings[-1]["library_ms"] = timings[-2]["library_ms"] = \
                library_ms
            if not (same and l2 <= BN_L2 and worst <= BN_SUM_RTOL
                    and running <= BN_RUNNING_RTOL):
                raise AssertionError(f"batch_norm {name} {dtype}: the "
                                     f"kernels part from the plain "
                                     f"composition or from themselves")
            del plain_out, leaves, mods
        del xs, grad
    by_path = {path: sum(counts[k] for k in BATCH_NORM_KEYS)
               for path, counts in (path_launches or {}).items()}
    return {"name": "batch_norm", "route": "cuda",
            "source": "silent_speech_tpu_torch/csrc/batchnorm.cu",
            "replaces": "flax nn.BatchNorm in silent_speech_tpu/models/"
                        "encoder.py",
            "pallas": False, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "library_ms": None,
            "timings": timings}


def time_adamw(card, path_launches=None):
    """Phase 8, the AdamW kernels (``csrc/adamw.cu``) at the transduction
    model's 120 leaves: after two updates from the same gradients the
    kernels' weights and moments torch.equal to the per-leaf loop's, with
    bf16 and with float32 moments; then ms a launch of the update (each
    moment dtype) and of the accumulation's fold, queued behind a sleeping
    kernel (the device's time), against the byte bound (p, g, m, v read
    once, p, m, v written once; the fold: g and acc read, acc written),
    the loop's update (ms a step, host included), and
    ``torch.optim.AdamW(fused=True)``'s step (float32 moments) as the
    library yardstick, which the port never calls. Runs alone too
    (``path_launches`` None). Returns the kernels JSON entry."""
    import torch
    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.models.encoder import EMGEncoder
    from silent_speech_tpu_torch.ops import adamw
    from silent_speech_tpu_torch.train.state import FusedAdamW

    class Loop(FusedAdamW):
        def _leaves(self):
            return None

    shapes = [p.shape for p in EMGEncoder(80, 48, ModelConfig()).parameters()]
    n = sum(int(np.prod(s)) for s in shapes)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    start = [torch.randn(s, device="cuda", generator=g) for s in shapes]
    grads = [torch.randn(s, device="cuda", generator=g) * 1e-2
             for s in shapes]
    lr = 1e-3

    def make(cls, **kw):
        params = [torch.nn.Parameter(x.clone()) for x in start]
        for p, x in zip(params, grads):
            p.grad = x          # read only: shared by every optimizer
        return params, cls(params, weight_decay=1e-7, **kw)

    timings = []
    for moment_dtype in (torch.bfloat16, torch.float32):
        (pk, ok), (pl, ol) = (make(cls, moment_dtype=moment_dtype)
                              for cls in (FusedAdamW, Loop))
        for _ in range(2):
            ok.step(lr)
            ol.step(lr)
        same = all(torch.equal(a, b) for a, b in zip(pk + ok.mu + ok.nu,
                                                     pl + ol.mu + ol.nu))
        leaves = ok._leaves()
        hyper = adamw.Hyper(0.9, 0.999, 0.1, 0.001, 10.0, 1000.0, 1e-8,
                            1e-7, -lr)
        ms = queued_ms(lambda: adamw.adamw_update(leaves, grads, hyper))
        plain_ms = cuda_time_ms(lambda: ol.step(lr), iters=5, warmup=1)
        item = torch.finfo(moment_dtype).bits // 8
        nbytes = n * (4 * 3 + 2 * 2 * item)
        cases = [("update", moment_dtype, ms, plain_ms, nbytes)]
        if moment_dtype == torch.float32:
            lib = torch.optim.AdamW(pl, lr=lr, weight_decay=1e-7,
                                    fused=True)
            library_ms = queued_ms(lib.step)
            del lib
        (pf, of), (pfl, ofl) = (make(cls, moment_dtype=moment_dtype,
                                     grad_accum=2)
                                for cls in (FusedAdamW, Loop))
        for _ in range(3):
            of.step(lr)
            ofl.step(lr)
        same = same and all(torch.equal(a, b) for a, b in zip(
            pf + of.mu + of.nu + of.acc, pfl + ofl.mu + ofl.nu + ofl.acc))
        if moment_dtype == torch.bfloat16:
            fold_leaves = of._leaves()
            cases.append((
                "fold", None,
                queued_ms(lambda: adamw.adamw_fold(fold_leaves, grads, 2)),
                cuda_time_ms(lambda: ofl._fold_plain(grads), iters=5,
                             warmup=1), n * 12))
        for name, dtype, ms, plain_ms, nbytes in cases:
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            what = (f"update, {str(dtype)[6:]} moments" if dtype
                    else "fold (accumulation 2)")
            log(f"[time] {card} | adamw {what} (csrc/adamw.cu), 120 leaves, "
                f"{n} float32 parameters: torch.equal to the per-leaf loop "
                f"(two updates, and accumulation 2 over three micro-steps): "
                f"{same}; kernel {ms:.4f} ms/launch (queued: the device's "
                f"time), loop {plain_ms:.4f} ms (host included), bound "
                f"{bound_ms:.5f} ms (bytes: {nbytes} B), "
                f"{bound_ms / ms:.2%} of bound")
            timings.append({"kernel": name, "moments": str(dtype)[6:]
                            if dtype else None, "leaves": len(shapes),
                            "params": n, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": "bytes"})
        if not same:
            raise AssertionError(f"the AdamW kernels with {moment_dtype} "
                                 f"moments differ from the per-leaf loop")
        del pk, ok, pl, ol, pf, of, pfl, ofl
    log(f"[time] {card} | adamw library yardstick torch.optim.AdamW("
        f"fused=True), float32 moments: {library_ms:.4f} ms a step "
        f"(queued)")
    by_path = {path: (counts["adamw_update"], counts["adamw_fold"])
               for path, counts in (path_launches or {}).items()}
    return {"name": "adamw", "route": "cuda",
            "source": "silent_speech_tpu_torch/csrc/adamw.cu",
            "replaces": "silent_speech_tpu/train/state.py fused_adamw",
            "pallas": False,
            "launches": sum(sum(v) for v in by_path.values()),
            "launches_by_path": {k: sum(v) for k, v in by_path.items()},
            "launches_fold": sum(v[1] for v in by_path.values()),
            "library_ms": library_ms, "timings": timings}


def filtfilt_bounds(lengths, t_pad, c, coeffs):
    """The filter chain's byte bound (each valid input sample read once,
    the padded output written once) and operation bound, the chain's
    steps for its longest column and their latency bound, and the time to
    stream the kernel's own scratch traffic (each pass reads and writes
    each column's samples once) at the card's memory rate."""
    from silent_speech_tpu_torch.dsp.device_filters import padlen
    from silent_speech_tpu_torch.ops.filtfilt_study import chain_steps

    lens = [int(n) for n in lengths]
    b = len(lens)
    # a step of a filter with nd delays: 2 + 4·nd operations, 2 passes of
    # L + 2p steps a column
    nbytes = 4 * c * sum(lens) + 4 * b * t_pad * c + 4 * b
    ops = sum(c * 2 * (n + 2 * padlen(bb, aa)) * (2 + 4 * (len(bb) - 1))
              for n in lens for bb, aa in coeffs)
    bound_ms, bound_by = _bound(nbytes, ops, "float32")
    steps = chain_steps(lens, coeffs)
    scratch_bytes = sum(c * 8 * 2 * (n + 2 * padlen(bb, aa))
                        for n in lens for bb, aa in coeffs)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "chain_steps": steps,
            "latency_bound_ms": latency_bound_ms(steps, FILT_DEP_OPS),
            "scratch_stream_ms": scratch_bytes / HBM_BYTES_PER_S * 1e3}


def _plain_chain(x, lengths, coeffs):
    """The plain filter chain on CPU tensors and its seconds (run in a
    worker process)."""
    import torch
    from silent_speech_tpu_torch.ops.filtfilt import filtfilt_chain_plain

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = filtfilt_chain_plain(x, lengths, coeffs)
    return out, time.perf_counter() - t0


def start_corpus_group(pool):
    """Phase 8's S-corpus, a synthetic 256 MiB group of 512 utterances of
    6,000..16,384 samples (``ops/filtfilt_study.corpus_group``), launched
    once on the card; its shortest and longest utterance go to the plain
    version in ``pool``'s worker process (~10 s on one CPU core), which
    runs while the other kernels are timed."""
    from silent_speech_tpu_torch.ops.filtfilt import filtfilt_chain
    from silent_speech_tpu_torch.ops.filtfilt_study import (corpus_group,
                                                            extremes)

    x, lengths, coeffs = corpus_group(SEED)
    out = filtfilt_chain(x, lengths, coeffs)
    _, x2, len2 = extremes(x, lengths)
    return x, lengths, coeffs, out, pool.submit(_plain_chain, x2, len2,
                                                coeffs)


def time_filtfilt(card, path_launches, corpus_inputs, errs, build_s,
                  stream_latency, group):
    """Phase 8, the filter chain at the shape of phase 7's corpus build
    (its own inputs) and at S-corpus (``start_corpus_group``'s ``group``):
    ms a launch against the bounds and the plain version (at S-corpus on
    its shortest and longest utterance, sliced out), and ns a step of the
    dependent chain. Returns its kernels JSON entry."""
    import torch
    from silent_speech_tpu_torch.ops.filtfilt import (filtfilt_chain,
                                                      filtfilt_chain_plain)
    from silent_speech_tpu_torch.ops.filtfilt_study import sliced_check

    x, lengths, coeffs = corpus_inputs
    b, t_pad, c = x.shape
    out = filtfilt_chain(x, lengths, coeffs)
    ms = cuda_time_ms(lambda: filtfilt_chain(x, lengths, coeffs), iters=10,
                      warmup=1)
    # one run of the plain loop on CPU tensors, where the port runs it
    # (on the card it is ~10 launches a step; phase 2 holds it there),
    # times it and holds the kernel to it
    x_cpu = x.cpu()
    t0 = time.perf_counter()
    ref = filtfilt_chain_plain(x_cpu, lengths, coeffs)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (out.cpu() - ref).abs().max().item()
    if not torch.equal(out.cpu(), ref):
        raise AssertionError("filtfilt_chain disagrees with its plain "
                             "version at the corpus build's shape")
    lens = lengths.tolist()
    bd = filtfilt_bounds(lens, t_pad, c, coeffs)
    steps = bd["chain_steps"]
    ns_step = ms * 1e6 / steps
    log(f"[time] {card} | filtfilt_chain {len(coeffs)} filters B={b} "
        f"T_pad={t_pad} C={c} (phase 7's corpus build, lengths "
        f"{min(lens)}..{max(lens)}): kernel {ms:.4f} ms/launch, plain "
        f"{plain_ms:.2f} ms (CPU tensors, torch.equal to the kernel), "
        f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']}), "
        f"{bd['bound_ms'] / ms:.2%} of bound; the dependent chain of the "
        f"longest column: {steps} steps, {ns_step:.2f} ns a step; latency "
        f"bound {fmt_ms(bd['latency_bound_ms'])} ({steps} steps x "
        f"{FILT_DEP_OPS} dependent FP32 operations x {DEP_CYCLES} cycles at "
        f"the maximum SM clock {max_sm_clock_hz()} Hz)")

    # S-corpus: a group of the size _groups forms on a real corpus
    xg, lg, cg, outg, plain = group
    bg, tg, cc = xg.shape
    ms_g = cuda_time_ms(lambda: filtfilt_chain(xg, lg, cg), iters=3,
                        warmup=1)
    ref, plain_s = plain.result()
    held = sliced_check(xg, lg, cg, outg, ref)
    held["plain_s"] = plain_s
    del xg, outg
    torch.cuda.empty_cache()
    bg_d = filtfilt_bounds(lg.tolist(), tg, cc, cg)
    ns_g = ms_g * 1e6 / bg_d["chain_steps"]
    log(f"[time] {card} | filtfilt_chain {len(cg)} filters B={bg} "
        f"T_pad={tg} C={cc} (S-corpus, lengths {int(lg.min())}.."
        f"{int(lg.max())} from seed {SEED}): kernel {ms_g:.4f} ms/launch, "
        f"bound {bg_d['bound_ms']:.5f} ms ({bg_d['bound_by']}); the "
        f"longest column's chain {bg_d['chain_steps']} steps, {ns_g:.2f} ns "
        f"a step, latency bound {fmt_ms(bg_d['latency_bound_ms'])}; the "
        f"scratch's traffic alone {bg_d['scratch_stream_ms']:.4f} ms at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; utterances {held['utterances']} "
        f"(lengths {held['lengths']}) torch.equal to the plain version "
        f"{held['equal']} (CPU, {held['plain_s']:.2f} s in a worker process)")
    if not held["equal"]:
        raise AssertionError("filtfilt_chain disagrees with its plain "
                             "version at S-corpus")
    by_path = {path: counts["filtfilt_chain"]
               for path, counts in path_launches.items()}
    return {"name": "filtfilt_chain", "route": "cuda",
            "source": "silent_speech_tpu_torch/csrc/filtfilt.cu",
            "replaces": "silent_speech_tpu/dsp/jax_filters.py:49",
            "pallas": False,
            "shape": f"B={b} T_pad={t_pad} C={c} f32, {len(coeffs)} filters",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "max_abs_err_phase2": errs["filtfilt_chain"],
            "ms": ms, "plain_ms": plain_ms, "plain_on": "cpu",
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "library_ms": None, "latency_bound_ms": bd["latency_bound_ms"],
            "chain_steps": steps, "ns_per_step": ns_step,
            "corpus_build_s": build_s,
            "streaming_recompute_ms": stream_latency,
            "corpus": {"shape": f"B={bg} T_pad={tg} C={cc} f32, lengths "
                                f"{int(lg.min())}..{int(lg.max())}",
                       "ms": ms_g, "ns_per_step": ns_g,
                       "max_abs_err": held["max_abs_err"],
                       "plain_utterances": held["lengths"], **bg_d}}


def host_self_ms(fn) -> dict:
    """Self CPU ms of each host op of one call of ``fn`` under the
    profiler (CPU activity alone), by op name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_cpu_time_total / 1e3
            for ev in prof.key_averages()}


# the mesh phase: rounds of steps in turns, plain trainer then the 1x1 mesh
MESH_ROUNDS, MESH_STEPS = 3, 3


def mesh_run(card):
    """Phase 9: the data x model mesh over NCCL. A full-width transduction
    step on the 1x1 mesh (a real NCCL process group of one rank) is
    torch.equal to the plain trainer's step (loss, every gradient, every
    weight and statistic after the update); both are timed in turns in
    this call (steps/s, collectives a step; under the profiler, device
    busy and the host ops' self CPU time); then
    ``dryrun_multichip(torch.cuda.device_count(), full_width=True)``'s
    seven checks; the process group is destroyed at the end. Then
    ``entry()``'s forward (6 K1f launches) against the same forward with
    the plain attention, and its time. Returns the launches of the mesh
    path and of entry()."""
    import torch
    import torch.distributed as dist
    from silent_speech_tpu_torch.bench import example_sets
    from silent_speech_tpu_torch.graft_entry import dryrun_multichip, entry
    from silent_speech_tpu_torch.models import transformer
    from silent_speech_tpu_torch.ops.rel_attention import rel_attention_plain
    from silent_speech_tpu_torch.parallel.collectives import calls
    from silent_speech_tpu_torch.parallel.mesh import destroy, make_mesh
    from silent_speech_tpu_torch.train.transduction import (
        TransductionTrainer)

    try:
        mesh = make_mesh(1, 1, "cuda")
        log(f"[mesh] {mesh}: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}")
        plain, meshed = TransductionTrainer(), TransductionTrainer(mesh=mesh)
        plain.init_state(SEED)
        meshed.init_state(SEED)
        batches = [plain._pack(s) for s in example_sets()]
        lr = plain.train_cfg.learning_rate
        reset_launches()
        calls.count = 0
        out_m = meshed.train_step(batches[0], lr)
        torch.cuda.synchronize()
        step_launches, per_step = read_launches(), calls.count
        out_p = plain.train_step(batches[0], lr)
        layers = plain.model_cfg.num_layers
        expected = launch_counts(
            rel_attention_fwd=layers, rel_attention_bwd=layers,
            dtw_align=1 if batches[0].num_silent else 0,
            **dropout_counts(layers, 1), **batch_norm_counts(1, mesh=True),
            **adamw_counts(1))
        if step_launches != expected:
            raise AssertionError(f"mesh step launches {step_launches}, "
                                 f"expected {expected}")
        grads_equal = all(
            torch.equal(a.grad, b.grad) for a, b in
            zip(meshed.model.parameters(), plain.model.parameters()))
        state_equal = _state_equal(meshed.model.state_dict(),
                                   plain.model.state_dict())
        loss_equal = torch.equal(out_m.loss, out_p.loss)
        log(f"[mesh] {card} | full-width step on the 1x1 NCCL mesh vs the "
            f"plain trainer, one batch from seed {SEED}: loss "
            f"{float(out_m.loss):.6f} vs {float(out_p.loss):.6f}, "
            f"torch.equal loss {loss_equal}, gradients {grads_equal}, "
            f"weights and statistics after the update {state_equal}; "
            f"{per_step} collectives a step, launches {step_launches}")
        if not (loss_equal and grads_equal and state_equal):
            raise AssertionError("the 1x1 mesh step is not torch.equal to "
                                 "the plain step")

        rates = {"plain": [], "mesh": []}
        for r in range(MESH_ROUNDS):
            for name, t in (("plain", plain), ("mesh", meshed)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(MESH_STEPS):
                    t.train_step(batches[(r + i) % len(batches)], lr)
                torch.cuda.synchronize()
                rates[name].append(MESH_STEPS / (time.perf_counter() - t0))
        ms = {k: 1e3 / float(np.median(v)) for k, v in rates.items()}
        log(f"[time] {card} | transduction step, plain trainer vs 1x1 NCCL "
            f"mesh in turns ({MESH_ROUNDS} rounds of {MESH_STEPS}): steps/s "
            f"plain {[round(x, 3) for x in rates['plain']]} mesh "
            f"{[round(x, 3) for x in rates['mesh']]}; ms a step (median) "
            f"plain {ms['plain']:.2f} mesh {ms['mesh']:.2f} "
            f"({ms['mesh'] - ms['plain']:+.2f})")
        # where the mesh's time goes: one step of each under the profiler,
        # device busy, then the host's ops by self CPU time (a step syncs
        # with the card inside, so its host time cannot be read off a
        # clock around the call)
        busy, self_ms = {}, {}
        for name, t in (("plain", plain), ("mesh", meshed)):
            busy[name] = device_profile(
                card, f"transduction step, {name} trainer",
                lambda: t.train_step(batches[0], lr), top=3)
            self_ms[name] = host_self_ms(lambda: t.train_step(batches[0],
                                                               lr))
        total = {k: sum(v.values()) for k, v in self_ms.items()}
        extra = sorted(((self_ms["mesh"].get(k, 0.0)
                         - self_ms["plain"].get(k, 0.0), k)
                        for k in self_ms["mesh"]), reverse=True)[:8]
        log(f"[time] {card} | host ops' self CPU ms a step (profiled, one "
            f"step each): plain {total['plain']:.2f}, mesh "
            f"{total['mesh']:.2f} ({total['mesh'] - total['plain']:+.2f} for "
            f"{per_step} collectives); most added: "
            + ", ".join(f"{k} +{d:.2f}" for d, k in extra)
            + f"; device busy ms plain "
            f"{busy['plain'] and round(busy['plain'][1], 3)}, mesh "
            f"{busy['mesh'] and round(busy['mesh'][1], 3)}")
        del plain, meshed, batches
        torch.cuda.empty_cache()
    finally:
        destroy()

    n = torch.cuda.device_count()
    reset_launches()
    t0 = time.perf_counter()
    for line in dryrun_multichip(n, "cuda", full_width=True):
        log(f"[mesh.dryrun] {line}")
    dry_launches = read_launches()
    log(f"[mesh] {card} | dryrun_multichip({n}, full_width=True) in "
        f"{time.perf_counter() - t0:.1f} s, launches {dry_launches}")
    if dist.is_initialized():
        raise AssertionError("the mesh phase left a process group")
    for k in ("rel_attention_fwd", "rel_attention_bwd", "dtw_align", "ctc",
              "adamw_update", "adamw_fold", "bn_stats"):
        if not dry_launches[k]:
            raise AssertionError(f"the dry run launched no {k}")
    mesh_launches = launch_counts()
    mesh_launches.add(step_launches)
    mesh_launches.add(dry_launches)

    forward, args = entry()
    reset_launches()
    mel, phone = forward(*args)
    torch.cuda.synchronize()
    entry_launches = read_launches()
    if entry_launches != launch_counts(rel_attention_fwd=6):
        raise AssertionError(f"entry() launched {entry_launches}")

    def plain_attention(q, k, v, e, m, valid_len=None, seed=0, thresh=0,
                        **cells):
        return rel_attention_plain(q, k, v, e, m, valid_len, seed, thresh,
                                   **cells)

    with swapped(transformer, "rel_attention", plain_attention):
        mel_p, phone_p = forward(*args)
    rel = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
              for a, b in ((mel, mel_p), (phone, phone_p)))
    fwd_ms = cuda_time_ms(lambda: forward(*args), iters=10)
    log(f"[time] {card} | entry(): full-width eval forward on "
        f"{tuple(args[0].shape)} raw EMG, mel {tuple(mel.shape)}, "
        f"{fwd_ms:.3f} ms; max error / max |out| against the plain "
        f"attention {rel:.3g} (tolerance {SERVED_RTOL}); launches "
        f"{entry_launches}")
    if not (torch.isfinite(mel).all() and torch.isfinite(phone).all()) \
            or rel > SERVED_RTOL:
        raise AssertionError("entry()'s forward is not finite or parts "
                             "from the plain attention")
    return mesh_launches, entry_launches


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
    from silent_speech_tpu_torch.utils import native
    from silent_speech_tpu_torch.utils.device import card_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info("cuda")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(name):
        """Record the wall seconds since the last phase ended."""
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
        log(f"[lap] {name}: {laps[name]} s ({now - t_start:.1f} s in all)")

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    # the native library (g++: the beam search, the FLAC decoder) builds
    # beside the kernels (nvcc)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        beam = pool.submit(native.build)
        built = build.build()
        log(f"[build] {len(built)} kernel(s) in "
            f"{time.perf_counter() - t0:.2f} s")
        beam_lib = beam.result()
    log(f"[build] native library {os.path.basename(beam_lib)}: "
        f"{time.perf_counter() - t0:.2f} s with the kernels")
    for name, (secs, msgs) in built.items():
        log(f"[build] {name}: {secs:.2f} s")
        for line in msgs.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    lap("build")

    # 2. kernel vs plain ---------------------------------------------------
    errs = check_kernels()
    check_offsets(errs)
    lap("kernels")

    # 3. serve -------------------------------------------------------------
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT,
                                                                   "build"))
    try:
        serve_launches, vocoded_launches, int8_launches, int8_bundle = \
            serve(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lap("serve")

    # 4. train -------------------------------------------------------------
    train_launches, _, dtw_inputs, f32_train_launches, f32_step = train(card)
    lap("train")

    # 5. the training run --------------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_fit_",
                            dir=os.path.join(ROOT, "build"))
    try:
        fit_launches, aligned_launches, aligned_inputs = train_run(card,
                                                                   work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lap("fit")

    # 6. recognition -------------------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_rec_",
                            dir=os.path.join(ROOT, "build"))
    try:
        rec_launches, rec_serve_launches, rec_ctc = recognition_run(card,
                                                                    work)
        torch.save([x.detach().cpu() for x in rec_ctc[:4]] + [rec_ctc[4]],
                   CTC_INPUTS)
        log(f"[rec] the micro-step's CTC inputs saved to {CTC_INPUTS} (read "
            f"by python -m silent_speech_tpu_torch.ops.ctc_study)")
        lap("recognition")
        # 6c. streaming from phase 6's model.pt ----------------------------
        stream_launches, stream_latency = streaming_run(
            card, os.path.join(work, "fit", "model.pt"), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lap("streaming")

    # 6b. the vocoder ------------------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_voc_",
                            dir=os.path.join(ROOT, "build"))
    try:
        gan_launches = vocoder_run(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lap("vocoder")

    # 7. the CLIs from disk ------------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_disk_",
                            dir=os.path.join(ROOT, "build"))
    try:
        disk_launches, disk_vocoder_launches, corpus_inputs, build_s = \
            disk_run(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    x, lengths, coeffs = corpus_inputs
    torch.save([x.cpu(), lengths.cpu(), [(torch.from_numpy(np.asarray(b)),
                                          torch.from_numpy(np.asarray(a)))
                                         for b, a in coeffs]],
               FILTER_INPUTS)
    log(f"[disk] the corpus build's filter inputs saved to {FILTER_INPUTS} "
        f"(read by python -m silent_speech_tpu_torch.ops.filtfilt_study)")
    lap("disk")

    # 7b. record, clean, featurize and serve a session --------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_capture_",
                            dir=os.path.join(ROOT, "build"))
    try:
        capture_launches = capture_run(card, work, int8_bundle)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del int8_bundle
    lap("capture")

    # 9. the mesh over NCCL, the dry run and entry() ----------------------
    mesh_launches, entry_launches = mesh_run(card)
    lap("mesh")

    # 8. kernel timings ----------------------------------------------------
    path_launches = {
        "serve": serve_launches, "train": train_launches,
        "f32-train": f32_train_launches,
        "fit": fit_launches, "aligned_prediction": aligned_launches,
        "recognition_fit": rec_launches,
        "recognition_serve": rec_serve_launches,
        "streaming": stream_launches, "disk": disk_launches,
        "serve_vocoded": vocoded_launches, "gan": gan_launches,
        "serve_int8": int8_launches, "capture": capture_launches,
        "mesh": mesh_launches, "entry": entry_launches,
        **disk_vocoder_launches}
    # S-corpus's plain check runs in a worker process meanwhile
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        group = start_corpus_group(pool)
        kernels = time_kernels(card, path_launches, errs, dtw_inputs,
                               aligned_inputs, rec_ctc, f32_step)
        kernels.append(time_filtfilt(card, path_launches, corpus_inputs,
                                     errs, build_s, stream_latency, group))
        kernels.append(time_dropout(card, path_launches))
        kernels.append(time_adamw(card, path_launches))
        kernels.append(time_batch_norm(card, path_launches))
    del group
    lap("timings")
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the card was "
        f"found; wall seconds by phase {laps}")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
