"""The port's counterparts of the JAX package's ``__graft_entry__.py``
entry points: ``entry()``, a forward of the full-width model,
and ``dryrun_multichip(n)``, the training paths on an n-rank data × model
mesh against one process.

    python -m silent_speech_tpu_torch.graft_entry [--device cpu]
    python -m silent_speech_tpu_torch.graft_entry --dryrun N [--device cpu]
        [--full_width]

``entry(device)`` returns ``(forward, example_args)``: the full-size
EMG→mel encoder (d=768, 6 layers, the eval forward, bfloat16 on the card
as it serves) on 8 packed chunks of 200 frames; a call runs the attention
kernel K1f once a layer.

``dryrun_multichip(n, device)`` runs JAX's seven checks
(``__graft_entry__.py:73-362``) on a ``(n/mp) × mp`` mesh, ``mp = 2`` when
n is even, against one process with the same initial weights:

1. the packed train step on the mesh;
2. the device-corpus steps of two waves of ids (JAX runs them as one
   ``lax.scan``), losses against one process;
3. the recognition CTC step on the device corpus, against one process;
4. a checkpoint saved and restored on the mesh, then steps;
5. the GAN step of the vocoder (the smallest ensemble: MPD(2) + MSD(×1)
   at 1/8 width), data-parallel on the mesh, against one process;
6. a serving bundle exported from the sharded trainer, its output against
   the trainer's own forward;
7. a checkpoint saved on the mesh and restored onto one process (loss
   parity) and onto an n × 1 mesh of the same ranks (the parameters
   exact).

It prints one line a check in the JAX format, plus the seconds since the
start after each, and returns the lines. On the CPU the ranks are gloo
processes (``parallel/launch.spawn``); on CUDA each rank takes a card and
NCCL, and asking for more ranks than cards raises (JAX's dry run falls
back to a virtual CPU mesh; this one does not). One rank runs in this
process, its process group destroyed at the end. The model is JAX's
dry-run geometry (d=64, 2 layers, 4 heads, ff=128; dropout and the shift
off) unless ``full_width``, which takes the full-size encoder; float32 on
the CPU, bfloat16 on the card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import (DataConfig, ModelConfig, RecognitionTrainConfig,
                     TransductionTrainConfig)
from .models.encoder import EMGEncoder
from .phonemes import NUM_PHONES
from .utils.device import resolve_device


def example_list(rng: np.random.Generator, n: int = 4) -> List[dict]:
    """Training example dicts made up from ``rng`` (JAX's
    ``_example_list``, draw for draw)."""
    examples = []
    lengths = [170, 150, 210, 190, 180, 160, 200, 140][:n]
    for i, t in enumerate(lengths):
        silent = i % 2 == 1
        ex = {
            "emg": rng.normal(size=(t, 112)).astype(np.float32),
            "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
            "session_ids": np.zeros(t, dtype=np.int64),
            "silent": silent,
            "text": "example text",
            "text_int": rng.integers(0, 37, size=16).astype(np.int64),
        }
        if silent:
            tt = t + 11
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
    return examples


FULL = ModelConfig(model_size=768, num_layers=6, dropout=0.2)


def build_entry(cfg: ModelConfig, device: torch.device,
                state: Optional[dict] = None, n: int = 8, seq_len: int = 200
                ) -> Tuple[Callable, tuple]:
    """``entry()`` at the geometry ``cfg``: the eval forward of an encoder
    with ``state`` (default random weights from seed 0) on ``n`` chunks of
    ``seq_len`` frames of raw EMG drawn as JAX's ``entry`` draws them."""
    model = EMGEncoder(80, NUM_PHONES, cfg)
    if state is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state, strict=True)
    model = model.to(device).eval()
    rng = np.random.default_rng(0)
    rng.normal(size=(n, seq_len, 112))      # JAX's emg features, unread
    raw = torch.tensor(rng.normal(size=(n, seq_len * 8, 8)),
                       dtype=torch.float32, device=device)

    @torch.no_grad()
    def forward(raw_emg: torch.Tensor):
        return model(raw_emg)

    return forward, (raw,)


def entry(device: Optional[Union[str, torch.device]] = None
          ) -> Tuple[Callable, tuple]:
    """(forward, example_args): the full-size encoder's eval forward on 8
    chunks of 200 frames, on ``device`` (``cuda`` by default)."""
    return build_entry(FULL, resolve_device(device))


# ---------------- the multi-rank dry run ------------------------------
def _configs(full_width: bool, device: torch.device):
    cdt = "bfloat16" if device.type == "cuda" else "float32"
    if full_width:
        model = ModelConfig(compute_dtype=cdt, dropout=0.0,
                            shift_augment=False)
    else:
        model = ModelConfig(model_size=64, num_layers=2, num_heads=4,
                            dim_feedforward=128, compute_dtype=cdt,
                            dropout=0.0, shift_augment=False)
    data = DataConfig(t_cap=256, utt_cap=8)
    return (model, data, TransductionTrainConfig(max_batch_len=8000),
            RecognitionTrainConfig(max_batch_len=8000))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-9)))


def _dryrun_rank(n: int, data_parallel: int, model_parallel: int,
                 device: str, full_width: bool) -> Optional[List[str]]:
    """The seven checks on this rank; rank 0 also runs the one-process
    side and returns the printed lines."""
    from .data.device_cache import DeviceCorpus
    from .eval.export import ServingBundle, save_serving_bundle
    from .models.hifigan import HiFiGANConfig
    from .dsp.mel import MelConfig
    from .parallel.mesh import barrier, full_model, gather_state, make_mesh
    from .train.checkpoint import restore_checkpoint, save_checkpoint
    from .train.recognition import RecognitionTrainer
    from .train.transduction import TransductionTrainer
    from .train.vocoder import SEGMENT_FRAMES, VocoderTrainer

    t0 = time.monotonic()
    mesh = make_mesh(data_parallel, model_parallel, device)
    dev = mesh.device
    lead = mesh.rank == 0
    lines: List[str] = []
    say = lines.append

    def tick(label):
        say(f"  [t+{time.monotonic() - t0:.0f}s] {label} done")

    model_cfg, data_cfg, tcfg, rcfg = _configs(full_width, dev)

    def transducer(m):
        return TransductionTrainer(model_cfg, data_cfg, tcfg, device=dev,
                                   mesh=m)

    rng_np = np.random.default_rng(0)
    examples = example_list(rng_np, n=8)
    trainer = transducer(mesh)
    one = transducer(None) if lead else None

    # ---- 1. the packed step on the mesh ------------------------------
    trainer.init_state(0)
    packed = trainer._pack(examples[:4])
    loss = float(trainer.train_step(packed, 1e-3).loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    say(f"dryrun_multichip({n}): mesh {data_parallel}x{model_parallel}, "
        f"loss={loss:.4f}")
    tick("check 1 (plain mesh step)")

    # ---- 2. device-corpus waves, against one process -----------------
    waves = [[0, 1, 2, 3], [4, 5, 6, 7]]

    def wave_losses(t, m, seed=0, restore_from=None):
        t.init_state(seed)
        if restore_from is not None:
            restore_checkpoint(restore_from, t)
        corpus = DeviceCorpus.build(examples, dev, mesh=m)
        out = [t.train_step_ids(corpus, ids, 1e-3) for ids in waves]
        assert all(o is not None for o in out), "a wave exceeded the caps"
        return np.asarray([float(o.loss) for o in out])

    lm = wave_losses(trainer, mesh)
    if lead:
        l1 = wave_losses(one, None)
        rel = _rel(lm, l1)
        assert np.all(np.isfinite(lm)) and rel < 1e-3, \
            f"device-corpus mesh parity broke: {lm} vs {l1}"
        say(f"  cache-scan wave parity: mesh {lm.round(4).tolist()} vs "
            f"1-dev {l1.round(4).tolist()} (rel {rel:.2e})")
    tick("check 2 (cache-scan wave parity)")

    # ---- 3. the recognition CTC step, against one process ------------
    def ctc_loss_on(m):
        t = RecognitionTrainer(model_cfg, data_cfg, rcfg, device=dev, mesh=m)
        t.init_state(0)
        corpus = DeviceCorpus.build(examples, dev, mesh=m)
        out = t.train_step_ids(corpus, list(range(8)), 1e-3)
        assert out is not None, "the CTC batch exceeded the caps"
        return float(out)

    cm = ctc_loss_on(mesh)
    if lead:
        c1 = ctc_loss_on(None)
        relc = _rel(cm, c1)
        assert np.isfinite(cm) and relc < 1e-3, \
            f"CTC mesh parity broke: {cm} vs {c1}"
        say(f"  recognition CTC parity: mesh {cm:.4f} vs 1-dev {c1:.4f} "
            f"(rel {relc:.2e})")
    tick("check 3 (recognition CTC parity)")

    work = tempfile.mkdtemp(prefix="dryrun_") if lead else None
    try:
        shared = _shared_dir(work)

        # ---- 4. save → restore on the mesh → steps --------------------
        ck = os.path.join(shared, "ck4")
        if lead:
            os.makedirs(ck)
        barrier(mesh)
        trainer.init_state(0)
        save_checkpoint(ck, trainer, extra={"epoch": 1})
        trainer.init_state(3)
        extra = restore_checkpoint(ck, trainer)
        assert extra.get("epoch") == 1
        rloss = float(wave_losses(trainer, mesh, 3, ck)[-1])
        assert np.isfinite(rloss), rloss
        say(f"  restore-on-mesh step: loss={rloss:.4f}")
        tick("check 4 (restore-on-mesh)")

        # ---- 5. the GAN step, data-parallel, against one process -----
        tiny_gen = HiFiGANConfig(
            resblock="1", upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),))       # hop 8
        mel_cfg = MelConfig(n_fft=64, num_mels=80, hop_size=8, win_size=64,
                            fmax=8000.0)
        vb = max(2 * data_parallel, 2)
        mels = rng_np.normal(size=(vb, SEGMENT_FRAMES, 80)).astype(
            np.float32)
        audio = rng_np.normal(
            size=(vb, SEGMENT_FRAMES * tiny_gen.hop_length)).astype(
                np.float32)

        def gan_step_on(m):
            vt = VocoderTrainer(gen_cfg=tiny_gen, mel_cfg=mel_cfg, seed=0,
                                disc_periods=(2,), disc_scales=1,
                                disc_width_div=8, device=dev, mesh=m)
            out = vt.train_step(mels, audio, 2e-4)
            return {k: float(v) for k, v in out.items()}

        gm = gan_step_on(mesh)
        if lead:
            g1 = gan_step_on(None)
            for k in ("g_loss", "d_loss", "mel_l1"):
                assert np.isfinite(gm[k]) and _rel(gm[k], g1[k]) < 1e-3, \
                    f"vocoder GAN mesh parity broke on {k}: {gm} vs {g1}"
            say(f"  vocoder GAN step parity: mesh g={gm['g_loss']:.4f} "
                f"d={gm['d_loss']:.4f} vs 1-dev g={g1['g_loss']:.4f} "
                f"d={g1['d_loss']:.4f}")
        tick("check 5 (vocoder GAN parity)")

        # ---- 6. export from the sharded trainer, bundle vs live -------
        ex = examples[0]
        t_len = ex["emg"].shape[0]
        full = full_model(trainer.model)
        want = trainer.predict(ex)
        if lead:
            d = save_serving_bundle(full, "transduction",
                                    os.path.join(shared, "bundle"),
                                    t_buckets=(256,))
            bundle = ServingBundle.load(d, device=dev, dtype=trainer.dtype)
            got = bundle.predict(ex["emg"], ex["raw_emg"],
                                 ex["session_ids"].astype(np.int32))
            relb = float(np.sqrt(np.mean((got - want) ** 2))
                         / max(float(np.sqrt(np.mean(want ** 2))), 1e-9))
            assert got.shape == (t_len, 80) and relb < 2e-2, \
                f"bundle-vs-live parity broke: rel RMS {relb}"
            say(f"  serving export from sharded trainer: bundle vs live "
                f"rel-RMS {relb:.2e}")
        tick("check 6 (serving export)")

        # ---- 7. cross-topology restore: (dp, mp) → 1×1 and (n, 1) -----
        ck = os.path.join(shared, "ck7")
        if lead:
            os.makedirs(ck)
        barrier(mesh)
        trainer.init_state(0)
        src = {k: v.detach().clone() for k, v in
               gather_state(trainer.model.state_dict(), mesh).items()}
        save_checkpoint(ck, trainer, extra={"epoch": 2})
        l_src = float(wave_losses(trainer, mesh, 5, ck)[-1])
        mesh_t = make_mesh(n, 1, device)
        trainer_t = transducer(mesh_t)
        trainer_t.init_state(8)
        restore_checkpoint(ck, trainer_t)
        got_t = gather_state(trainer_t.model.state_dict(), mesh_t)
        exact = all(torch.equal(src[k], got_t[k]) for k in src)
        assert exact, "the n x 1 restore changed parameter values"
        if lead:
            l_11 = float(wave_losses(one, None, 9, ck)[-1])
            relx = _rel(l_11, l_src)
            assert np.isfinite(l_11) and relx < 1e-3, \
                f"cross-topology restore parity broke on 1x1: {l_11} vs " \
                f"{l_src}"
            say(f"  cross-topology restore: {data_parallel}x"
                f"{model_parallel} -> 1x1 loss {l_11:.4f} (src {l_src:.4f},"
                f" rel {relx:.2e}); -> {n}x1 param-tree exact over "
                f"{len(src)} leaves on {n}-device sharding")
        tick("check 7 (cross-topology restore)")
        barrier(mesh)
    finally:
        if lead:
            shutil.rmtree(work, ignore_errors=True)
    return lines if lead else None


def _shared_dir(work: Optional[str]) -> str:
    """Rank 0's scratch directory, told to every rank (ranks share the
    host's file system)."""
    import torch.distributed as dist

    box = [work]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def dryrun_multichip(n_devices: int,
                     device: Optional[Union[str, torch.device]] = None,
                     full_width: bool = False) -> List[str]:
    """The seven checks on an ``n_devices``-rank mesh (see the module's
    docstring); prints and returns rank 0's lines."""
    from .parallel.launch import check_ranks, spawn
    from .parallel.mesh import destroy

    device = resolve_device(device)
    check_ranks(n_devices, device)
    model_parallel = 2 if n_devices % 2 == 0 else 1
    args = (n_devices, n_devices // model_parallel, model_parallel,
            str(device), full_width)
    if n_devices == 1:
        try:
            lines = _dryrun_rank(*args)
        finally:
            destroy()
    else:
        lines = spawn(_dryrun_rank, n_devices, args, device=device,
                      threads=1 if device.type == "cpu" else None)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dryrun", type=int, default=0,
                    help="run dryrun_multichip(N) instead of entry()")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full_width", action="store_true",
                    help="the dry run at the full-size encoder")
    args = ap.parse_args(argv)
    if args.dryrun:
        return dryrun_multichip(args.dryrun, args.device, args.full_width)
    forward, example_args = entry(args.device)
    mel, phone = forward(*example_args)
    print(f"entry(): mel {tuple(mel.shape)}, phone logits "
          f"{tuple(phone.shape)}, finite "
          f"{bool(torch.isfinite(mel).all() and torch.isfinite(phone).all())}")
    return mel, phone


if __name__ == "__main__":
    main()
