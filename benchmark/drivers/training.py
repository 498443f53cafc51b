"""What the two training drivers share: the program's trainer over a
corpus on the card, stepped by utterance ids, and the comparison of its
first updates with the reference's.

Set-up builds the corpus from the seed (``traffic.py``) into the program's
``DeviceCorpus``, builds the trainer, overwrites its weights with the
benchmark's (``weights.py``) and its generator of step draws with one seeded
from the run's seed, and runs the compared micro-steps through the
window's own call (``train_step_ids``) on the sampler's first batches: they
are the window's warm-up too. It reads the program's losses of those
micro-steps, each leaf's first-update gradient norm from the optimizer's
first moment (m₁ / (1 − β₁)), each leaf's change of weights after the
last compared update, and the first micro-step's output head, taken by a
forward hook on the program's model at the rows of the batch's real
frames. The same trainer then steps in the window on the
sampler's next batches.

A subclass names the trainer and its spans. ``fault`` plants a fault in
the program, for the tests and the calibration: ``"frozen"`` (the
optimizer leaves the weights as they are) or ``"half_batch"`` (the program
gets the first half of each batch's utterances, and its loss is the mean
over them).
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import torch

from benchmark import traffic as traffic_law
from benchmark import weights as weight_law
from benchmark.reference.batch import layout
from benchmark.reference.train import Readings, follow

COMPARED_UPDATES = 3


class TrainingDriver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 fault: Optional[str] = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.fault = fault
        self.accum = int(cfg.get("grad_accum", 1))
        self.lr = float(cfg["learning_rate"])
        self.draw_seed = traffic_law.derived_seed(seed, "draws")
        self.micro_steps = 0     # in the windows
        self.frames: List[int] = []   # real frames of each window step
        self.last = None
        self.readings: Optional[Readings] = None
        self.compared: List[List[int]] = []

    # ---- to be named by the subclass ----------------------------------
    def make_trainer(self):
        raise NotImplementedError

    def span_targets(self):
        """[(owner, attribute, span, info)] to wrap in a traced run."""
        raise NotImplementedError

    @staticmethod
    def loss_of(out) -> torch.Tensor:
        return out

    # ---- set-up --------------------------------------------------------
    def setup(self) -> None:
        from silent_speech_tpu_torch.data.device_cache import DeviceCorpus

        marks = [("start", time.perf_counter())]
        self.plan()
        marks.append(("corpus made", time.perf_counter()))
        self.corpus = DeviceCorpus.build(self.corpus_host.examples,
                                         self.device)
        marks.append(("corpus on the device", time.perf_counter()))
        self.trainer = self.make_trainer()
        self.trainer.init_state(0)
        marks.append(("trainer built", time.perf_counter()))
        weight_law.load_into(self.trainer.model, weight_law.make(
            self.cfg, self.seed, self.device))
        self.trainer.generator = torch.Generator().manual_seed(
            self.draw_seed)
        if self.fault == "frozen":
            self.trainer.optimizer.step = lambda lr: True
        marks.append(("weights loaded", time.perf_counter()))
        self.readings = self._compared_steps()
        marks.append(("compared steps", time.perf_counter()))
        print("[setup] " + ", ".join(
            f"{name} {t - prev:.3f} s" for (_, prev), (name, t)
            in zip(marks, marks[1:])), file=sys.stderr)

    def plan(self) -> None:
        """The corpus on the host and the sampler's batches, from the
        seed."""
        self.corpus_host = traffic_law.make_corpus(self.traffic, self.seed)
        self.batches = traffic_law.batches(
            self.corpus_host.frames, int(self.cfg["max_batch_len"]),
            traffic_law.derived_seed(self.seed, "sampler"))

    def plan_compared(self) -> None:
        """The compared micro-steps' batches without the program (the
        control's runs)."""
        self.plan()
        self.compared = [next(self.batches)
                         for _ in range(COMPARED_UPDATES * self.accum)]

    def _program_ids(self, ids):
        return ids[: max(1, len(ids) // 2)] if self.fault == "half_batch" \
            else ids

    def _call(self, ids):
        out = self.trainer.train_step_ids(self.corpus, self._program_ids(ids),
                                          self.lr)
        if out is None:
            raise RuntimeError("a batch exceeded the caps of on-device "
                               "assembly")
        return self.loss_of(out)

    def _head_rows(self, ids) -> torch.Tensor:
        """Flattened output rows of the real frames of batch ``ids``, as
        the reference packs it."""
        _, starts, frames = layout(self.corpus_host.examples, ids, self.cfg)
        return torch.cat([torch.arange(s, s + t)
                          for s, t in zip(starts, frames)])

    def _compared_steps(self) -> Readings:
        opt = self.trainer.optimizer
        losses, grad_norms, heads = [], None, []

        def keep_head(module, args, out):
            out = out[0] if isinstance(out, tuple) else out
            heads.append(out.detach().reshape(-1, out.shape[-1]).float())

        for i in range(COMPARED_UPDATES * self.accum):
            ids = next(self.batches)
            self.compared.append(ids)
            hook = self.trainer.model.register_forward_hook(keep_head) \
                if i == 0 else None
            losses.append(self._call(ids))
            if hook is not None:
                hook.remove()
                rows = self._head_rows(ids).to(heads[0].device)
                heads = [heads[0][rows].cpu()]
            if i + 1 == self.accum:
                grad_norms = self._moment_norms(opt)
        start = weight_law.make(self.cfg, self.seed, self.device)
        with torch.no_grad():
            change = {n: float((p - start[n]).norm())
                      for n, p in self.trainer.model.named_parameters()}
        del start
        return Readings([float(x) for x in losses], grad_norms, change,
                        heads[0] if heads else None)

    def _moment_norms(self, opt) -> dict:
        b1 = float(self.cfg.get("betas", (0.9, 0.999))[0])
        names = [n for n, _ in self.trainer.model.named_parameters()]
        params = dict(self.trainer.model.named_parameters())
        if any(p is not params[n] for n, p in zip(names, opt.params)):
            raise RuntimeError("the optimizer's parameters are not the "
                               "model's, in order")
        with torch.no_grad():
            return {n: float(m.float().norm()) / (1.0 - b1)
                    for n, m in zip(names, opt.mu)}

    # ---- the window ----------------------------------------------------
    def step(self) -> int:
        ids = next(self.batches)
        self.last = self._call(ids)
        self.micro_steps += 1
        frames = int(self.corpus_host.frames[ids].sum())
        self.frames.append(frames)
        return frames

    def may_close(self) -> bool:
        """A window closes on an update boundary."""
        return self.micro_steps % self.accum == 0

    def close(self) -> float:
        """Read the last loss, which waits for the card."""
        loss = float(self.last) if self.last is not None else float("nan")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return loss

    def release(self) -> None:
        self.trainer = self.corpus = self.last = None

    # ---- the comparison ------------------------------------------------
    def reference(self, precision: str = "float32") -> Readings:
        w = weight_law.make(self.cfg, self.seed, self.device)
        return follow(self.cfg, w, self.corpus_host.examples, self.compared,
                      self.draw_seed, precision)
