"""Driver of ``RecognitionTrainer.train_step_ids``
(``silent_speech_tpu_torch/train/recognition.py``): EMG → text CTC
training with gradient accumulation."""

from __future__ import annotations

from benchmark.drivers import program
from benchmark.drivers.training import TrainingDriver


class Driver(TrainingDriver):
    def make_trainer(self):
        from silent_speech_tpu_torch.config import RecognitionTrainConfig
        from silent_speech_tpu_torch.train.recognition import \
            RecognitionTrainer

        c = self.cfg
        train = RecognitionTrainConfig(
            learning_rate=self.lr, l2=float(c["l2"]),
            moment_dtype=c["moment_dtype"],
            max_batch_len=int(c["max_batch_len"]),
            grad_accum=self.accum)
        trainer = RecognitionTrainer(program.model_config(c),
                                     program.data_config(c), train,
                                     device=self.device)
        if trainer.blank_id + 1 != int(c["num_outs"]):
            raise ValueError(f"the program's recognizer has "
                             f"{trainer.blank_id + 1} classes, the "
                             f"configuration {c['num_outs']}")
        return trainer

    def span_targets(self):
        from silent_speech_tpu_torch.ops import ctc
        from silent_speech_tpu_torch.train import losses

        return program.common(self.trainer) + [
            (losses, "ctc_nll", "ctc_nll", program.ctc),
            (ctc, "_launch_bwd", "ctc_nll.backward", None)]
