"""Driver of ``TransductionTrainer.train_step_ids``
(``silent_speech_tpu_torch/train/transduction.py``): EMG → mel and
phoneme training with the DTW-aligned loss on silent rows."""

from __future__ import annotations

from benchmark.drivers import program
from benchmark.drivers.training import TrainingDriver


class Driver(TrainingDriver):
    def make_trainer(self):
        from silent_speech_tpu_torch.config import TransductionTrainConfig
        from silent_speech_tpu_torch.train.transduction import \
            TransductionTrainer

        c = self.cfg
        train = TransductionTrainConfig(
            learning_rate=self.lr,
            phoneme_loss_weight=float(c["phoneme_loss_weight"]),
            l2=float(c["l2"]), moment_dtype=c["moment_dtype"],
            max_batch_len=int(c["max_batch_len"]))
        return TransductionTrainer(program.model_config(c),
                                   program.data_config(c), train,
                                   num_mel_bins=int(c["num_outs"]),
                                   device=self.device)

    @staticmethod
    def loss_of(out):
        return out.loss

    def span_targets(self):
        from silent_speech_tpu_torch.train import losses

        return program.common(self.trainer) + [
            (losses, "dtw_align_batch", "dtw_align_batch", program.dtw)]
