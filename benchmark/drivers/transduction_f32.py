"""Driver of the float32 transduction step: ``drivers/transduction.py``'s
driver of ``TransductionTrainer.train_step_ids``, under a configuration
that computes in float32, with one span more: ``bench.conv_block`` around
the forward of each of the encoder's three ResBlocks, which
``conv_fwd_f32_ms`` reads. A call records the block's compute dtype.

The configuration states float32 with TF32 off in cuBLAS and cuDNN. A
program whose float32 step has no full-FP32 scope
(``utils.device.full_fp32``) runs cuDNN in TF32, below the precision
stated: set-up stops there, before any step, so that such a program fails
the cell at once rather than after a whole run. A float32 step that runs
outside the scope is left to the comparison: ``head_gap`` fails TF32
convolutions.

The reference (``reference/train.py``) picks its loss by the
configuration's ``entry``, and knows this configuration's loss as
``"transduction"``: the driver hands it the configuration under that
entry.
"""

from __future__ import annotations

from benchmark import weights as weight_law
from benchmark.drivers import transduction
from benchmark.reference.train import follow


def _conv_block(block):
    def info(*args, **kwargs):
        return dict(dtype=str(block.compute_dtype).replace("torch.", ""))
    return info


class Driver(transduction.Driver):
    def make_trainer(self):
        from silent_speech_tpu_torch.utils import device

        if not hasattr(device, "full_fp32"):
            raise RuntimeError(
                "the program has no full-FP32 step "
                "(utils.device.full_fp32): its float32 step would run "
                "cuDNN in TF32, below this configuration's float32")
        return super().make_trainer()

    def span_targets(self):
        return super().span_targets() + [
            (block, "forward", "conv_block", _conv_block(block))
            for block in self.trainer.model.conv_blocks]

    def reference(self, precision: str = "float32"):
        cfg = dict(self.cfg, entry="transduction")
        w = weight_law.make(cfg, self.seed, self.device)
        return follow(cfg, w, self.corpus_host.examples, self.compared,
                      self.draw_seed, precision)
