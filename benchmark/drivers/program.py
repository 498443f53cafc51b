"""What the training drivers take from the program: its configuration
objects, built from a configuration file, and the spans they wrap, with
what each records of a call.

A span's ``info`` keeps shapes and the host ints it finds, and references
to small length tensors on the device, read only after the window has
closed, so that recording waits for nothing.
"""

from __future__ import annotations


def model_config(c: dict):
    from silent_speech_tpu_torch.config import ModelConfig

    return ModelConfig(
        model_size=int(c["model_size"]), num_layers=int(c["num_layers"]),
        dropout=float(c["dropout"]), num_heads=int(c["num_heads"]),
        dim_feedforward=int(c["dim_feedforward"]),
        relative_positional_distance=int(c["relative_positional_distance"]),
        raw_channels=int(c["raw_channels"]),
        compute_dtype=c["compute_dtype"],
        shift_augment=bool(c["shift_augment"]))


def data_config(c: dict):
    from silent_speech_tpu_torch.config import DataConfig

    return DataConfig(seq_len=int(c["seq_len"]),
                      chunk_bucket=int(c["chunk_bucket"]),
                      utt_cap=int(c["utt_cap"]), t_cap=int(c["t_cap"]))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def attention(q, k, v, rel_emb, max_dist, valid_len=None, *args, **kw):
    b, h, t, dh = q.shape
    return dict(b=b, h=h, t=t, dh=dh, m=int(max_dist),
                valid_len=t if valid_len is None else int(valid_len),
                dtype=_dtype(q))


def attention_bwd(q, k, v, rel_emb, dout, max_dist, *args, **kw):
    b, h, t, dh = q.shape
    return dict(b=b, h=h, t=t, dh=dh, m=int(max_dist), dtype=_dtype(q))


def dtw(costs, n1, n2, *args, **kw):
    return dict(shape=tuple(costs.shape), item=costs.element_size(),
                n1=n1, n2=n2)


def ctc(lp, utt_len, labels, text_len, *args, **kw):
    return dict(shape=tuple(lp.shape), utt_len=utt_len, text_len=text_len,
                labels_width=int(labels.shape[1]))


def common(trainer):
    """The spans both trainers have: the step, the optimizer, the model's
    forward, the attention's forward and backward."""
    from silent_speech_tpu_torch.models import transformer
    from silent_speech_tpu_torch.ops import rel_attention

    return [(trainer, "train_step_ids", "train_step_ids", None),
            (trainer.optimizer, "step", "optimizer.step", None),
            (trainer.model, "forward", "model.forward", None),
            (transformer, "rel_attention", "rel_attention", attention),
            (rel_attention, "rel_attention_bwd", "rel_attention_bwd",
             attention_bwd)]
