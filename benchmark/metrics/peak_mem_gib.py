"""The card memory a training run needs: the highest
``torch.cuda.max_memory_allocated()`` of the run up to the window's close,
resident corpus, weights, optimizer state and activations included."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2 ** 30
