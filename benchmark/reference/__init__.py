"""The plain reference: the EMG encoder, its two training losses and AdamW
in plain PyTorch and NumPy, computed in float32 with TF32 off.

It follows the model of Gaddy & Klein (ACL 2021, arXiv:2106.01933;
``dgaddy/silent_speech`` ``transduction_model.py``, ``recognition_model.py``,
``architecture.py``, ``transformer.py``, ``align.py``) as the configuration
files in ``benchmark/configs/`` state it, and works out again, from the
benchmark's inputs alone, everything the program derives from them: the
packed batch, the shift and the dropout masks (``draws.py``: frozen copies
of the counter hash and of the order in which a step draws its seeds), the
DTW alignment (NumPy, float64). It imports nothing of the program.

``precision="fp8"`` is the control: the operands of every product
(convolutions, dense layers, the attention's four products) rounded to
float8 e4m3 with a per-tensor scale, and their gradients to e5m2, the step
below the configuration's bfloat16 that would tempt a later change.
"""
