"""The benchmark of the PyTorch and CUDA port (``silent_speech_tpu_torch``)
on one H100: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. ``BENCHMARK.json``
names the cells; see ``harness.py`` for where each part lives."""
