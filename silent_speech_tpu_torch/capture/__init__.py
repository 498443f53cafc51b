"""EMG capture. The port has the synthetic board only
(``capture/recorder.py``); the hardware boards, the microphone and the
recording session are the JAX package's (``silent_speech_tpu/capture``)."""
