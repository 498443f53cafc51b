"""PyTorch/CUDA port of silent_speech_tpu for NVIDIA Hopper."""
