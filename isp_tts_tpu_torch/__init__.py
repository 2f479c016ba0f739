"""PyTorch/CUDA port of isp_tts_tpu: text -> mel synthesis on an NVIDIA H100."""
