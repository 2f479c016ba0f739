"""Kernel ops: folded-MQA attention (K1, K2), MAS (K3), banded CTC (K4),
each with its plain version, and the nvcc build."""
