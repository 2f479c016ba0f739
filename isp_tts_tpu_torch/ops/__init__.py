"""Attention ops: the einsum SDPA and the folded-MQA kernel K1."""
