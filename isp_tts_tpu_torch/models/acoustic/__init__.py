"""The acoustic model, text -> mel (inference)."""
