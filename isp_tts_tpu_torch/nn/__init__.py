"""Building blocks of the acoustic model (inference)."""
