"""Training: the optimizer, its schedule, and the trainer."""
