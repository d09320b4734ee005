"""Tools over a run's checkpoints, metrics and targets (counterpart:
seld_tpu/tools)."""
