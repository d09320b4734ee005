"""Tools over a run's checkpoints (counterpart: seld_tpu/tools)."""
