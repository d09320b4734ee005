"""Multi-GPU layer (counterpart: seld_tpu/parallel): the process mesh,
torchrun start-up, batch slicing and the sequence-parallel collectives."""
