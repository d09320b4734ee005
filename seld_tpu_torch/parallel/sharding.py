"""This rank's share of a global batch (counterpart: the batch_sharding
and time_batch_sharding of seld_tpu/parallel/sharding.py).

JAX places a global array with a sharding and GSPMD hands every device its
block; here every rank holds the global batch and slices its own block:
its data rank's rows and, under sequence parallelism, its model rank's
time chunk.
"""

from __future__ import annotations

import torch

from seld_tpu_torch.parallel.mesh import Mesh


def check_divisible(mesh: Mesh, batch: int, frames: int | None) -> None:
    """Raise as the JAX trainer does for a batch or a window that does not
    divide over the mesh."""
    if batch % mesh.n_data:
        raise ValueError(f"batch of {batch} rows does not divide over the "
                         f"{mesh.n_data}-way data axis")
    if frames is not None and frames % mesh.n_model:
        raise ValueError(
            f"mesh.shard_time: window_frames={frames} must divide by the model mesh "
            f"axis ({mesh.n_model}): pick a window length or mesh shape that divides "
            "evenly")


def batch_slice(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The data rank's rows of a (B, ...) array (batch_sharding)."""
    check_divisible(mesh, x.shape[0], None)
    rows = x.shape[0] // mesh.n_data
    return x[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]


def time_batch_slice(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The data rank's rows and the model rank's time chunk of a (B, T, ...)
    array (time_batch_sharding)."""
    check_divisible(mesh, x.shape[0], x.shape[1])
    rows, chunk = x.shape[0] // mesh.n_data, x.shape[1] // mesh.n_model
    return x[mesh.data_rank * rows:(mesh.data_rank + 1) * rows,
             mesh.model_rank * chunk:(mesh.model_rank + 1) * chunk]


def shard_batch(mesh: Mesh | None, time_sharded: bool, *arrays):
    """Each (B, ...) array sliced to this rank's block; a 1-D (B,) array
    (the example mask) by rows only. None passes through."""
    if mesh is None:
        return arrays
    return tuple(
        None if a is None
        else time_batch_slice(mesh, a) if time_sharded and a.dim() >= 2
        else batch_slice(mesh, a)
        for a in arrays
    )
