"""The process mesh (counterpart: seld_tpu/parallel/mesh.py).

A (data, model) grid of processes, one GPU each. Rank r sits at
(r // n_model, r % n_model), JAX's row-major device grid. The data axis
splits a batch's rows; the model axis splits the window's time axis under
sequence parallelism (mesh.shard_time). Every rank holds a whole replica
of the parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from seld_tpu_torch.parallel.multihost import initialize_multihost, launched_world_size

@dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid and its process groups.

    world: every rank (gradients, BatchNorm statistics and loss counts are
    summed over it). data_group: the ranks of this rank's model column,
    which differ in their rows of the batch. model_group: the ranks of this
    rank's data row, which hold the time chunks of the same rows, in time
    order (the ring's neighbours). *_ranks list each group's global ranks
    in group order."""

    n_data: int
    n_model: int
    rank: int
    world: object
    data_group: object
    model_group: object
    data_ranks: tuple[int, ...]
    model_ranks: tuple[int, ...]

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: int = -1, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over the initialised process group; n_data=-1
    takes every rank n_model leaves. Every rank creates every subgroup, in
    the same order, as torch.distributed requires."""
    world = dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"model axis {n_model} does not divide the {world} ranks")
    if n_data == -1:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    data_group = model_group = None
    data_ranks = model_ranks = ()
    for m in range(n_model):  # the data-axis groups: one per model column
        ranks = tuple(d * n_model + m for d in range(n_data))
        group = dist.new_group(list(ranks))
        if rank in ranks:
            data_group, data_ranks = group, ranks
    for d in range(n_data):  # the model-axis groups: one per data row
        ranks = tuple(d * n_model + m for m in range(n_model))
        group = dist.new_group(list(ranks))
        if rank in ranks:
            model_group, model_ranks = group, ranks
    return Mesh(n_data, n_model, rank, dist.group.WORLD, data_group, model_group,
                data_ranks, model_ranks)


def mesh_from_config(mesh_cfg, device: torch.device) -> Mesh | None:
    """The mesh that `mesh_cfg` (config.MeshConfig) asks for, joining the
    launch's process group first; None when it asks for none."""
    if mesh_cfg.enable not in ("auto", "on", "off"):
        raise ValueError(f"mesh.enable must be auto, on or off, got {mesh_cfg.enable!r}")
    if mesh_cfg.model_axis > 1 and not mesh_cfg.shard_time:
        raise NotImplementedError(
            "mesh.model_axis > 1 without mesh.shard_time is tensor parallelism, which "
            "the port does not have (ROADMAP item 10's remainder)")
    if mesh_cfg.enable == "off" or (mesh_cfg.enable == "auto" and launched_world_size() == 1):
        return None
    initialize_multihost(device)
    return make_mesh(mesh_cfg.data_axis, mesh_cfg.model_axis)
