"""Multi-head self-attention (counterpart: seld_tpu/ops/attention.py).

Below FLASH_MIN_SEQ_LEN the JAX package runs plain einsum attention, and
so does this module: scores and softmax in float32, the probabilities
cast to the compute dtype for the value product, the output in the
compute dtype. From T = FLASH_MIN_SEQ_LEN on, where the JAX package
switches to its flash-attention kernel on the accelerator, CUDA tensors go
through kernel K3 (seld_tpu_torch.ops.flash_attention), which never
writes the (T x T) scores to device memory. CPU tensors take the plain
product at any length, as every kernel wrapper of this package resolves by
device.

Under a time-sharded mesh (`attention_mesh(mesh, time_sharded=True)`,
sequence parallelism) q, k and v are this rank's time chunks. When the
global T (T_local x the model axis) is at least FLASH_MIN_SEQ_LEN, or
inside force_flash(True), attention runs the ring, kernel K5
(seld_tpu_torch.ops.ring_attention), which launches K3 per chunk on CUDA
tensors and its plain version on CPU tensors; otherwise, and inside
force_flash(False), it is the plain product of the local queries over the
keys and values all-gathered on the model group, which is what GSPMD's
partitioned einsum computes in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from seld_tpu_torch.ops.flash_attention import flash_attention
from seld_tpu_torch.ops.ring_attention import ring_flash_attention
from seld_tpu_torch.parallel.sequence import (  # noqa: F401 (attention_mesh: the steps' scope)
    all_gather_time,
    attention_mesh,
    current_mesh,
)

FLASH_MIN_SEQ_LEN = 512

_FORCE = contextvars.ContextVar("seld_tpu_torch_attention_force_flash", default=None)


@contextlib.contextmanager
def force_flash(enabled: bool = True):
    """Override the length rule inside the block (tests and measurement).

    True sends every call through kernel K3 whatever its length, and
    raises for a CPU tensor; False keeps the plain product on any device
    (the oracle, and what K3 is timed against). A ContextVar: other
    threads keep their own setting."""
    token = _FORCE.set(bool(enabled))
    try:
        yield
    finally:
        _FORCE.reset(token)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """q, k, v: (B, H, T, Dh) in the compute dtype -> (B, H, T, Dh)."""
    forced = _FORCE.get()
    if forced and not q.is_cuda:
        raise ValueError(
            f"force_flash(True) launches kernel K3 and needs CUDA tensors, got {q.device}"
        )
    mesh, time_sharded = current_mesh()
    if time_sharded:  # time chunks (one at a 1-way model axis): K5 or the gathered product
        use_ring = forced if forced is not None else (
            q.shape[-2] * mesh.n_model >= FLASH_MIN_SEQ_LEN)
        if use_ring:
            return ring_flash_attention(q, k, v, mesh.model_group, scale)
        k, v = all_gather_time(k, 2, mesh), all_gather_time(v, 2, mesh)
    elif forced if forced is not None else (q.is_cuda and q.shape[-2] >= FLASH_MIN_SEQ_LEN):
        return flash_attention(q, k, v, scale=scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.matmul(probs.to(q.dtype), v)
