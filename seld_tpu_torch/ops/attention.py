"""Multi-head self-attention (counterpart: seld_tpu/ops/attention.py).

Below FLASH_MIN_SEQ_LEN the JAX package runs plain einsum attention, and
so does this module: scores and softmax in float32, the probabilities
cast to the compute dtype for the value product, the output in the
compute dtype. At T >= 512 the JAX package runs its flash-attention
kernel K3 on the accelerator; K3 is not ported yet, so that case raises
on CUDA instead of quietly taking the plain path.
"""

from __future__ import annotations

import torch

FLASH_MIN_SEQ_LEN = 512


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """q, k, v: (B, H, T, Dh) in the compute dtype -> (B, H, T, Dh)."""
    if q.is_cuda and q.shape[-2] >= FLASH_MIN_SEQ_LEN:
        raise NotImplementedError(
            f"attention at T={q.shape[-2]} >= {FLASH_MIN_SEQ_LEN} runs the "
            "flash-attention kernel K3, which is not ported yet (ROADMAP: "
            "long windows)"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.matmul(probs.to(q.dtype), v)
