"""Kernel K5: ring attention, exact attention over time chunks that rotate
around the model axis (counterpart: seld_tpu/ops/ring_attention.py).

Replaces seld_tpu/ops/ring_attention.py::ring_flash_attention. Under
sequence parallelism every rank of a model group holds its (B, H, T/n, Dh)
time chunk of q, k and v. K/V chunks travel n - 1 steps around the ring
(rank m sends to m + 1 and receives from m - 1, `dist.batch_isend_irecv`
posted before the chunk's kernel, so the transfer overlaps it), and each
step runs K3's forward kernel on (q_local, k_c, v_c) -> (o_c, lse_c) and
merges it in float32:

    lse' = logaddexp(lse, lse_c),  o = o exp(lse - lse') + o_c exp(lse_c - lse')

from -inf and zeros, cast once at the end. The backward is one more ring
pass with the GLOBAL lse and the merged out: delta = rowsum(dO * out) is
formed once (in bf16 by the first dQ launch, in float32 by `row_delta`) and
given to every later step; dQ accumulates locally in float32, and the
float32 dK/dV accumulators travel with their chunk and are home after n
shifts. K5 has no kernel of its own, as the TPU version has no
`pallas_call` of its own: it launches K3's three kernels per chunk (on CUDA
tensors always, whatever the chunk's length: a 250-frame chunk is below
FLASH_MIN_SEQ_LEN and still takes K3), and the merge stays in torch ops,
as the JAX package computes it in jnp outside the kernels. What bounds it
is K3's (operations) plus the merge's float32 bytes; see PERF.md.

The schedule is written once over "lanes", the ranks this process holds:
the process-group ring holds one (its own rank; shifts are sends and
receives), the virtual ring holds all n in one process (a shift is a
rotation of the list, no copy), so one card can run an n-rank ring with
the same step functions. The virtual ring adds the partials in the same
order as the process-group ring, so the two agree bit for bit.

On CPU tensors the steps are the plain versions, `flash_attention_reference`
and `chunk_grads_reference`; on CUDA tensors they are K3's kernels, unless a
virtual-ring caller asks for the plain steps by name (the card's check and
the plain timing). Every K3 launch the ring makes adds one to
`ring_flash_attention.fwd_launches`, `.bwd_dq_launches` or
`.bwd_dkv_launches`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from seld_tpu_torch.ops.flash_attention import (
    _check,
    _kernel_ready,
    chunk_grads_reference,
    flash_attention_reference,
    launch_dkv,
    launch_dq,
    launch_forward,
    row_delta,
)


def _bthd_zeros(like: torch.Tensor) -> torch.Tensor:
    """float32 zeros of like's (B, H, T, Dh) shape stored as (B, T, H, Dh),
    the layout of K3's outputs and of the model's heads."""
    b, h, t, d = like.shape
    return torch.zeros((b, t, h, d), dtype=torch.float32, device=like.device).transpose(1, 2)


def _forward_step(q, k, v, scale: float, plain: bool):
    """One chunk's (out, lse): K3's forward kernel, or its plain version."""
    if plain or q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    out = launch_forward(q, k, v, scale)
    ring_flash_attention.fwd_launches += 1
    return out


def _merge(o_run, lse_run, o_c, lse_c):
    """Fold a chunk's (o_c, lse_c) into the running float32 (o, lse)."""
    b, h, t, _ = o_c.shape
    lse_new = torch.logaddexp(lse_run, lse_c)
    w_old = torch.exp(lse_run - lse_new).view(b, h, t, 1)
    w_new = torch.exp(lse_c - lse_new).view(b, h, t, 1)
    return o_run * w_old + o_c.float() * w_new, lse_new


def _backward_step(q, k, v, g, out, lse, delta, scale: float, plain: bool):
    """One chunk's (dq, dk, dv, delta) with the global lse: K3's dQ (which
    forms delta when it is None) and dK/dV kernels, or their plain
    version."""
    if plain or q.device.type == "cpu":
        if delta is None:
            delta = row_delta(g, out)
        return (*chunk_grads_reference(q, k, v, g, lse, delta, scale), delta)
    dq, delta = launch_dq(q, k, v, g, out, lse, scale, delta=delta)
    dk, dv = launch_dkv(q, k, v, g, lse, delta, scale)
    ring_flash_attention.bwd_dq_launches += 1
    ring_flash_attention.bwd_dkv_launches += 1
    return dq, dk, dv, delta


class _Done:
    """A finished shift."""

    def __init__(self, items):
        self.items = items

    def wait(self):
        return self.items


class _Posted:
    """A shift in flight: its receive buffers, valid after wait()."""

    def __init__(self, works, sent, received):
        self.works, self.sent, self.received = works, sent, received

    def wait(self):
        for work in self.works:
            work.wait()
        self.sent = None  # the sends are done with their buffers
        return [self.received]


class _GroupRing:
    """The ring of a process group: one lane, this rank's; a shift sends
    the lane's tensors to the next rank and receives the previous rank's
    into fresh contiguous buffers."""

    def __init__(self, group):
        ranks = dist.get_process_group_ranks(group)
        me = dist.get_rank(group)
        self.n = len(ranks)
        self.send_to = ranks[(me + 1) % self.n]
        self.recv_from = ranks[(me - 1) % self.n]

    def rotate(self, lanes, tag: int = 0):
        """Post the shift of lanes[0]'s tensors, the i-th under tag + i:
        two shifts in flight at once (K/V and the dK/dV accumulators in
        the backward) take tags that cannot match each other."""
        if self.n == 1:
            return _Done(lanes)
        sent = tuple(t.contiguous() for t in lanes[0])
        received = tuple(torch.empty_like(t) for t in sent)
        ops = ([dist.P2POp(dist.isend, t, self.send_to, tag=tag + i)
                for i, t in enumerate(sent)]
               + [dist.P2POp(dist.irecv, t, self.recv_from, tag=tag + i)
                  for i, t in enumerate(received)])
        return _Posted(dist.batch_isend_irecv(ops), sent, received)


class _VirtualRing:
    """n ranks in one process: lane i is rank i, and a shift hands lane
    i - 1's tensors to lane i."""

    def __init__(self, n: int):
        self.n = n

    def rotate(self, lanes, tag: int = 0):
        return _Done([lanes[(i - 1) % self.n] for i in range(self.n)])


_ACC_TAG = 2  # the dK/dV accumulators' shift; K/V's takes tags 0 and 1


def _ring_forward(ring, qs, ks, vs, scale: float, plain: bool):
    """Each lane's (out in q's dtype, global lse (B*H, T) float32)."""
    outs = [_bthd_zeros(q) for q in qs]
    lses = [torch.full((q.shape[0] * q.shape[1], q.shape[2]), float("-inf"),
                       dtype=torch.float32, device=q.device) for q in qs]
    kv = list(zip(ks, vs))
    for step in range(ring.n):
        # post the next shift first: it reads the chunks the kernels read
        shift = ring.rotate(kv) if step + 1 < ring.n else None
        for i, q in enumerate(qs):
            o_c, lse_c = _forward_step(q, *kv[i], scale, plain)
            outs[i], lses[i] = _merge(outs[i], lses[i], o_c, lse_c)
        if shift is not None:
            kv = shift.wait()
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def _ring_backward(ring, qs, ks, vs, gs, outs, lses, scale: float, plain: bool):
    """Each lane's (dq, dk, dv) in its inputs' dtype."""
    dqs = [_bthd_zeros(q) for q in qs]
    deltas = [None] * len(qs)
    kv = list(zip(ks, vs))
    acc = acc_shift = None
    for step in range(ring.n):
        kv_shift = ring.rotate(kv) if step + 1 < ring.n else None
        parts = []
        for i, q in enumerate(qs):
            dq, dk, dv, deltas[i] = _backward_step(q, *kv[i], gs[i], outs[i], lses[i],
                                                   deltas[i], scale, plain)
            dqs[i] = dqs[i] + dq.float()
            parts.append((dk.float(), dv.float()))
        # the dK/dV accumulators travel with their chunk: the one that
        # arrives now belongs to the chunk this lane just used
        if acc_shift is not None:
            acc = acc_shift.wait()
        acc = parts if acc is None else [(a_k + p_k, a_v + p_v)
                                         for (a_k, a_v), (p_k, p_v) in zip(acc, parts)]
        acc_shift = ring.rotate(acc, tag=_ACC_TAG)
        if kv_shift is not None:
            kv = kv_shift.wait()
    acc = acc_shift.wait()  # n shifts: every accumulator is home
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [a_k.to(k.dtype) for (a_k, _), k in zip(acc, ks)],
            [a_v.to(v.dtype) for (_, a_v), v in zip(acc, vs)])


def _prepare(q, k, v):
    _check(q, k, v)
    if q.device.type == "cuda":
        return _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    if q.device.type != "cpu":
        raise ValueError(f"K5 runs on CUDA or CPU tensors, got {q.device}")
    return q, k, v


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        q, k, v = _prepare(q, k, v)
        ring = _GroupRing(group)
        (out,), (lse,) = _ring_forward(ring, [q], [k], [v], scale, False)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale = group, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        g = _kernel_ready(g) if g.is_cuda else g
        (dq,), (dk,), (dv,) = _ring_backward(_GroupRing(ctx.group), [q], [k], [v], [g],
                                             [out], [lse], ctx.scale, False)
        return dq, dk, dv, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                         scale: float | None = None, return_lse: bool = False):
    """Exact softmax attention of this rank's (B, H, T/n, Dh) query chunk
    over the keys and values of every rank of `group` (default: the
    world), whose chunks are in time order by group rank; differentiable
    in q, k and v. Every rank of the group must call it, with chunks of
    one shape. With return_lse the (B*H, T/n) float32 global logsumexp
    comes beside out."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    out, lse = _RingAttention.apply(q, k, v, group if group is not None else
                                    dist.group.WORLD, scale)
    return (out, lse) if return_lse else out


def virtual_ring_attention(qs, ks, vs, scale: float | None = None, plain: bool = False):
    """The ring over n = len(qs) virtual ranks in this process, lane i
    holding chunk i of q, k and v: (outs, lses) per lane, what rank i of an
    n-rank process-group ring returns. plain=True runs the plain steps on
    any device (the oracle and what K5 is timed against)."""
    qs, ks, vs = zip(*(_prepare(q, k, v) for q, k, v in zip(qs, ks, vs)))
    scale = float(qs[0].shape[-1] ** -0.5 if scale is None else scale)
    return _ring_forward(_VirtualRing(len(qs)), qs, ks, vs, scale, plain)


def virtual_ring_backward(qs, ks, vs, gs, outs, lses, scale: float | None = None,
                          plain: bool = False):
    """The ring backward over virtual ranks: (dqs, dks, dvs) per lane, from
    the lanes' output cotangents gs and virtual_ring_attention's outs and
    lses."""
    qs, ks, vs = zip(*(_prepare(q, k, v) for q, k, v in zip(qs, ks, vs)))
    gs = [_kernel_ready(g.to(q.dtype)) if g.is_cuda else g.to(q.dtype)
          for g, q in zip(gs, qs)]
    scale = float(qs[0].shape[-1] ** -0.5 if scale is None else scale)
    return _ring_backward(_VirtualRing(len(qs)), qs, ks, vs, gs, outs, lses, scale, plain)


ring_flash_attention.fwd_launches = 0
ring_flash_attention.bwd_dq_launches = 0
ring_flash_attention.bwd_dkv_launches = 0
