"""Kernel K5: ring attention, exact attention over time chunks that rotate
around the model axis (counterpart: seld_tpu/ops/ring_attention.py).

Replaces seld_tpu/ops/ring_attention.py::ring_flash_attention. Under
sequence parallelism every rank of a model group holds its (B, H, T/n, Dh)
time chunk of q, k and v. K/V chunks travel n - 1 steps around the ring
(rank m sends to m + 1 and receives from m - 1, `dist.batch_isend_irecv`
posted before the chunk's kernel, so the transfer overlaps it), and each
step runs K3's forward kernel on (q_local, k_c, v_c) in its ring mode
(csrc/flash_attention_kernel.cu): the epilogue folds the chunk's
normalised float32 o_c and lse_c into the lane's running float32 pair,

    lse' = logaddexp(lse, lse_c),  o = o exp(lse - lse') + o_c exp(lse_c - lse')

which the first step writes and the last stores as out in q's dtype. The
backward is one more ring pass with the GLOBAL lse and the merged out:
delta = rowsum(dO * out) is formed once (in bf16 by the first dQ launch, in
float32 by `row_delta`) and given to every later step; the dQ kernel adds
its float32 partial into the lane's running dq (the last step stores dq),
and the dK/dV kernel adds into the float32 dK/dV accumulators that travel
with their chunk and are home after n shifts, where one cast per lane
gives dk and dv. A ring step is one launch forward and two backward, with
nothing between steps; at n = 1 the ring launches exactly K3's three
kernels in their own mode and gives K3's bits. On CUDA tensors the steps
launch K3's kernels whatever the chunk's length (a 250-frame chunk is
below FLASH_MIN_SEQ_LEN and still takes K3). What bounds it is K3's
operations at the whole T (see PERF.md); the running state's float32
bytes are this design's cost on top.

The schedule is written once over "lanes", the ranks this process holds:
the process-group ring holds one (its own rank; shifts are sends and
receives), the virtual ring holds all n in one process (a shift is a
rotation of the list, no copy), so one card can run an n-rank ring with
the same step functions. The virtual ring adds the partials in the same
order as the process-group ring, so the two agree bit for bit. In the
backward the dQ launches of a step are queued before the wait for the
arriving dK/dV accumulators, so they overlap the transfer.

On CPU tensors the steps are their plain versions below
(`forward_step_reference`, `dq_step_reference`, `dkv_step_reference`: the
kernels' modes and rounding points in torch ops); on CUDA tensors they are
K3's kernels, unless a virtual-ring caller asks for the plain steps by name
(the card's check and the plain timing). Every kernel launch the ring makes
adds one to `ring_flash_attention.fwd_launches`, `.bwd_dq_launches` or
`.bwd_dkv_launches`, and one to K3's counter of its kind.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from seld_tpu_torch.ops import flash_attention as k3
from seld_tpu_torch.ops.counters import bump
from seld_tpu_torch.ops.flash_attention import (
    _check,
    _empty_bthd,
    _kernel_ready,
    attention_f32_reference,
    chunk_partials_reference,
    row_delta,
)


def _merge(o_run, lse_run, o_c, lse_c):
    """Fold a chunk's (o_c, lse_c) into the running float32 (o, lse)."""
    b, h, t, _ = o_c.shape
    lse_new = torch.logaddexp(lse_run, lse_c)
    w_old = torch.exp(lse_run - lse_new).view(b, h, t, 1)
    w_new = torch.exp(lse_c - lse_new).view(b, h, t, 1)
    return o_run * w_old + o_c.float() * w_new, lse_new


def _store(total, run, result, final: bool) -> None:
    """Where a ring mode puts its float32 result: result (cast to its
    dtype) when final, else the running state."""
    (result if final else run).copy_(total)


def forward_step_reference(q, k, v, scale: float, out, lse, run, read: bool,
                           final: bool) -> None:
    """The plain version of `flash_attention.forward_step`: the chunk's
    float32 normalised out and lse, merged into (run, lse) with `read`,
    stored to out (final) or run, in place."""
    o_c, lse_c = attention_f32_reference(q, k, v, scale)
    if read:
        o_c, lse_c = _merge(run, lse, o_c, lse_c)
    lse.copy_(lse_c)
    _store(o_c, run, out, final)


def dq_step_reference(q, k, v, g, out, lse, scale: float, delta, dq, run, read: bool,
                      final: bool):
    """The plain version of `flash_attention.dq_step`: the chunk's float32
    dq added to run (read), stored to dq (final) or run; returns delta."""
    if delta is None:
        delta = row_delta(g, out)
    part = chunk_partials_reference(q, k, v, g, lse, delta, scale, dkv=False)[0]
    _store(run + part if read else part, run, dq, final)
    return delta


def dkv_step_reference(q, k, v, g, lse, delta, scale: float, dk, dv, dk_run, dv_run,
                       read: bool, final: bool) -> None:
    """The plain version of `flash_attention.dkv_step`: the chunk's float32
    dk and dv added to the running sums (read), stored to dk, dv (final) or
    the sums."""
    _, dk_p, dv_p = chunk_partials_reference(q, k, v, g, lse, delta, scale, dq=False)
    for part, run, result in ((dk_p, dk_run, dk), (dv_p, dv_run, dv)):
        _store(run + part if read else part, run, result, final)


def _forward_step(*args) -> None:
    k3.forward_step(*args)
    bump(ring_flash_attention, "fwd_launches")


def _dq_step(*args):
    delta = k3.dq_step(*args)
    bump(ring_flash_attention, "bwd_dq_launches")
    return delta


def _dkv_step(*args) -> None:
    k3.dkv_step(*args)
    bump(ring_flash_attention, "bwd_dkv_launches")


def _steps(q, plain: bool):
    """(forward, dQ, dK/dV) step functions: the kernels on CUDA tensors,
    the plain versions on CPU tensors or by name."""
    if plain or q.device.type == "cpu":
        return forward_step_reference, dq_step_reference, dkv_step_reference
    return _forward_step, _dq_step, _dkv_step


def _running(result: torch.Tensor) -> torch.Tensor:
    """The float32 running state beside a result: the result itself when
    that is float32."""
    return result if result.dtype == torch.float32 else _empty_bthd(result, torch.float32)


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
    n = ring.n
    step_fn = _steps(qs[0], plain)[0]
    outs = [_empty_bthd(q) for q in qs]
    lses = [torch.empty((q.shape[0] * q.shape[1], q.shape[2]), dtype=torch.float32,
                        device=q.device) for q in qs]
    runs = [_running(out) if n > 1 else None for out in outs]
    kv = list(zip(ks, vs))
    for step in range(n):
        # post the next shift first: it reads the chunks the kernels read
        shift = ring.rotate(kv) if step + 1 < n else None
        for i, q in enumerate(qs):
            step_fn(q, *kv[i], scale, outs[i], lses[i], runs[i], step > 0, step + 1 == n)
        if shift is not None:
            kv = shift.wait()
    return outs, lses


def _accumulators(kv, n: int):
    """The first step's dK/dV buffers per lane: at n = 1 dk and dv
    themselves; else float32 accumulators, contiguous (B, T, H, Dh) so
    that a shift sends them as they are."""
    if n == 1:
        return [(_empty_bthd(k), _empty_bthd(v)) for k, v in kv]
    return [tuple(torch.empty(x.transpose(1, 2).shape, dtype=torch.float32, device=x.device)
                  for x in pair) for pair in kv]


def _ring_backward(ring, qs, ks, vs, gs, outs, lses, scale: float, plain: bool):
    """Each lane's (dq, dk, dv) in its inputs' dtype."""
    n = ring.n
    _, dq_fn, dkv_fn = _steps(qs[0], plain)
    dqs = [_empty_bthd(q) for q in qs]
    dq_runs = [_running(dq) if n > 1 else None for dq in dqs]
    deltas = [None] * len(qs)
    kv = list(zip(ks, vs))
    acc_shift = None
    for step in range(n):
        kv_shift = ring.rotate(kv) if step + 1 < n else None
        read, last = step > 0, step + 1 == n
        for i, q in enumerate(qs):  # queued before the accumulators' arrival
            deltas[i] = dq_fn(q, *kv[i], gs[i], outs[i], lses[i], scale, deltas[i], dqs[i],
                              dq_runs[i], read, last)
        # the dK/dV accumulators travel with their chunk: the one that
        # arrives now belongs to the chunk this lane holds
        acc = acc_shift.wait() if acc_shift is not None else _accumulators(kv, n)
        for i, q in enumerate(qs):
            a_k, a_v = acc[i]
            if n == 1:  # K3's own mode: dk and dv stored in their dtype
                dkv_fn(q, *kv[i], gs[i], lses[i], deltas[i], scale, a_k, a_v, None, None,
                       False, True)
            else:
                dkv_fn(q, *kv[i], gs[i], lses[i], deltas[i], scale, None, None,
                       a_k.transpose(1, 2), a_v.transpose(1, 2), read, False)
        acc_shift = ring.rotate(acc, tag=_ACC_TAG)
        if kv_shift is not None:
            kv = kv_shift.wait()
    acc = acc_shift.wait()  # n shifts: every accumulator is home
    if n > 1:
        acc = [tuple(a.to(x.dtype).transpose(1, 2) for a, x in zip(pair, (k, v)))
               for pair, k, v in zip(acc, ks, vs)]
    return dqs, [a_k for a_k, _ in acc], [a_v for _, a_v in acc]


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
