"""Kernel K3: flash attention, forward and backward (CUDA C++,
csrc/flash_attention_kernel.cu).

Replaces seld_tpu/ops/flash_attention.py::flash_attention. Exact softmax
attention of (B, H, T, Dh) q, k, v that never writes the (T x T) scores to
device memory: the forward kernel streams K/V tiles through an online
softmax and returns `out` and the per-row logsumexp `lse` (B*H, T); the
backward is two more kernels, dQ (streams K/V) and dK/dV (one block per
128 keys, streams Q/dO). In bf16 the dQ kernel also forms
`delta = rowsum(dO * out)` of its rows and writes it for dK/dV, so a
backward is exactly those two launches; in float32 `delta` is
`row_delta`'s torch ops.

In bf16 all three kernels are wgmma products on tiles that TMA stages in
shared memory, and read q, k, v (and dO) through tensor maps that the C
launchers encode from the strides (`tma_geometry` is the plain version of
that encoding). The forward block owns
`fwd_block_rows` queries, 64 per warpgroup, and streams K/V tiles of
`FWD_BOX_KEYS` keys; each warpgroup issues the next tile's scores before
this tile's value product and runs the exponentials of the online softmax
while that product runs, and it writes out through shared memory and a
TMA store. In float32 the kernels are plain FMA (TF32 cannot hold 2e-5).
The kernels are operations-bound; see the source's note.

Layout: the kernels read q, k, v and dO through their batch / head / time
strides (last dim contiguous, every stride and the base a multiple of 16
bytes), so the transposed (B, T, H, Dh) view that the model's projections
produce is read in place, with no copy. A tensor that does not meet that
(an expanded cotangent, a sliced last dim) is made contiguous first: one
copy, counted in `flash_attention.copies`. `out`, dq, dk and dv are
allocated as (B, T, H, Dh) and returned transposed, so the model's
`transpose(1, 2).reshape(b, t, d)` after attention is a view.

`flash_attention` launches the kernels for CUDA tensors; for CPU tensors,
and only for those, it runs `flash_attention_reference`, the same function
in plain PyTorch ops with the forward's rounding points, differentiable by
autograd.

The ring modes (`forward_step`, `dq_step`, `dkv_step`): each kernel can
fold its result into a float32 running state in its epilogue, for the
ring attention K5 (ops/ring_attention.py, which holds their plain
versions). `read` folds into the state an earlier step wrote; `final`
stores the result in the inputs' dtype, otherwise the float32 state.
read=False, final=True is K3 itself (`launch_forward`, `launch_dq`,
`launch_dkv`).
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch
from torch import compiler

from seld_tpu_torch.ops.counters import bump

MAX_HEAD_DIM = 128  # the kernels are instantiated for multiples of 16 up to here
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_BOX_COLS = 64  # one 128-byte swizzled row of bf16


def fwd_block_rows(dh: int) -> int:
    """Queries a bf16 forward block owns, loaded as one TMA box of q per
    64 columns: 64 per consumer warpgroup, four warpgroups up to Dh = 64
    and two above (the accumulator of a 128-column head takes the
    registers)."""
    return 256 if dh <= 64 else 128


FWD_BOX_KEYS = 64  # keys of a streamed K/V tile in the bf16 forward


def bwd_box_rows(dh: int) -> int:
    """Rows of a streamed tile in the bf16 backward: 64, or 32 above Dh = 64
    (the accumulators of a 128-column head take the registers)."""
    return 64 if dh <= 64 else 32


def tma_geometry(x: torch.Tensor, box_rows: int) -> tuple[int, ...]:
    """The TMA tensor map of a (B, H, T, Dh) view, the plain version of
    what the bf16 launchers encode in C from its strides: dims innermost
    first (Dh, T, H, B), the byte strides of T, H and B, and the box (64
    columns, box_rows rows; one head and one batch). Columns beyond Dh and
    rows beyond T in a box read as zeros. A dim of size 1 may have stride 0
    in PyTorch; TMA takes strides that are positive multiples of 16 bytes,
    and the stride of a dim of size 1 is never used, so it becomes 16."""
    b, h, t, dh = x.shape
    e = x.element_size()
    sb, sh, st = x.stride()[:3]
    return (dh, t, h, b, st * e if st or t > 1 else 16, sh * e if sh or h > 1 else 16,
            sb * e if sb or b > 1 else 16, TMA_BOX_COLS, box_rows)


class _RoundCotangent(torch.autograd.Function):
    """Identity whose cotangent is rounded to `dtype` on the way back: the
    place where K3's backward rounds ds before its two products."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float | None = None):
    """The plain version of K3: (out (B, H, T, Dh) in q's dtype,
    lse (B*H, T) float32).

    Scores, softmax and the value product's accumulation in float32; the
    unnormalised probabilities are rounded to v's dtype before the value
    product and the sum is divided by the float32 normaliser after it, as
    in the kernel. The backward is autograd's, with the cotangent of the
    unscaled scores (the kernel's ds) rounded to the inputs' dtype before
    the two products that consume it, as the kernel rounds it. In bf16 the
    kernel is the closer of the two to float32 in dv: it carries p into
    that product as a bf16 pair, where autograd reuses the rounded p."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, lse = attention_f32_reference(q, k, v, scale)
    return out.to(q.dtype), lse


def attention_f32_reference(q, k, v, scale: float):
    """flash_attention_reference before its last rounding: out in float32
    (what the forward kernel holds in registers before its epilogue), and
    lse."""
    b, h, t, _ = q.shape
    s = _RoundCotangent.apply(torch.matmul(q.float(), k.float().transpose(-1, -2)), q.dtype)
    s = s * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    return out, (m + torch.log(denom)).reshape(b * h, t)


def chunk_grads_reference(q, k, v, g, lse, delta, scale: float):
    """The plain per-chunk FA-2 backward with a given lse and delta: (dq,
    dk, dv) in q's dtype, the CPU counterpart of `launch_dq(...,
    delta=delta)` followed by `launch_dkv`.

    q, g: (B, H, Tq, Dh) query rows and their output cotangent; k, v: (B,
    H, Tk, Dh) a chunk of keys and values; lse (B*H, Tq) the logsumexp of
    ALL keys' scaled scores (the ring's global merge) and delta (B*H, Tq)
    or (B, H, Tq) = rowsum(g * out) of the final out, both float32. Then
    p = exp(s - lse) is this chunk's slice of the global softmax and every
    result is this chunk's exact share of the global gradient sums. In
    float32, with ds rounded to the inputs' dtype before its two products,
    as the kernels round it."""
    dq, dk, dv = chunk_partials_reference(q, k, v, g, lse, delta, scale)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def chunk_partials_reference(q, k, v, g, lse, delta, scale: float, dq: bool = True,
                             dkv: bool = True):
    """chunk_grads_reference before its last rounding: the float32 (dq,
    dk, dv) that the backward kernels hold in registers before their
    epilogues (None for what is not asked for)."""
    b, h, tq, _ = q.shape
    lse = lse.reshape(b, h, tq, 1)
    delta = delta.reshape(b, h, tq, 1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse)
    gf = g.float()
    ds = (p * (torch.matmul(gf, v.float().transpose(-1, -2)) - delta)).to(q.dtype).float()
    dq_p = torch.matmul(ds, k.float()) * scale if dq else None
    if not dkv:
        return dq_p, None, None
    dk_p = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq_p, dk_p, torch.matmul(p.transpose(-1, -2), gf)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"K3 takes float32 or bfloat16 q, k, v, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K3 takes q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"K3 takes q, k, v of one (B, H, T, Dh) shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    dh = q.shape[-1]
    if dh % 16 or not 16 <= dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"K3 takes a head width that is a multiple of 16 up to {MAX_HEAD_DIM}, got {dh}"
        )


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels address it: unit last stride, batch / head / time
    strides and the base pointer multiples of 16 bytes, no stride 0 on a
    dim longer than 1 (TMA maps no broadcast). Anything else is copied to a
    contiguous tensor (counted)."""
    per16 = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % per16 == 0 and (s or n == 1)
                    for s, n in zip(x.stride()[:-1], x.shape[:-1]))):
        return x
    bump(flash_attention, "copies")
    return x.contiguous()


def _empty_bthd(like: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """An uninitialised (B, H, T, Dh) tensor stored as (B, T, H, Dh)."""
    b, h, t, dh = like.shape
    return torch.empty((b, t, h, dh), dtype=dtype or like.dtype,
                       device=like.device).transpose(1, 2)


@functools.cache
def _packer(n: int):
    return struct.Struct(f"{n}q").pack


_NO_STRIDES = (0, 0, 0)


def _strides(*tensors) -> bytes:
    """The (batch, head, time) element strides of each tensor (zeros for
    None), packed as the C long long array the launchers read: a bytes
    object crosses ctypes as a pointer to its buffer, cheaper than a ctypes
    array built per launch."""
    values = [s for x in tensors for s in (x.stride()[:3] if x is not None else _NO_STRIDES)]
    return _packer(len(values))(*values)


@functools.cache
def _kernels():
    from seld_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention_kernel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i, i, i, i, f, i, p]  # B, H, T, Dh, scale, dtype, stream
    # pointers, strides (packed bytes), [delta_given], read, final, tail
    lib.seld_flash_attention_fwd.argtypes = [p] * 6 + [p, i, i] + tail
    lib.seld_flash_attention_bwd_dq.argtypes = [p] * 9 + [p, i, i, i] + tail
    lib.seld_flash_attention_bwd_dkv.argtypes = [p] * 10 + [p, i, i] + tail
    lib.seld_flash_attention_tma_geometry.argtypes = [i, p, i, i, i, i,
                                                      ctypes.POINTER(ctypes.c_longlong)]
    fns = (lib.seld_flash_attention_fwd, lib.seld_flash_attention_bwd_dq,
           lib.seld_flash_attention_bwd_dkv, lib.seld_flash_attention_tma_geometry)
    for fn in fns:
        fn.restype = ctypes.c_int
    return fns


def _launch(which: int, name: str, tensors, strided, flags, scale: float) -> None:
    """One kernel launch on the current stream of the first tensor's device;
    `tensors` may hold None (a buffer the launch's mode does not use),
    `flags` go between the strides and the shape."""
    q = tensors[0]
    index = q.device.index
    args = ([x.data_ptr() if x is not None else None for x in tensors] + [_strides(*strided)]
            + [*flags, *q.shape, scale, _DTYPES[q.dtype]])
    if torch.cuda.current_device() == index:
        rc = _kernels()[which](*args, torch._C._cuda_getCurrentRawStream(index))
    else:  # the launchers run on the calling thread's current device
        with torch.cuda.device(index):
            rc = _kernels()[which](*args, torch._C._cuda_getCurrentRawStream(index))
    if rc == -1:
        raise RuntimeError(f"K3 {name}: libcuda refused a TMA tensor map of "
                           f"{[tuple(x.stride()) for x in strided[:4]]}")
    if rc != 0:
        raise RuntimeError(f"K3 {name} launch failed with CUDA error {rc}")


def tensor_map_geometry(which: int, q, k, v, x) -> list[int]:
    """The nine values of each tensor map that a bf16 launch of `which` (0
    forward with x = out, 1 dQ and 2 dK/dV with x = dO) encodes in C: what
    `tma_geometry` gives for the same tensors and box rows."""
    found = (ctypes.c_longlong * 36)()
    rc = _kernels()[3](which, _strides(q, k, v, x), *q.shape, found)
    if rc != 0:
        raise ValueError(f"K3 takes no head width {q.shape[-1]}")
    return list(found)


def forward_step(q, k, v, scale: float, out, lse, run, read: bool, final: bool) -> None:
    """The forward kernel on kernel-ready CUDA tensors in a ring mode,
    writing into the given buffers: this chunk's normalised float32 result
    folded into the running (run, lse) with `read` (lse is read and written
    in place), then stored to out in q's dtype (`final`) or to run in
    float32. run: float32, out's shape (out itself in float32); None where
    read=False and final=True, which is K3's own forward."""
    if q.numel():
        _launch(0, "forward", (q, k, v, out, lse, run), (q, k, v, out, run),
                (int(read), int(final)), scale)
        bump(flash_attention, "fwd_launches")


def dq_step(q, k, v, g, out, lse, scale: float, delta, dq, run, read: bool, final: bool):
    """The dQ kernel on kernel-ready CUDA tensors in a ring mode: this
    chunk's float32 dq added to the running float32 `run` (read), stored
    to dq in q's dtype (final) or to run. Returns delta: without one the
    bf16 kernel forms rowsum(g * out) and writes it (in float32 it is
    `row_delta`); with one the kernel reads it."""
    b, h, t, _ = q.shape
    given = delta is not None
    if not given:
        if q.dtype == torch.bfloat16:
            delta = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
        else:
            delta = row_delta(g, out).view(b * h, t)
    if q.numel():
        _launch(1, "dQ", (q, k, v, g, out, lse, delta, dq, run), (q, k, v, g, out, dq, run),
                (int(given or q.dtype != torch.bfloat16), int(read), int(final)), scale)
        bump(flash_attention, "bwd_dq_launches")
    return delta


def dkv_step(q, k, v, g, lse, delta, scale: float, dk, dv, dk_run, dv_run, read: bool,
             final: bool) -> None:
    """The dK/dV kernel on kernel-ready CUDA tensors in a ring mode: this
    chunk's float32 dk and dv added to the running float32 sums (read),
    stored to dk, dv in q's dtype (final) or to the sums."""
    if q.numel():
        _launch(2, "dK/dV", (q, k, v, g, lse, delta, dk, dv, dk_run, dv_run),
                (q, k, v, g, dk, dv, dk_run, dv_run), (int(read), int(final)), scale)
        bump(flash_attention, "bwd_dkv_launches")


def launch_forward(q, k, v, scale: float):
    """The forward kernel on kernel-ready CUDA tensors -> (out, lse)."""
    b, h, t, _ = q.shape
    out = _empty_bthd(q)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    forward_step(q, k, v, scale, out, lse, None, False, True)
    return out, lse


def launch_dq(q, k, v, g, out, lse, scale: float, delta=None):
    """The dQ kernel on kernel-ready CUDA tensors -> (dq, delta).

    delta = rowsum(g * out) of each row, float32 (B*H, T). Without `delta`
    the bf16 kernel forms it from g and `out` and writes it beside dq (in
    float32 it is `row_delta`); with it the kernel reads it."""
    dq = _empty_bthd(q)
    return dq, dq_step(q, k, v, g, out, lse, scale, delta, dq, None, False, True)


def launch_dkv(q, k, v, g, lse, delta, scale: float):
    """The dK/dV kernel on kernel-ready CUDA tensors -> (dk, dv); delta as
    launch_dq returns it."""
    dk, dv = _empty_bthd(q), _empty_bthd(q)
    dkv_step(q, k, v, g, lse, delta, scale, dk, dv, None, None, False, True)
    return dk, dv


def row_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) in float32, (B, H, T) contiguous: the plain
    version of what the bf16 dQ kernel forms."""
    return (g.float() * out.float()).sum(dim=-1).contiguous()


class _FlashAttention(torch.autograd.Function):
    """K3 on CUDA tensors: one kernel launch forward, two backward (dQ,
    which forms delta in bf16, then dK/dV). When dq is not needed the dQ
    pass is skipped and delta is `row_delta`'s; when neither dk nor dv is,
    dK/dV is. No atomics: the same inputs give the same bits."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.set_materialize_grads(False)
        q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
        out, lse = launch_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        need_dq, need_dk, need_dv = ctx.needs_input_grad[:3]
        if g is None or not (need_dq or need_dk or need_dv):
            return None, None, None, None
        g = _kernel_ready(g.to(q.dtype))
        dq = dk = dv = None
        if need_dq:
            dq, delta = launch_dq(q, k, v, g, out, lse, ctx.scale)
        else:
            delta = row_delta(g, out)
        if need_dk or need_dv:
            dk, dv = launch_dkv(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk if need_dk else None, dv if need_dv else None, None


@torch.library.custom_op("seld_tpu_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's forward as an operator, (out, lse), that torch.export records
    by name, so that an exported program (seld_tpu_torch.export) launches
    the kernel where it runs. `flash_attention` calls it only while
    exporting: an operator call costs host time that the eager path does
    not pay. CUDA tensors launch the forward kernel (adding one to
    `flash_attention.fwd_launches`, from a loaded program too); CPU tensors
    run `flash_attention_reference`; there is no other device. out is
    (B, H, T, Dh) stored as (B, T, H, Dh) on both. Inference only: no
    backward is registered, and the ring modes are not exposed."""
    out, lse = flash_attention_reference(q, k, v, scale)
    return _empty_bthd(q).copy_(out), lse


@flash_attention_fwd.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, scale):
    return launch_forward(_kernel_ready(q), _kernel_ready(k), _kernel_ready(v), scale)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, scale):
    b, h, t, _ = q.shape
    return _empty_bthd(q), q.new_empty((b * h, t), dtype=torch.float32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, return_lse: bool = False):
    """Exact softmax attention of (B, H, T, Dh) q, k, v in float32 or
    bfloat16, Dh a multiple of 16 up to 128, differentiable in all three;
    `out` in the inputs' dtype, and with return_lse the (B*H, T) float32
    logsumexp of the scaled scores beside it.

    CUDA tensors go through kernel K3 (a forward launch adds one to
    `flash_attention.fwd_launches`, the backward one each to
    `.bwd_dq_launches` and `.bwd_dkv_launches`); CPU tensors go through
    `flash_attention_reference`. Anything else raises. While torch.export
    traces, the forward is the operator `flash_attention_fwd`."""
    _check(q, k, v)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if compiler.is_exporting():
        out, lse = flash_attention_fwd(q, k, v, scale)
    elif q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, scale)
    elif q.device.type == "cuda":
        out, lse = _FlashAttention.apply(q, k, v, scale)
    else:
        raise ValueError(f"K3 runs on CUDA or CPU tensors, got {q.device}")
    return (out, lse) if return_lse else out


flash_attention.fwd_launches = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0
flash_attention.copies = 0
