"""Building blocks of the grid backbones (counterpart:
seld_tpu/models/layers.py).

Dtype policy, as in the JAX package: parameters are in the model's
param_dtype (float32, or bfloat16 built by models.registry), BatchNorm's
running statistics always float32; convolutions and linears cast their
input and weights to the compute dtype (a no-op for bf16 weights in bf16,
an exact upcast of bf16 weights to float32, as flax promotes); BatchNorm
and LayerNorm compute in float32 against float32 weights (a bf16 scale and
bias upcast exactly, as flax's normalisation promotes them) and float32
statistics and return their `norm_dtype` (float32 by default), and the
caller casts back to the compute dtype where the JAX module does. With norm_dtype
bfloat16 a norm reads a bf16 input as it is and writes bf16, as flax's
`_normalize` does (float32 arithmetic inside, the result cast): no float32
copy of the activation is written. Spatial tensors are NCHW, sequence
tensors (B, T, D).

Train mode (`module.train()`): BatchNorm normalises by the batch's
statistics and updates its running ones; Dropout draws its keep-mask from
an explicit torch.Generator (DropoutSeeding.seed_dropout), never from the
global one. Eval mode uses the running statistics and no dropout.

Under a process mesh (parallel.sequence.attention_mesh) the layers compute
what one device computes on the global batch: a train-mode BatchNorm
takes its statistics over every rank's rows (and time chunks); with the
time axis split over the model axis (sequence parallelism) a convolution
that spans time (3x3, the depthwise kernel 31) pads its chunk with its
neighbours' edge rows (halo_exchange, zeros at the window's ends) instead
of zeros; Dropout draws its mask at the global shape and keeps this rank's
block, so the sharded step's masks are the one-device step's.

`run_block` is activation checkpointing (the JAX package's nn.remat): the
block's activations are recomputed in the backward, with the block's
dropout masks replayed and its BatchNorm statistics updated once.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from seld_tpu_torch import quant
from seld_tpu_torch.ops.attention import multi_head_attention
from seld_tpu_torch.parallel.sequence import (
    all_reduce_sum,
    current_mesh,
    halo_exchange,
    time_mesh,
    world_mesh,
)

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # running = 0.9 * running + 0.1 * batch (flax momentum 0.9)
LN_EPS = 1e-5


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Linear(nn.Linear):
    """nn.Linear whose product runs in `compute_dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quant.layer_forward(self, x)  # int8 or fake-quant inside their contexts
        if y is not None:
            return y
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)

    def product(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """x @ weight.T in the compute dtype, without the bias."""
        dt = self.compute_dtype
        return F.linear(x.to(dt), weight.to(dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d (no bias unless asked) whose convolution runs in
    `compute_dtype`.

    On the CPU a bf16 convolution takes its bf16-rounded operands in
    float32 and rounds the result to bf16: the CPU build's oneDNN bf16
    kernel returns NaN for strided convolutions over width-1 images (the
    CSPDarkNet's per-frame (F, 1) images; torch 2.13)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride=1, padding: int = 0,
                 compute_dtype: torch.dtype = torch.float32, bias: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quant.layer_forward(self, x)  # int8 or fake-quant inside their contexts
        if y is not None:
            return y
        return self.product(x, self.weight, self.bias)

    def product(self, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        """The convolution of x with `weight` (and `bias`) in the compute
        dtype."""
        dt = self.compute_dtype
        x, weight = x.to(dt), weight.to(dt)
        bias = None if bias is None else bias.to(dt)
        padding = self.padding
        mesh = time_mesh()
        if mesh is not None and padding[0]:  # (B, C, T, F): time from the neighbours
            x = halo_exchange(x, 2, padding[0], 0.0, mesh)
            padding = (0, padding[1])
        if x.device.type == "cpu" and dt == torch.bfloat16:
            bias = None if bias is None else bias.float()
            return F.conv2d(x.float(), weight.float(), bias, self.stride,
                            padding).to(dt)
        return F.conv2d(x, weight, bias, self.stride, padding)


class DepthwiseConv1d(nn.Conv1d):
    """Depthwise 'same' conv over time on (B, D, T), in `compute_dtype`."""

    def __init__(self, channels: int, kernel_size: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, kernel_size,
                         padding=kernel_size // 2, groups=channels)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, padding = x.to(dt), self.padding
        mesh = time_mesh()
        if mesh is not None:  # (B, D, T): time from the neighbours
            x = halo_exchange(x, 2, padding[0], 0.0, mesh)
            padding = 0
        return F.conv1d(x, self.weight.to(dt), self.bias.to(dt), padding=padding,
                        groups=self.groups)


def _norm_input(x: torch.Tensor, norm_dtype: torch.dtype) -> torch.Tensor:
    """A float32 norm reads its input as float32; a bf16 norm reads it as it
    comes (float32 or bf16: the kernels compute in float32 either way)."""
    return x.float() if norm_dtype == torch.float32 else x


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, computed in float32, returning
    `norm_dtype`.

    F.layer_norm takes its weights in the input's dtype: bf16 parameters
    are upcast exactly for a float32 input. A bf16 norm hands F.layer_norm
    its weights cast to bf16: CUDA's
    layer_norm raises for a bf16 input with float32 weights (torch 2.11 on
    the H100), and one code path serves both devices. The statistics, the
    normalisation and the affine still run in float32 inside the kernel;
    only the scale and bias are rounded to bf16 first, which moves a
    result by at most about one bf16 rounding more than flax's."""

    def __init__(self, dim: int, norm_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=LN_EPS)
        self.norm_dtype = norm_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_input(x, self.norm_dtype)
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps).to(self.norm_dtype)


class Dropout(nn.Module):
    """Inverted dropout whose keep-mask comes from `generator`, a
    torch.Generator on the input's device that the owner of the model sets
    and seeds. Identity in eval mode and at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "train-mode dropout needs a generator: call the model's "
                "seed_dropout(seed) first"
            )
        keep = _global_mask(x, 1.0 - self.p, self.generator)
        return x / (1.0 - self.p) * keep


def _global_mask(x: torch.Tensor, p_keep: float, generator: torch.Generator) -> torch.Tensor:
    """A Bernoulli(p_keep) mask for x. Under a mesh x (B, T, ...) is this
    rank's block of the global batch: the mask is drawn at the global shape,
    as the one-device step draws it, and this rank's rows (and time chunk)
    are kept."""
    mesh, time_sharded = current_mesh()
    if mesh is None or mesh.world_size == 1:
        return torch.empty_like(x).bernoulli_(p_keep, generator=generator)
    b, t = x.shape[0], x.shape[1]
    n_t = mesh.n_model if time_sharded else 1
    full = torch.empty((b * mesh.n_data, t * n_t, *x.shape[2:]), dtype=x.dtype,
                       device=x.device).bernoulli_(p_keep, generator=generator)
    t0 = mesh.model_rank * t if time_sharded else 0
    return full[mesh.data_rank * b:(mesh.data_rank + 1) * b, t0:t0 + t]


class BatchNorm(nn.Module):
    """BatchNorm over axis 1, computed in float32 against float32 weights
    (bf16 parameters are upcast for the call) and statistics, returning
    `norm_dtype` (F.batch_norm takes a bf16
    input with float32 weights and statistics on the CPU and on CUDA, and
    writes bf16). In train mode it normalises by the batch's mean and
    biased variance and moves the float32 running statistics toward them by
    BN_MOMENTUM. The running variance takes the biased batch variance, as
    flax stores it; F.batch_norm gives the unbiased one, which is rescaled
    here. `update_stats = False` keeps the running statistics as they are
    (run_block's recompute)."""

    def __init__(self, channels: int, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_dtype = norm_dtype
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_input(x, self.norm_dtype)
        # float32 weights whatever the parameter dtype, so that F.batch_norm
        # takes the same path for bf16 parameters (.float() is the identity
        # on float32 ones)
        weight, bias = self.weight.float(), self.bias.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, weight,
                                bias, training=False, eps=BN_EPS).to(self.norm_dtype)
        if world_mesh() is not None:
            return self._global_batch_norm(x, world_mesh(), weight, bias)
        # F.batch_norm writes momentum * (batch mean, unbiased batch variance)
        # into zeroed buffers (autograd saves them, so the module's own
        # statistics are updated apart); unbiased -> biased is (n - 1) / n
        n = x.numel() // x.shape[1]
        mean_step, var_step = torch.zeros((2, x.shape[1]), device=x.device).unbind(0)
        out = F.batch_norm(x, mean_step, var_step, weight, bias,
                           training=True, momentum=BN_MOMENTUM, eps=BN_EPS)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean_step)
                self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var_step, alpha=(n - 1) / n)
        return out.to(self.norm_dtype)

    def _global_batch_norm(self, x: torch.Tensor, mesh, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
        """Train mode over every rank's rows: the mean, then the biased
        variance as the mean squared deviation from it (two passes, as
        F.batch_norm computes it on one device), each a sum all-reduced over
        the world and differentiable through it; every rank then moves the
        same running statistics."""
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        count = float(x.numel() // x.shape[1] * mesh.world_size)
        mean = all_reduce_sum(xf.sum(dim=dims)) / count
        centred = xf - mean.view(shape)
        var = all_reduce_sum(centred.square().sum(dim=dims)) / count
        out = centred * torch.rsqrt(var + BN_EPS).view(shape) * weight.view(shape) \
            + bias.view(shape)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
                self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        return out.to(self.norm_dtype)


class DropoutSeeding:
    """Mixin of the backbones: one torch.Generator that every Dropout of
    the model draws from."""

    _dropout_generator: torch.Generator | None = None

    def seed_dropout(self, seed: int) -> None:
        """Seed the generator that every Dropout of the model draws from
        (made on first use, on the parameters' device). The train step
        reseeds it each step from (seed, epoch, step), so a resumed run
        repeats the masks of the run it resumes."""
        if self._dropout_generator is None:
            self._dropout_generator = torch.Generator(
                device=next(self.parameters()).device)
            for module in self.modules():
                if isinstance(module, Dropout):
                    module.generator = self._dropout_generator
        self._dropout_generator.manual_seed(seed)


@contextlib.contextmanager
def _replaying(block: nn.Module, generator: torch.Generator | None, start):
    """Inside: the block's dropout generator back at `start` and its
    BatchNorm statistics held; after: both as they were."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    now = None if generator is None else generator.get_state()
    if generator is not None:
        generator.set_state(start)
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True
        if generator is not None:
            generator.set_state(now)


def run_block(block: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """block(x); with `remat` and autograd recording, the block's
    activations are not kept but recomputed in the backward
    (torch.utils.checkpoint, non-reentrant).

    The recompute must compute what the forward did. The block's Dropouts
    draw from the model's own generator, whose state checkpoint's
    preserve_rng_state does not restore: the generator is set back to its
    state before the forward for the recompute, and forward again after
    it. A train-mode BatchNorm would update its running statistics a second
    time: the recompute holds them. Under quant.qat() the recompute
    fake-quantizes as the forward did (a ContextVar, which the autograd
    thread that runs the backward does not see). Every kernel of the block
    (K3's forward included) launches again in the recompute."""
    if not (remat and torch.is_grad_enabled()):
        return block(x)
    generator = next((m.generator for m in block.modules()
                      if isinstance(m, Dropout) and m.generator is not None), None)
    start = None if generator is None else generator.get_state()
    fake_quant = quant.qat_enabled()  # the backward may run on another thread
    calls = []

    def run(x):
        if not calls:  # the forward
            calls.append(1)
            return block(x)
        with _replaying(block, generator, start), quant.qat(fake_quant):  # the recompute
            return block(x)

    return checkpoint(run, x, use_reentrant=False)


class ConvBlock(nn.Module):
    """Conv 3x3 (no bias) -> BatchNorm -> ReLU, then a (1, 2) max-pool on
    (T, F) that halves frequency and keeps time."""

    def __init__(self, in_channels: int, out_channels: int, pool: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.pool = pool
        self.conv = Conv2d(in_channels, out_channels, 3, padding=1,
                           compute_dtype=compute_dtype)
        self.bn = BatchNorm(out_channels, norm_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn(self.conv(x))).to(self.compute_dtype)
        return F.max_pool2d(x, (1, 2)) if self.pool else x


class CNNEncoder(nn.Module):
    """ConvBlocks over (B, C, T, F), the first four pooling frequency by 2,
    then the channel-major flatten to (B, T, C' * F') of the JAX encoder
    (seld_tpu/models/layers.py:99). Shared by the CRNN and the Conformer."""

    def __init__(self, in_channels: int, channels=(64, 128, 256, 512), n_mels: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = (in_channels, *channels)
        self.blocks = nn.ModuleList(
            ConvBlock(chans[i], chans[i + 1], i < 4, compute_dtype, norm_dtype)
            for i in range(len(channels))
        )
        f_out = n_mels
        for _ in range(min(len(channels), 4)):
            f_out //= 2
        self.out_features = channels[-1] * f_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        b, c, t, f = x.shape
        return x.permute(0, 2, 1, 3).reshape(b, t, c * f)


class FeedForward(nn.Module):
    """Half-step Swish FFN with its residual: x + 0.5 * FFN(LN(x))."""

    def __init__(self, d_model: int, d_ff: int,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = LayerNorm(d_model, norm_dtype)
        self.fc1 = Linear(d_model, d_ff, compute_dtype=compute_dtype)
        self.fc2 = Linear(d_ff, d_model, compute_dtype=compute_dtype)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(x).to(self.compute_dtype)
        y = self.drop1(swish(self.fc1(y)))
        return x + 0.5 * self.drop2(self.fc2(y))


class MultiHeadSelfAttention(nn.Module):
    """Pre-norm multi-head self-attention with its residual."""

    def __init__(self, d_model: int, n_heads: int,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not divisible by {n_heads} heads")
        self.compute_dtype = compute_dtype
        self.n_heads = n_heads
        self.norm = LayerNorm(d_model, norm_dtype)
        self.w_q = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.w_k = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.w_v = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.w_o = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        y = self.norm(x).to(self.compute_dtype)

        def heads(proj):
            return proj(y).view(b, t, self.n_heads, d // self.n_heads).transpose(1, 2)

        out = multi_head_attention(heads(self.w_q), heads(self.w_k), heads(self.w_v))
        return x + self.drop(self.w_o(out.transpose(1, 2).reshape(b, t, d)))


class ConformerConvModule(nn.Module):
    """LN -> pointwise (2x) + GLU -> depthwise conv -> BN -> Swish ->
    pointwise, with its residual."""

    def __init__(self, d_model: int, kernel_size: int = 31,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = LayerNorm(d_model, norm_dtype)
        self.pw1 = Linear(d_model, 2 * d_model, compute_dtype=compute_dtype)
        self.depthwise = DepthwiseConv1d(d_model, kernel_size, compute_dtype=compute_dtype)
        self.bn = BatchNorm(d_model, norm_dtype)
        self.pw2 = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw1(self.norm(x).to(self.compute_dtype))
        a, gate = y.chunk(2, dim=-1)
        y = self.depthwise((a * torch.sigmoid(gate)).transpose(1, 2))  # (B, D, T)
        y = swish(self.bn(y)).to(self.compute_dtype)
        return x + self.drop(self.pw2(y.transpose(1, 2)))


class ConformerBlock(nn.Module):
    """ff1 -> MHSA -> conv module -> ff2 -> final LayerNorm."""

    def __init__(self, d_model: int, n_heads: int = 4, d_ff: int | None = None,
                 kernel_size: int = 31,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.compute_dtype = compute_dtype
        self.ff1 = FeedForward(d_model, d_ff, compute_dtype, dropout, norm_dtype)
        self.attn = MultiHeadSelfAttention(d_model, n_heads, compute_dtype, dropout,
                                           norm_dtype)
        self.conv = ConformerConvModule(d_model, kernel_size, compute_dtype, dropout,
                                        norm_dtype)
        self.ff2 = FeedForward(d_model, d_ff, compute_dtype, dropout, norm_dtype)
        self.norm = LayerNorm(d_model, norm_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ff2(self.conv(self.attn(self.ff1(x))))
        return self.norm(x).to(self.compute_dtype)


class GridHead(nn.Module):
    """Linear -> LayerNorm -> ReLU -> Dropout -> Linear to class-major (B, T, M, G)
    float32 logits. `logits` holds the JAX (hidden, M, G) kernel as an
    (M*G, hidden) weight."""

    def __init__(self, in_features: int, hidden: int, grid_cells: int,
                 num_classes: int, compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.3, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        self.grid_cells = grid_cells
        self.fc = Linear(in_features, hidden, compute_dtype=compute_dtype)
        self.norm = LayerNorm(hidden, norm_dtype)
        self.logits = Linear(hidden, num_classes * grid_cells, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm(self.fc(x))).to(self.compute_dtype)
        y = self.logits(self.drop(y))
        return y.view(*y.shape[:-1], self.num_classes, self.grid_cells).float()
