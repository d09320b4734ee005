"""int8 quantization for serving, and quantization-aware training
(counterpart: seld_tpu/quant.py).

Post-training quantization (PTQ), as in the JAX package:

  * weights: symmetric int8 per output channel (absmax / 127), quantized
    once from the trained weights (`build_quant_tree`);
  * activations: one symmetric int8 scale per tensor, the absmax of the
    layer's input over calibration batches / 127
    (`calibrate_activation_scales`, forward pre-hooks in eval mode);
  * products: int8 x int8 -> int32 through `int8_matmul` (cuBLASLt's
    s8 x s8 -> s32 GEMM, `torch._int_mm`, where the JAX package takes XLA's
    int8 dot and convolution), dequantized as y * (s_x * s_w) + bias in
    float32 and cast to the layer's compute dtype. A convolution is an
    explicit im2col of the quantized input into an int8 patch matrix
    (B * Ho * Wo, Cin * kh * kw), its columns in the port weight's
    (Cin, kh, kw) order, then the same product.

Weight-only mode keeps int8 weights (smaller artifacts) and dequantizes
them to the compute dtype for the layer's own float op.

The eligible layers are the JAX package's: every port `Conv2d` (2-D,
ungrouped, undilated: the ResNet50, CNN-encoder and CSPDarkNet trunks) and
every port `Linear` (dense layers and the grid head). Depthwise
convolutions, the GRU, the norms and attention's own products stay in the
compute dtype. The set is read from seld_tpu_torch.convert's layer lists:
kinds "conv", "conv_bias", "dense" and "logits", so that the port's set and
the JAX tree's keys are one map.

The swap rewrites nothing: `Linear.forward` and `Conv2d.forward` ask
`layer_forward` first, which answers inside `quantized(model, tree)` (the
layers of the tree run int8) or `qat()` (every eligible layer
fake-quantizes), two ContextVars, so checkpoints, state_dicts and the float
path stay as they are and torch.export traces the int8 path.
`QuantizedModel` holds a model and its tree as buffers: what the
predictor, evaluation and the exported programs call.

Symmetric quantization keeps zero exact: zero padding and zero-padded
windows behave as in the float path, and each row of a batch depends on
that row alone (the scales are static), so streamed and served int8 grids
equal the offline ones.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from seld_tpu_torch.ops.counters import bump

QMAX = 127.0
ELIGIBLE_KINDS = ("conv", "conv_bias", "dense", "logits")

_TABLE = contextvars.ContextVar("seld_tpu_torch_quant_table", default=None)
_QAT = contextvars.ContextVar("seld_tpu_torch_qat", default=False)


# -- the eligible layers ------------------------------------------------------


def eligible(module: nn.Module) -> bool:
    """A port Conv2d that is 2-D, ungrouped and undilated, or a port Linear."""
    from seld_tpu_torch.models.layers import Conv2d, Linear

    if isinstance(module, Conv2d):
        return module.groups == 1 and tuple(module.dilation) == (1, 1)
    return isinstance(module, Linear)


def eligible_names(model_cfg) -> list[str]:
    """The port module names of model_cfg's eligible layers, in model order,
    from seld_tpu_torch.convert's layer list."""
    from seld_tpu_torch.convert import _LAYERS

    if model_cfg.model_type not in _LAYERS:
        raise NotImplementedError(f"no layer list for model_type {model_cfg.model_type!r}")
    return [port for _, port, kind in _LAYERS[model_cfg.model_type](model_cfg)
            if kind in ELIGIBLE_KINDS]


def eligible_layers(model: nn.Module) -> dict[str, nn.Module]:
    """{name: module} of the eligible layers of a model from
    models.build_model (which records its ModelConfig as `model_cfg`)."""
    cfg = getattr(model, "model_cfg", None)
    if cfg is None:
        raise ValueError("quantization reads the model's layer list from its ModelConfig: "
                         "build the model with seld_tpu_torch.models.build_model")
    layers = {}
    for name in eligible_names(cfg):
        module = model.get_submodule(name)
        if not eligible(module):
            raise TypeError(f"{name} is a {type(module).__name__}, not an eligible layer")
        layers[name] = module
    return layers


# -- calibration and weight quantization --------------------------------------


@torch.no_grad()
def calibrate_activation_scales(model: nn.Module, batches) -> dict[str, float]:
    """Run `batches` (model inputs, e.g. (B, T, C, F) features, numpy or
    torch) through the model in eval mode and return {name: s_x} with s_x =
    absmax(the layer's input as it is passed) / 127 over every batch (1.0
    where the absmax is 0). Raises ValueError on no batches."""
    layers = eligible_layers(model)
    absmax: dict[str, torch.Tensor] = {}

    def recorder(name):
        def pre_hook(_module, args):
            a = args[0].detach().abs().amax().float()
            absmax[name] = a if name not in absmax else torch.maximum(absmax[name], a)
        return pre_hook

    handles = [m.register_forward_pre_hook(recorder(n)) for n, m in layers.items()]
    was_training = model.training
    device = next(model.parameters()).device
    n = 0
    try:
        model.eval()
        for batch in batches:
            model(torch.as_tensor(np.asarray(batch, np.float32) if not torch.is_tensor(batch)
                                  else batch).to(device, torch.float32))
            n += 1
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if n == 0:
        raise ValueError("calibration requires at least one batch")
    # as the JAX package: the float32 absmax read as a Python float, / 127 in
    # float64, stored as float32 by build_quant_tree
    found = {name: float(absmax[name]) for name in layers if name in absmax}
    return {name: (a / QMAX if a > 0 else 1.0) for name, a in found.items()}


def weight_scale(weight: torch.Tensor) -> torch.Tensor:
    """Per-output-channel (dim 0) scale absmax / 127 in float32, 1.0 where
    a channel is all zeros: PTQ's and QAT's scale alike."""
    k = weight.float()
    absmax = k.abs().amax(dim=tuple(range(1, k.dim())))
    return torch.where(absmax > 0, absmax / QMAX, torch.ones_like(absmax))


def _per_channel(s: torch.Tensor, ndim: int) -> torch.Tensor:
    return s.view(-1, *(1,) * (ndim - 1))


@torch.no_grad()
def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_q int8 in the weight's layout, s_w float32 (out,))."""
    s_w = weight_scale(weight)
    w_q = torch.clamp(torch.round(weight.float() / _per_channel(s_w, weight.dim())),
                      -QMAX, QMAX).to(torch.int8)
    return w_q, s_w


@torch.no_grad()
def build_quant_tree(model: nn.Module, act_scales: dict, weight_only: bool = False) -> dict:
    """{name: {"w_q", "s_w", "s_x", "bias"}} for every calibrated layer, on
    the model's device: w_q int8 in the port's layout (Conv2d (Cout, Cin,
    kh, kw), Linear (out, in), the grid head's rows in convert.py's (M, G)
    order), s_w float32 per output channel, s_x a float32 scalar (omitted
    with weight_only), bias float32 where the layer has one."""
    out = {}
    for name, s_x in act_scales.items():
        module = model.get_submodule(name)
        if not eligible(module):
            raise TypeError(f"{name} is a {type(module).__name__}, not an eligible layer")
        w_q, s_w = quantize_weight(module.weight)
        entry = {"w_q": w_q, "s_w": s_w}
        if not weight_only:
            entry["s_x"] = torch.tensor(np.float32(s_x), device=w_q.device)
        if module.bias is not None:
            entry["bias"] = module.bias.detach().float().clone()
        out[name] = entry
    return out


def quantize_model(model: nn.Module, calib_batches, weight_only: bool = False) -> dict:
    """One-call PTQ: calibrate the activation scales on `calib_batches` and
    quantize the weights. weight_only=True keeps int8 weights only (the
    calibration pass still names the layers)."""
    return build_quant_tree(model, calibrate_activation_scales(model, calib_batches),
                            weight_only=weight_only)


# -- the int8 product ----------------------------------------------------------


def int8_matmul_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of int8_matmul: exact in float64 (|sum| <= K * 127^2
    < 2^53)."""
    return (a.double() @ w.double().t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32 through
    torch._int_mm (cuBLASLt's int8 GEMM on CUDA). Its CUDA shape rules (more
    than 16 rows; K and N multiples of 8) are met by zero padding, exact for
    integers, sliced off after the product; no shape takes a float product.
    Each call adds one to `int8_matmul.launches`."""
    m, k = a.shape
    n = w.shape[0]
    pad_k, pad_n, pad_m = -k % 8, -n % 8, max(17 - m, 0)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    y = torch._int_mm(a.contiguous(), w.contiguous().t())
    bump(int8_matmul)
    return y[:m, :n] if pad_m or pad_n else y


int8_matmul.launches = 0


def quantize_activation(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """clamp(round(x / s_x), -127, 127) as int8, in JAX's order (a division,
    round half to even)."""
    return torch.clamp(torch.round(x.float() / s_x), -QMAX, QMAX).to(torch.int8)


def im2col(x: torch.Tensor, kernel, stride, padding) -> tuple[torch.Tensor, int, int]:
    """(B, C, H, W) -> ((B * Ho * Wo, C * kh * kw) patches, Ho, Wo), the
    columns in (C, kh, kw) order: zero padding, then a strided view of any
    layout, copied once by the reshape (a 1x1, stride-1 convolution of a
    channels-last input copies nothing)."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    b, c, h, w = x.shape
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    s_b, s_c, s_h, s_w = x.stride()
    view = x.as_strided((b, ho, wo, c, kh, kw), (s_b, s_h * sh, s_w * sw, s_c, s_h, s_w))
    return view.reshape(b * ho * wo, c * kh * kw), ho, wo


def _dequantize(y: torch.Tensor, q: dict, dtype: torch.dtype) -> torch.Tensor:
    """int32 (rows, N) -> y * (s_x * s_w) (+ bias) in float32, then dtype."""
    y = y.float() * (q["s_x"] * q["s_w"])
    if "bias" in q:
        y = y + q["bias"]
    return y.to(dtype)


def _plus_bias(module: nn.Module, y: torch.Tensor, bias: torch.Tensor | None,
               dtype: torch.dtype) -> torch.Tensor:
    """y + bias in float32 (a convolution's over its channel axis), cast to
    dtype; y as it is without a bias."""
    from seld_tpu_torch.models.layers import Conv2d

    if bias is not None:
        y = y.float() + (bias.float().view(-1, 1, 1) if isinstance(module, Conv2d)
                         else bias.float())
    return y.to(dtype)


def _int8_forward(module: nn.Module, x: torch.Tensor, q: dict) -> torch.Tensor:
    """One eligible layer under its quant-tree entry (seld_tpu/quant.py's
    _int8_conv / _int8_dense)."""
    from seld_tpu_torch.models.layers import Conv2d

    dtype = module.compute_dtype
    if "s_x" not in q:  # weight-only: the layer's own op on dequantized weights
        w = (q["w_q"].float() * _per_channel(q["s_w"], q["w_q"].dim())).to(dtype)
        return _plus_bias(module, module.product(x, w), q.get("bias"), dtype)
    xq = quantize_activation(x, q["s_x"])
    w_q = q["w_q"]
    if isinstance(module, Conv2d):
        patches, ho, wo = im2col(xq, module.kernel_size, module.stride, module.padding)
        y = _dequantize(int8_matmul(patches, w_q.reshape(w_q.shape[0], -1)), q, dtype)
        return y.view(x.shape[0], ho, wo, -1).permute(0, 3, 1, 2)
    lead = xq.shape[:-1]
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), w_q)
    return _dequantize(y, q, dtype).view(*lead, -1)


# -- quantization-aware training -----------------------------------------------


def fake_quant(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize with a straight-through gradient:
    x + (clamp(round(x / s), -127, 127) * s - x), the bracket detached, in
    float32, cast back to x's dtype; s is detached."""
    s = s.detach()
    xf = x.float()
    q = torch.clamp(torch.round(xf / s), -QMAX, QMAX) * s
    return (xf + (q - xf).detach()).to(x.dtype)


def _qat_forward(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """seld_tpu/quant.py::qat_interceptor: the input on a per-tensor grid
    (scale from its live absmax, at least 1e-8 / 127), the weight on its
    per-output-channel grid, both straight-through; the layer's own op, the
    bias added in float32."""
    s_x = torch.clamp_min(x.detach().float().abs().amax(), 1e-8) / QMAX
    w = module.weight
    kq = fake_quant(w, _per_channel(weight_scale(w.detach()), w.dim()))
    y = module.product(fake_quant(x, s_x), kq)
    return _plus_bias(module, y, module.bias, module.compute_dtype)


@contextlib.contextmanager
def qat(enabled: bool = True):
    """Inside: every eligible layer fake-quantizes its input and weight (the
    train step enters it with train.qat). A ContextVar: other threads keep
    their own setting; layers.run_block re-enters it for a recompute."""
    token = _QAT.set(bool(enabled))
    try:
        yield
    finally:
        _QAT.reset(token)


def qat_enabled() -> bool:
    return _QAT.get()


# -- the swap ------------------------------------------------------------------


def layer_forward(module: nn.Module, x: torch.Tensor) -> torch.Tensor | None:
    """What an eligible layer returns inside quantized() or qat(), or None
    for its float path. Called by Linear.forward and Conv2d.forward."""
    table = _TABLE.get()
    if table is not None:
        q = table.get(id(module))
        if q is not None:
            return _int8_forward(module, x, q)
    if _QAT.get():
        return _qat_forward(module, x)
    return None


@contextlib.contextmanager
def quantized(model: nn.Module, quant_tree: dict):
    """Inside: the layers of `quant_tree` (port names under `model`) run
    int8, or weight-only where an entry has no s_x."""
    table = {id(model.get_submodule(name)): entry for name, entry in quant_tree.items()}
    token = _TABLE.set(table)
    try:
        yield
    finally:
        _TABLE.reset(token)


def apply_maybe_quantized(model: nn.Module, quant_tree: dict | None, x: torch.Tensor):
    """model(x), with the tree's layers int8 when quant_tree is not None."""
    if quant_tree is None:
        return model(x)
    with quantized(model, quant_tree):
        return model(x)


class QuantizedModel(nn.Module):
    """A model and its quant tree, the tree held as buffers (so that
    torch.export stores int8 weights and scales in the program): forward is
    the model's with the tree's layers int8."""

    def __init__(self, model: nn.Module, quant_tree: dict):
        super().__init__()
        self.model = model
        self.entries = nn.ModuleList()
        self.names = list(quant_tree)
        for name in self.names:
            holder = nn.Module()
            for key, value in quant_tree[name].items():
                holder.register_buffer(key, value)
            self.entries.append(holder)

    def quant_tree(self) -> dict:
        return {name: dict(entry.named_buffers())
                for name, entry in zip(self.names, self.entries)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_maybe_quantized(self.model, self.quant_tree(), x)


def without_float_weights(model: nn.Module, names) -> nn.Module:
    """A copy of the model without the float weight and bias of the named
    layers, which a QuantizedModel of those layers never reads (an exported
    int8 program then stores only their int8 weights)."""
    stripped = copy.deepcopy(model)
    for name in names:
        module = stripped.get_submodule(name)
        module.weight = None
        if module.bias is not None:
            module.bias = None
    return stripped
