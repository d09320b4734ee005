"""JAX variables -> the port's state_dict.

`state_dict_from_jax` takes the `{"params", "batch_stats"}` tree of a
seld_tpu model as numpy arrays (for a restored TrainState:
`jax.tree.map(np.asarray, state.variables())`) and returns the state_dict
of the matching seld_tpu_torch model. Layouts:

  flax Conv kernel (kh, kw, in, out)        -> Conv2d weight (out, in, kh, kw)
  flax Dense kernel (in, out)               -> Linear weight (out, in)
  depthwise Conv kernel (k, 1, D)           -> Conv1d weight (D, 1, k)
  DenseGeneral logits kernel (hidden, M, G) -> Linear weight (M*G, hidden)
  LayerNorm / BatchNorm scale               -> weight
  BatchNorm batch_stats mean / var          -> running_mean / running_var
  GRUCell ir / iz / in kernels (in, H)      -> GRU weight_ih_l0 (3H, in), rows [r|z|n]
  GRUCell hr / hz / hn kernels (H, H)       -> GRU weight_hh_l0 (3H, H), rows [r|z|n]
  GRUCell ir / iz / in biases               -> GRU bias_ih_l0 [b_ir|b_iz|b_in]
  GRUCell hn bias                           -> GRU bias_hh_l0 [0|0|b_hn]

(the reverse direction's tensors carry the suffix `_reverse`; the CRNN's
GRUCell_{2k} is layer k's forward direction, GRUCell_{2k+1} its reverse,
as seld_tpu/tools/torch_import.py maps them).

Every leaf the model needs must be present, and every leaf given must be
used: a missing or unknown key raises KeyError.

Dtypes: a bf16 leaf (a numpy array whose dtype is named "bfloat16", as
jax.device_get gives for model.param_dtype=bfloat16) arrives bf16 bit for
bit, read through its uint16 view; a float32 `params` leaf converted for a
config with param_dtype "bfloat16" is rounded to bf16 to nearest even, as
astype rounds; every other leaf (batch_stats always) is float32.

`quant_tree_from_jax` carries a seld_tpu int8 quant tree ({JAX module
path: {"w_q", "s_w", "s_x", "bias"}}, seld_tpu/quant.py) across the same
way: w_q by the layer's kernel layout, a logits head's (M, G) scales and
bias flattened to the port's M*G rows, s_x as it is.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from seld_tpu_torch.config import ModelConfig
from seld_tpu_torch.models.cspdarknet import STAGE_BLOCKS, scaled_depth
from seld_tpu_torch.models.resnet_conformer import RESNET50_LAYERS


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _conformer_block_layers(i: int):
    """(JAX path, port name, kind) of conformer block i."""
    jb, pb = f"block_{i}", f"blocks.{i}"
    layers = []
    for jff, pff in (("FeedForward_0", "ff1"), ("FeedForward_1", "ff2")):
        layers += [(f"{jb}/{jff}/LayerNorm_0", f"{pb}.{pff}.norm", "ln"),
                   (f"{jb}/{jff}/Dense_0", f"{pb}.{pff}.fc1", "dense"),
                   (f"{jb}/{jff}/Dense_1", f"{pb}.{pff}.fc2", "dense")]
    attn = f"{jb}/MultiHeadSelfAttention_0"
    layers.append((f"{attn}/LayerNorm_0", f"{pb}.attn.norm", "ln"))
    for w in ("w_q", "w_k", "w_v", "w_o"):
        layers.append((f"{attn}/{w}", f"{pb}.attn.{w}", "dense"))
    conv = f"{jb}/ConformerConvModule_0"
    layers += [(f"{conv}/LayerNorm_0", f"{pb}.conv.norm", "ln"),
               (f"{conv}/Dense_0", f"{pb}.conv.pw1", "dense"),
               (f"{conv}/depthwise", f"{pb}.conv.depthwise", "depthwise"),
               (f"{conv}/BatchNorm_0", f"{pb}.conv.bn", "bn"),
               (f"{conv}/Dense_1", f"{pb}.conv.pw2", "dense"),
               (f"{jb}/LayerNorm_0", f"{pb}.norm", "ln")]
    return layers


_GRID_HEAD = [("GridHead_0/Dense_0", "head.fc", "dense"),
              ("GridHead_0/LayerNorm_0", "head.norm", "ln"),
              ("GridHead_0/logits", "head.logits", "logits")]


def _resnet_conformer_layers(cfg: ModelConfig):
    """(JAX module path, port module name, kind) for every layer."""
    enc = "ResNet50Encoder_0"
    layers = [(f"{enc}/stem", "encoder.stem", "conv"),
              (f"{enc}/stem_bn", "encoder.stem_bn", "bn")]
    for stage, n in enumerate(RESNET50_LAYERS, start=1):
        for block in range(n):
            name = f"stage{stage}_block{block}"
            for i in (1, 2, 3):
                layers.append((f"{enc}/{name}/conv{i}", f"encoder.{name}.conv{i}", "conv"))
                layers.append((f"{enc}/{name}/bn{i}", f"encoder.{name}.bn{i}", "bn"))
            if block == 0:  # every stage's first block projects its shortcut
                layers.append((f"{enc}/{name}/downsample", f"encoder.{name}.downsample", "conv"))
                layers.append((f"{enc}/{name}/downsample_bn", f"encoder.{name}.downsample_bn", "bn"))
    layers.append(("proj", "proj", "dense"))
    for i in range(cfg.resnet_conf_n_layers):
        layers += _conformer_block_layers(i)
    return layers + _GRID_HEAD


def _cnn_encoder_layers(cfg: ModelConfig):
    layers = []
    for i in range(len(cfg.crnn_cnn_channels)):
        block = f"CNNEncoder_0/ConvBlock_{i}"
        layers += [(f"{block}/Conv_0", f"encoder.blocks.{i}.conv", "conv"),
                   (f"{block}/BatchNorm_0", f"encoder.blocks.{i}.bn", "bn")]
    return layers


def _crnn_layers(cfg: ModelConfig):
    layers = _cnn_encoder_layers(cfg)
    for k in range(cfg.crnn_rnn_layers):
        layers += [(f"BiGRU_0/GRUCell_{2 * k}", f"rnn.layers.{k}", "gru"),
                   (f"BiGRU_0/GRUCell_{2 * k + 1}", f"rnn.layers.{k}", "gru_reverse")]
    return layers + _GRID_HEAD


def _conformer_layers(cfg: ModelConfig):
    layers = _cnn_encoder_layers(cfg) + [("proj", "proj", "dense")]
    for i in range(cfg.conf_n_layers):
        layers += _conformer_block_layers(i)
    return layers + _GRID_HEAD


def _accdoa_conformer_layers(cfg: ModelConfig):
    """The Conformer's encoder and blocks with the ACCDOA head's Dense,
    whose outputs flax orders (track, class, axis) as the port does."""
    layers = _cnn_encoder_layers(cfg) + [("proj", "proj", "dense")]
    for i in range(cfg.conf_n_layers):
        layers += _conformer_block_layers(i)
    return layers + [("accdoa", "accdoa", "dense")]


def _cspdarknet_layers(cfg: ModelConfig):
    def cbs(jax_path, port_name):  # ConvBnSiLU
        return [(f"{jax_path}/Conv_0", f"{port_name}.conv", "conv"),
                (f"{jax_path}/BatchNorm_0", f"{port_name}.bn", "bn")]

    depth = 0.33 if cfg.csp_use_small else 1.0
    layers = cbs("backbone/stem", "backbone.stem")
    for s, n in enumerate(STAGE_BLOCKS):
        layers += cbs(f"backbone/down{s}", f"backbone.down{s}")
        c3, pc3 = f"backbone/c3_{s}", f"backbone.c3_{s}"
        for cv in ("cv1", "cv2", "cv3"):
            layers += cbs(f"{c3}/{cv}", f"{pc3}.{cv}")
        for i in range(scaled_depth(n, depth)):
            layers += (cbs(f"{c3}/m{i}/ConvBnSiLU_0", f"{pc3}.m.{i}.cv1")
                       + cbs(f"{c3}/m{i}/ConvBnSiLU_1", f"{pc3}.m.{i}.cv2"))
    layers += cbs("backbone/sppf/cv1", "backbone.sppf.cv1")
    layers += cbs("backbone/sppf/cv2", "backbone.sppf.cv2")
    layers += [(f"reduce_{p}", f"reduce_{p}", "conv_bias") for p in ("p3", "p4", "p5")]
    layers += cbs("fuse1", "fuse1") + cbs("fuse2", "fuse2")
    return layers + [("cls1", "cls1", "dense"), ("LayerNorm_0", "cls_norm", "ln"),
                     ("cls2", "cls2", "dense")]


_LAYERS = {
    "resnet_conformer": _resnet_conformer_layers,
    "crnn": _crnn_layers,
    "conformer": _conformer_layers,
    "cnn": _cspdarknet_layers,
    "cspdarknet": _cspdarknet_layers,
    "accdoa_conformer": _accdoa_conformer_layers,
    "multi_accdoa_conformer": _accdoa_conformer_layers,
}


def _gru(take, suffix: str) -> dict[str, np.ndarray]:
    """One flax GRUCell -> one direction of a single-layer nn.GRU."""
    gates = "rzn"
    w_ih = np.concatenate([take("params", f"i{g}/kernel").T for g in gates])
    w_hh = np.concatenate([take("params", f"h{g}/kernel").T for g in gates])
    b_ih = np.concatenate([take("params", f"i{g}/bias") for g in gates])
    b_hn = take("params", "hn/bias")
    b_hh = np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
    return {f"weight_ih_l0{suffix}": w_ih, f"weight_hh_l0{suffix}": w_hh,
            f"bias_ih_l0{suffix}": b_ih, f"bias_hh_l0{suffix}": b_hh}


def _convert(take, kind: str) -> dict[str, np.ndarray]:
    """One layer's port tensors; `take(collection, leaf)` pops a JAX leaf."""
    if kind == "conv":
        return {"weight": take("params", "kernel").transpose(3, 2, 0, 1)}
    if kind == "conv_bias":
        return {"weight": take("params", "kernel").transpose(3, 2, 0, 1),
                "bias": take("params", "bias")}
    if kind in ("gru", "gru_reverse"):
        return _gru(take, "_reverse" if kind == "gru_reverse" else "")
    if kind == "dense":
        return {"weight": take("params", "kernel").T,
                "bias": take("params", "bias")}
    if kind == "depthwise":
        return {"weight": take("params", "kernel").transpose(2, 1, 0),
                "bias": take("params", "bias")}
    if kind == "logits":
        kernel = take("params", "kernel")
        return {"weight": kernel.reshape(kernel.shape[0], -1).T,
                "bias": take("params", "bias").reshape(-1)}
    if kind == "ln":
        return {"weight": take("params", "scale"), "bias": take("params", "bias")}
    if kind == "bn":
        return {"weight": take("params", "scale"), "bias": take("params", "bias"),
                "running_mean": take("batch_stats", "mean"),
                "running_var": take("batch_stats", "var")}
    raise ValueError(f"unknown layer kind {kind!r}")


def _tensor(value: np.ndarray, round_to_bf16: bool) -> torch.Tensor:
    """A leaf as a writable CPU tensor: bf16 bit for bit, float32 otherwise
    (rounded to bf16 when asked)."""
    if value.dtype.name == "bfloat16":
        bits = np.array(value, order="C").view(np.uint16)  # a copy, then its bits
        return torch.from_numpy(bits).view(torch.bfloat16)
    t = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return t.to(torch.bfloat16) if round_to_bf16 else t


def state_dict_from_jax(variables_np: Mapping, model_cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """seld_tpu variables (numpy leaves) -> seld_tpu_torch state_dict."""
    if model_cfg.model_type not in _LAYERS:
        raise NotImplementedError(
            f"no converter for model_type {model_cfg.model_type!r} yet"
        )
    leaves = _flatten(variables_np)
    bf16_params = model_cfg.param_dtype == "bfloat16"
    state = {}
    for jax_path, port_name, kind in _LAYERS[model_cfg.model_type](model_cfg):
        def take(collection, leaf, _path=jax_path):
            key = f"{collection}/{_path}/{leaf}"
            if key not in leaves:
                raise KeyError(f"JAX variables have no {key!r}")
            return leaves.pop(key)

        for leaf, value in _convert(take, kind).items():
            state[f"{port_name}.{leaf}"] = _tensor(
                value, bf16_params and not leaf.startswith("running_"))
    if leaves:
        raise KeyError(f"JAX variables the port does not know: {sorted(leaves)[:5]}")
    return state


def quant_tree_from_jax(jax_qtree_np: Mapping, model_cfg: ModelConfig) -> dict[str, dict]:
    """A seld_tpu quant tree (numpy leaves) -> the port's
    {module name: {"w_q", "s_w", "s_x", "bias"}} (seld_tpu_torch.quant) on
    the CPU. Each of the model's eligible layers must be in the tree, and
    every key of the tree must be one of them: KeyError otherwise."""
    from seld_tpu_torch.quant import ELIGIBLE_KINDS

    if model_cfg.model_type not in _LAYERS:
        raise NotImplementedError(
            f"no converter for model_type {model_cfg.model_type!r} yet"
        )
    layers = {jax_path: (port, kind) for jax_path, port, kind
              in _LAYERS[model_cfg.model_type](model_cfg) if kind in ELIGIBLE_KINDS}
    unknown = sorted(set(jax_qtree_np) - set(layers))
    if unknown:
        raise KeyError(f"quant tree layers the port does not know: {unknown[:5]}")
    missing = sorted(set(layers) - set(jax_qtree_np))
    if missing:
        raise KeyError(f"the quant tree has no {missing[0]!r} ({len(missing)} eligible "
                       "layers missing)")
    out = {}
    for jax_path, (port, kind) in layers.items():
        entry = {k: np.asarray(v) for k, v in jax_qtree_np[jax_path].items()}
        for leaf in ("w_q", "s_w"):
            if leaf not in entry:
                raise KeyError(f"quant tree entry {jax_path!r} has no {leaf!r}")
        w_q = entry.pop("w_q")
        if kind in ("conv", "conv_bias"):
            w_q = w_q.transpose(3, 2, 0, 1)
        elif kind == "logits":
            w_q = w_q.reshape(w_q.shape[0], -1).T
        else:
            w_q = w_q.T
        port_entry = {"w_q": torch.from_numpy(np.ascontiguousarray(w_q, dtype=np.int8))}
        for leaf, value in entry.items():
            if leaf not in ("s_w", "s_x", "bias"):
                raise KeyError(f"quant tree entry {jax_path!r} has an unknown leaf {leaf!r}")
            value = value.astype(np.float32)
            port_entry[leaf] = torch.from_numpy(
                np.array(value if leaf == "s_x" else value.reshape(-1), order="C"))
        out[port] = port_entry
    return out
