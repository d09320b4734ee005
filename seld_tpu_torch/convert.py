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

Every leaf the model needs must be present, and every leaf given must be
used: a missing or unknown key raises KeyError.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from seld_tpu_torch.config import ModelConfig
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
        jb, pb = f"block_{i}", f"blocks.{i}"
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
    layers += [("GridHead_0/Dense_0", "head.fc", "dense"),
               ("GridHead_0/LayerNorm_0", "head.norm", "ln"),
               ("GridHead_0/logits", "head.logits", "logits")]
    return layers


def _convert(take, kind: str) -> dict[str, np.ndarray]:
    """One layer's port tensors; `take(collection, leaf)` pops a JAX leaf."""
    if kind == "conv":
        return {"weight": take("params", "kernel").transpose(3, 2, 0, 1)}
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


def state_dict_from_jax(variables_np: Mapping, model_cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """seld_tpu variables (numpy leaves) -> seld_tpu_torch state_dict."""
    if model_cfg.model_type != "resnet_conformer":
        raise NotImplementedError(
            f"no converter for model_type {model_cfg.model_type!r} yet"
        )
    leaves = _flatten(variables_np)
    state = {}
    for jax_path, port_name, kind in _resnet_conformer_layers(model_cfg):
        def take(collection, leaf, _path=jax_path):
            key = f"{collection}/{_path}/{leaf}"
            if key not in leaves:
                raise KeyError(f"JAX variables have no {key!r}")
            return leaves.pop(key)

        for leaf, value in _convert(take, kind).items():
            state[f"{port_name}.{leaf}"] = torch.from_numpy(
                np.array(value, dtype=np.float32, order="C")  # a writable copy
            )
    if leaves:
        raise KeyError(f"JAX variables the port does not know: {sorted(leaves)[:5]}")
    return state
