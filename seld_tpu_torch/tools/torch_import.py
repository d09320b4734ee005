"""Import checkpoints of the reference PyTorch pipeline (counterpart:
seld_tpu/tools/torch_import.py).

A reference `state_dict` (the `model_state_dict` of its checkpoints, ref
trainer.py:278-285, or a bare state_dict .pth) is converted into the
seld_tpu layout of `{"params", "batch_stats"}` (this module's numpy copy
of the JAX package's map), and from there into the port's state_dict by
`seld_tpu_torch.convert.state_dict_from_jax`. Both halves are transposes
and copies; each raises on a key it misses or does not use.

Layout transforms, reference -> seld_tpu:
  Conv2d (O, I, kH, kW)          -> Conv kernel (kH, kW, I, O)
  Conv1d pointwise (O, I, 1)     -> Dense kernel (I, O)
  Conv1d depthwise (D, 1, K)     -> Conv kernel (K, 1, D)
  Linear (O, I)                  -> Dense kernel (I, O)
  GRU gate rows [r|z|n]          -> GRUCell ir/iz/in + hr/hz/hn, with
    b_ih + b_hh folded into the r and z input biases (the gate equations
    make them the same);
  the grid head's last Linear emits G*M columns grid-major; its kernel
    is permuted to class-major (hidden, M, G).

The counts of layers come from the model config (the CNN encoder's
blocks, the GRU layers, the conformer blocks), where the JAX package
assumes its default depths.
"""

from __future__ import annotations

import numpy as np


def _conv2d(w):
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32)


def _linear(w):
    return np.ascontiguousarray(w.T).astype(np.float32)


def _pointwise1d(w):  # (O, I, 1) -> (I, O)
    return np.ascontiguousarray(w[:, :, 0].T).astype(np.float32)


def _depthwise1d(w):  # (D, 1, K) -> (K, 1, D)
    return np.transpose(w, (2, 1, 0)).astype(np.float32)


class _Tree:
    """Collects seld_tpu-path -> array assignments into nested dicts."""

    def __init__(self, sd):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.params: dict = {}
        self.stats: dict = {}
        self.used: set = set()

    def _get(self, key):
        self.used.add(key)
        return self.sd[key]

    def _set(self, root, path, value):
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value, np.float32)

    def p(self, path, value):
        self._set(self.params, path, value)

    def conv2d(self, prefix, torch_prefix, bias=False):
        self.p(f"{prefix}/kernel", _conv2d(self._get(f"{torch_prefix}.weight")))
        if bias:
            self.p(f"{prefix}/bias", self._get(f"{torch_prefix}.bias"))

    def linear(self, prefix, torch_prefix, bias=True):
        self.p(f"{prefix}/kernel", _linear(self._get(f"{torch_prefix}.weight")))
        if bias:
            self.p(f"{prefix}/bias", self._get(f"{torch_prefix}.bias"))

    def norm(self, prefix, torch_prefix):
        """LayerNorm: weight -> scale, bias -> bias."""
        self.p(f"{prefix}/scale", self._get(f"{torch_prefix}.weight"))
        self.p(f"{prefix}/bias", self._get(f"{torch_prefix}.bias"))

    def bn(self, prefix, torch_prefix):
        self.norm(prefix, torch_prefix)
        self._set(self.stats, f"{prefix}/mean", self._get(f"{torch_prefix}.running_mean"))
        self._set(self.stats, f"{prefix}/var", self._get(f"{torch_prefix}.running_var"))
        self.used.add(f"{torch_prefix}.num_batches_tracked")

    def gru_direction(self, prefix, torch_suffix):
        """One reference GRU direction -> one GRUCell."""
        w_ih = self._get(f"rnn.weight_ih_{torch_suffix}")  # (3H, in)
        w_hh = self._get(f"rnn.weight_hh_{torch_suffix}")  # (3H, H)
        b_ih = self._get(f"rnn.bias_ih_{torch_suffix}")
        b_hh = self._get(f"rnn.bias_hh_{torch_suffix}")
        h = w_hh.shape[1]
        for g, name in enumerate(("r", "z", "n")):
            sl = slice(g * h, (g + 1) * h)
            self.p(f"{prefix}/i{name}/kernel", _linear(w_ih[sl]))
            self.p(f"{prefix}/h{name}/kernel", _linear(w_hh[sl]))
            if name == "n":
                self.p(f"{prefix}/in/bias", b_ih[sl])
                self.p(f"{prefix}/hn/bias", b_hh[sl])
            else:  # r, z: the two reference biases are one input bias
                self.p(f"{prefix}/i{name}/bias", b_ih[sl] + b_hh[sl])


def _cnn_encoder(t: _Tree, n_blocks: int):
    for i in range(n_blocks):
        t.conv2d(f"CNNEncoder_0/ConvBlock_{i}/Conv_0", f"cnn_blocks.{i}.conv")
        t.bn(f"CNNEncoder_0/ConvBlock_{i}/BatchNorm_0", f"cnn_blocks.{i}.bn")


def _grid_head(t: _Tree, torch_prefix: str, num_classes: int):
    t.linear("GridHead_0/Dense_0", f"{torch_prefix}.0")
    t.norm("GridHead_0/LayerNorm_0", f"{torch_prefix}.1")
    # the reference emits G*M columns grid-major, (..., G, M); the logits
    # kernel is class-major (hidden, M, G): output[..., m, g] equals the
    # reference's output[..., g, m]
    w = t._get(f"{torch_prefix}.4.weight")  # (G*M, hidden)
    b = t._get(f"{torch_prefix}.4.bias")  # (G*M,)
    gm, hidden = w.shape
    g = gm // num_classes
    t.p("GridHead_0/logits/kernel", np.ascontiguousarray(
        w.T.reshape(hidden, g, num_classes).transpose(0, 2, 1)).astype(np.float32))
    t.p("GridHead_0/logits/bias",
        np.ascontiguousarray(b.reshape(g, num_classes).T).astype(np.float32))


def _conformer_blocks(t: _Tree, n_layers: int):
    for i in range(n_layers):
        tb, fb = f"conformer_blocks.{i}", f"block_{i}"
        for ff_t, ff_f in (("ff1", "FeedForward_0"), ("ff2", "FeedForward_1")):
            t.linear(f"{fb}/{ff_f}/Dense_0", f"{tb}.{ff_t}.linear1")
            t.linear(f"{fb}/{ff_f}/Dense_1", f"{tb}.{ff_t}.linear2")
            t.norm(f"{fb}/{ff_f}/LayerNorm_0", f"{tb}.{ff_t}.norm")
        for w in ("w_q", "w_k", "w_v", "w_o"):
            t.linear(f"{fb}/MultiHeadSelfAttention_0/{w}", f"{tb}.attn.{w}")
        t.norm(f"{fb}/MultiHeadSelfAttention_0/LayerNorm_0", f"{tb}.attn.norm")
        cm = f"{fb}/ConformerConvModule_0"
        t.norm(f"{cm}/LayerNorm_0", f"{tb}.conv.layer_norm")
        t.p(f"{cm}/Dense_0/kernel", _pointwise1d(t._get(f"{tb}.conv.pointwise_conv1.weight")))
        t.p(f"{cm}/Dense_0/bias", t._get(f"{tb}.conv.pointwise_conv1.bias"))
        t.p(f"{cm}/depthwise/kernel", _depthwise1d(t._get(f"{tb}.conv.depthwise_conv.weight")))
        t.p(f"{cm}/depthwise/bias", t._get(f"{tb}.conv.depthwise_conv.bias"))
        t.bn(f"{cm}/BatchNorm_0", f"{tb}.conv.batch_norm")
        t.p(f"{cm}/Dense_1/kernel", _pointwise1d(t._get(f"{tb}.conv.pointwise_conv2.weight")))
        t.p(f"{cm}/Dense_1/bias", t._get(f"{tb}.conv.pointwise_conv2.bias"))
        t.norm(f"{fb}/LayerNorm_0", f"{tb}.norm")


def _convert_crnn(t: _Tree, cfg, num_classes: int):
    _cnn_encoder(t, len(cfg.crnn_cnn_channels))
    for layer in range(cfg.crnn_rnn_layers):
        t.gru_direction(f"BiGRU_0/GRUCell_{2 * layer}", f"l{layer}")
        t.gru_direction(f"BiGRU_0/GRUCell_{2 * layer + 1}", f"l{layer}_reverse")
    _grid_head(t, "fnn", num_classes)


def _convert_conformer(t: _Tree, cfg, num_classes: int):
    _cnn_encoder(t, len(cfg.crnn_cnn_channels))
    t.linear("proj", "proj")
    _conformer_blocks(t, cfg.conf_n_layers)
    _grid_head(t, "fnn", num_classes)


def _convert_resnet_conformer(t: _Tree, cfg, num_classes: int):
    enc = "ResNet50Encoder_0"
    t.conv2d(f"{enc}/stem", "encoder.conv1")
    t.bn(f"{enc}/stem_bn", "encoder.bn1")
    for stage, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            tb = f"encoder.layer{stage}.{b}"
            fb = f"{enc}/stage{stage}_block{b}"
            for c in (1, 2, 3):
                t.conv2d(f"{fb}/conv{c}", f"{tb}.conv{c}")
                t.bn(f"{fb}/bn{c}", f"{tb}.bn{c}")
            if f"{tb}.downsample.0.weight" in t.sd:
                t.conv2d(f"{fb}/downsample", f"{tb}.downsample.0")
                t.bn(f"{fb}/downsample_bn", f"{tb}.downsample.1")
    t.linear("proj", "proj")
    _conformer_blocks(t, cfg.resnet_conf_n_layers)
    _grid_head(t, "head", num_classes)


def _conv_bn_silu(t: _Tree, prefix, torch_prefix):
    t.conv2d(f"{prefix}/Conv_0", f"{torch_prefix}.conv")
    t.bn(f"{prefix}/BatchNorm_0", f"{torch_prefix}.bn")


def _convert_cspdarknet(t: _Tree, cfg, num_classes: int):
    _conv_bn_silu(t, "backbone/stem", "backbone.stem")
    for s in range(4):
        t_stage = f"backbone.stage{s + 1}"
        _conv_bn_silu(t, f"backbone/down{s}", f"{t_stage}.0")
        c3_t, c3_f = f"{t_stage}.1", f"backbone/c3_{s}"
        for cv in ("cv1", "cv2", "cv3"):
            _conv_bn_silu(t, f"{c3_f}/{cv}", f"{c3_t}.{cv}")
        i = 0
        while f"{c3_t}.m.{i}.cv1.conv.weight" in t.sd:
            _conv_bn_silu(t, f"{c3_f}/m{i}/ConvBnSiLU_0", f"{c3_t}.m.{i}.cv1")
            _conv_bn_silu(t, f"{c3_f}/m{i}/ConvBnSiLU_1", f"{c3_t}.m.{i}.cv2")
            i += 1
    for cv in ("cv1", "cv2"):  # SPPF
        _conv_bn_silu(t, f"backbone/sppf/{cv}", f"backbone.stage4.2.{cv}")
    for p in ("p3", "p4", "p5"):
        t.conv2d(f"reduce_{p}", f"reduce_{p}", bias=True)
    t.conv2d("fuse1/Conv_0", "conv_fuse.0")
    t.bn("fuse1/BatchNorm_0", "conv_fuse.1")
    t.conv2d("fuse2/Conv_0", "conv_fuse.3")
    t.bn("fuse2/BatchNorm_0", "conv_fuse.4")
    t.linear("cls1", "classifier.0")
    t.norm("LayerNorm_0", "classifier.1")
    t.linear("cls2", "classifier.4")


_CONVERTERS = {
    "crnn": _convert_crnn,
    "conformer": _convert_conformer,
    "resnet_conformer": _convert_resnet_conformer,
    "cnn": _convert_cspdarknet,
    "cspdarknet": _convert_cspdarknet,
}


def convert_torch_state_dict(state_dict: dict, model_cfg, num_classes: int = 14) -> dict:
    """A reference state_dict (numpy or tensor values) -> seld_tpu variables
    {"params": ..., "batch_stats": ...} of the model model_cfg describes."""
    if model_cfg.model_type not in _CONVERTERS:
        raise NotImplementedError(
            f"no reference-checkpoint converter for model_type {model_cfg.model_type!r} "
            f"(the reference has {sorted(_CONVERTERS)})")
    t = _Tree(state_dict)
    try:
        _CONVERTERS[model_cfg.model_type](t, model_cfg, num_classes)
    except KeyError as e:
        raise KeyError(f"state_dict key {e} not found — is this a {model_cfg.model_type} "
                       "checkpoint?") from e
    unused = {u for u in set(t.sd) - t.used if "num_batches_tracked" not in u}
    if unused:
        raise ValueError(f"unconverted torch keys: {sorted(unused)[:8]}...")
    return {"params": t.params, "batch_stats": t.stats}


def import_state_dict(state_dict: dict, model_cfg, num_classes: int = 14) -> dict:
    """A reference state_dict -> the port's state_dict of the same model."""
    from seld_tpu_torch.convert import state_dict_from_jax

    return state_dict_from_jax(convert_torch_state_dict(state_dict, model_cfg, num_classes),
                               model_cfg)
