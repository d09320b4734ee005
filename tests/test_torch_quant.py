"""int8 post-training quantization and quantization-aware training in the
port (seld_tpu_torch/quant.py) against seld_tpu/quant.py, on the CPU at
tiny widths, with random JAX variables carried across by
convert.state_dict_from_jax and JAX quant trees by convert.quant_tree_from_jax:
one layer of each kind (its int8 x int8 -> int32 products bit-equal to
XLA's int32 dot and convolution), the quantized tree and forward of each
model family, QAT's forward and straight-through gradients against
jax.grad of qat_apply; then the port's own int8 paths: the predictor with
TTA and streaming, evaluation, decode calibration, the artifacts, the daemon,
`cli train train.qat=true`, and every refusal. torch._int_mm runs on the CPU
here, where it agrees with an int32 product; on the card it is cuBLASLt's
(chip_smoke.py phase 17 holds it to the plain version)."""

import json
import logging
import re
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from seld_tpu import quant as jq
from seld_tpu.config import Config, parse_overrides
from seld_tpu.models import build_model as build_jax_model
from seld_tpu_torch import calibrate as port_calibrate
from seld_tpu_torch import config as pc
from seld_tpu_torch import quant
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.convert import quant_tree_from_jax, state_dict_from_jax
from seld_tpu_torch.data.audio import load_wav, write_wav
from seld_tpu_torch.data.synthetic import synthetic_corpus
from seld_tpu_torch.eval import evaluate_model
from seld_tpu_torch.features.spatial import feature_channels
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.models import build_model
from seld_tpu_torch.models.layers import Conv2d, Linear
from seld_tpu_torch.serve import stream_client
from seld_tpu_torch.stream import stream_predict
from seld_tpu_torch.train.checkpoint import save_checkpoint
from seld_tpu_torch.train.steps import make_train_step
from tests.test_torch_backbones import port_model, random_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails

SR = 24_000
WAIT = 60  # seconds: every join and socket read


@pytest.fixture(autouse=True)
def remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# --- one layer of each kind -------------------------------------------------------

# name -> (conv: (cin, cout, kernel, stride, padding, bias) | dense: (in, features, bias))
LAYERS = {
    "conv3x3_s12": ("conv", (16, 24, 3, (1, 2), 1, False)),
    "down1x1_s12": ("conv", (16, 32, 1, (1, 2), 0, False)),
    "conv_bias": ("conv", (16, 24, 1, (1, 1), 0, True)),  # the CSPDarkNet's reduce_p*
    "stem4": ("conv", (4, 64, 3, (1, 2), 1, False)),  # inner size 36: padded to 40
    "stem7": ("conv", (7, 64, 3, (1, 2), 1, False)),  # 63 -> 64
    "stem10": ("conv", (10, 64, 3, (1, 2), 1, False)),  # 90 -> 96
    "dense": ("dense", (24, (39,), True)),  # the ACCDOA head's 39 outputs: padded to 40
    "logits": ("dense", (24, (3, 10), True)),  # the grid head's (M, G) DenseGeneral
}


class OneLayer(fnn.Module):
    kind: str
    spec: tuple

    @fnn.compact
    def __call__(self, x, train: bool = False):
        if self.kind == "conv":
            _, cout, k, stride, pad, bias = self.spec
            return fnn.Conv(cout, (k, k), strides=stride, padding=pad, use_bias=bias,
                            name="layer")(x)
        _, features, bias = self.spec
        if len(features) > 1:
            return fnn.DenseGeneral(features=features, name="layer")(x)
        return fnn.Dense(features[0], use_bias=bias, name="layer")(x)


def _one_layer(name):
    """(flax module, numpy variables, port layer with the same weights, the
    flax input, the port input)."""
    kind, spec = LAYERS[name]
    rng = np.random.default_rng(len(name))
    if kind == "conv":
        cin, cout, k, stride, pad, bias = spec
        x = rng.standard_normal((2, 5, 12, cin)).astype(np.float32)  # NHWC
        layer = Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias)
        port_x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    else:
        cin, features, bias = spec
        x = rng.standard_normal((1, 5, cin)).astype(np.float32)  # 5 rows: padded to 17
        layer = Linear(cin, int(np.prod(features)), bias=bias)
        port_x = torch.from_numpy(x)
    module = OneLayer(kind, spec)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    params = {"layer": {k: rng.standard_normal(v.shape).astype(np.float32) * 0.2
                        for k, v in shapes["params"]["layer"].items()}}
    kernel = params["layer"]["kernel"]
    with torch.no_grad():
        if kind == "conv":
            layer.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        else:
            layer.weight.copy_(torch.from_numpy(kernel.reshape(cin, -1).T.copy()))
        if "bias" in params["layer"]:
            layer.bias.copy_(torch.from_numpy(params["layer"]["bias"].reshape(-1)))
    return module, {"params": params}, layer.eval(), x, port_x


def _jax_int32(module, kind, x, q):
    """XLA's int8 x int8 -> int32 product of the layer (seld_tpu/quant.py's
    _int8_conv / _int8_dense without their dequantize)."""
    xq = jq._quant_act(jnp.asarray(x), q["s_x"])
    if kind == "conv":
        _, _, _, stride, pad, _ = module.spec
        return np.asarray(jax.lax.conv_general_dilated(
            xq, q["w_q"], window_strides=stride, padding=[(pad, pad)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    w2 = q["w_q"].reshape(q["w_q"].shape[0], -1)
    return np.asarray(jax.lax.dot_general(xq, w2, (((x.ndim - 1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))


def _port_int32(layer, port_x, entry):
    xq = quant.quantize_activation(port_x, entry["s_x"])
    w_q = entry["w_q"]
    if isinstance(layer, Conv2d):
        patches, ho, wo = quant.im2col(xq, layer.kernel_size, layer.stride, layer.padding)
        y = quant.int8_matmul(patches, w_q.reshape(w_q.shape[0], -1))
        return y.view(port_x.shape[0], ho, wo, -1).numpy()
    return quant.int8_matmul(xq.reshape(-1, xq.shape[-1]), w_q).view(*xq.shape[:-1], -1).numpy()


@pytest.mark.parametrize("weight_only", [False, True], ids=["ptq", "weight_only"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_one_layer_matches_jax(name, weight_only):
    """The port's w_q and s_w bit-equal to JAX's; with JAX's s_x the int32
    products bit-equal to XLA's and the PTQ output equal to JAX's (the same
    float32 dequantize in the same order: measured 0.0, held to 1e-6); a
    weight-only output within 1e-5 (float32 products summed in another
    order)."""
    module, variables, layer, x, port_x = _one_layer(name)
    kind = LAYERS[name][0]
    tree = jq.quantize_model(module, variables, [x], weight_only=weight_only)
    want = np.asarray(jq.quantized_apply(module, variables, tree, x))
    q = {k: np.asarray(v) for k, v in tree["layer"].items()}
    w_q, s_w = quant.quantize_weight(layer.weight)
    jax_w_q = q["w_q"].transpose(3, 2, 0, 1) if kind == "conv" else \
        q["w_q"].reshape(q["w_q"].shape[0], -1).T
    np.testing.assert_array_equal(w_q.numpy(), jax_w_q)
    np.testing.assert_array_equal(s_w.numpy(), q["s_w"].reshape(-1))
    entry = {"w_q": w_q, "s_w": s_w}
    if "bias" in q:
        entry["bias"] = torch.from_numpy(q["bias"].reshape(-1).copy())
    if weight_only:
        assert "s_x" not in q
    else:
        entry["s_x"] = torch.tensor(q["s_x"])
        got32 = _port_int32(layer, port_x, entry)
        want32 = _jax_int32(module, kind, x, {k: jnp.asarray(v) for k, v in q.items()})
        assert got32.dtype == np.int32
        np.testing.assert_array_equal(got32, want32.reshape(got32.shape))
    with torch.no_grad(), quant.quantized(layer, {"": entry}):
        got = layer(port_x)
    got = got.permute(0, 2, 3, 1).numpy() if kind == "conv" else got.numpy()
    tol = 1e-5 if weight_only else 1e-6
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=tol, atol=tol)


def test_int8_matmul_pads_to_the_gemm_rules_and_equals_its_plain_version():
    """Rows below 17 and inner / outer sizes off a multiple of 8 are padded
    with zeros and sliced off: the result is the exact int32 product."""
    rng = np.random.default_rng(0)
    for m, k, n in ((3, 36, 39), (17, 63, 14), (64, 90, 117), (40, 64, 64)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
        before = quant.int8_matmul.launches
        got = quant.int8_matmul(a, w)
        assert quant.int8_matmul.launches == before + 1
        assert got.shape == (m, n) and got.dtype == torch.int32
        assert torch.equal(got, quant.int8_matmul_reference(a, w))


# --- each model family ------------------------------------------------------------

FAMILIES = {
    "resnet_conformer": ["model.model_type=resnet_conformer", "model.resnet_conf_d_model=32",
                         "model.resnet_conf_n_heads=2", "model.resnet_conf_n_layers=1"],
    "conformer": ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                  "model.conf_d_model=32", "model.conf_n_heads=4", "model.conf_n_layers=1"],
    "crnn": ["model.model_type=crnn", "model.crnn_cnn_channels=8,16",
             "model.crnn_rnn_hidden=16", "model.crnn_rnn_layers=2"],
    "cnn": ["model.model_type=cnn"],  # CSPDarkNet at its small default widths
    "accdoa_conformer": ["model.model_type=accdoa_conformer", "model.crnn_cnn_channels=8,16",
                         "model.conf_d_model=32", "model.conf_n_heads=4",
                         "model.conf_n_layers=1"],
    "multi_accdoa_conformer": ["model.model_type=multi_accdoa_conformer",
                               "model.crnn_cnn_channels=8,16", "model.conf_d_model=32",
                               "model.conf_n_heads=4", "model.conf_n_layers=1"],
}
# eligible layers: the flagship's 53 ResNet50 convs, proj, 10 per conformer block
# and the head's two; the CSPDarkNet's 36 + 3 reductions + its classifier's 2, ...
N_ELIGIBLE = {"resnet_conformer": 66, "conformer": 15, "crnn": 4, "cnn": 40,
              "accdoa_conformer": 14, "multi_accdoa_conformer": 14}
B, T = 2, 6


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX model, numpy variables, overrides, calibration batches, the
    JAX quant tree (numpy), the port model, the port's own quant tree)."""
    overrides = FAMILIES[request.param] + ["model.compute_dtype=float32"]
    cfg = parse_overrides(Config(), overrides)
    model = build_jax_model(cfg.model, cfg.grid)
    variables = random_variables(model, jnp.zeros((B, T, 4, 64), jnp.float32))
    rng = np.random.default_rng(1)
    batches = [rng.standard_normal((B, T, 4, 64)).astype(np.float32) for _ in range(2)]
    jax_tree = jax.tree.map(np.asarray, jq.quantize_model(model, variables, batches))
    port = port_model(variables, overrides)
    port_tree = quant.quantize_model(port, [torch.from_numpy(b) for b in batches])
    return request.param, model, variables, overrides, batches, jax_tree, port, port_tree


def test_eligible_layers_are_the_jax_trees_keys(family):
    """The port's quantized layers are exactly the JAX tree's through
    convert's layer list: the depthwise convolution, the GRU, the norms
    and attention's products are not among them (tests/test_quant.py:65-109)."""
    name, _, _, _, _, jax_tree, port, port_tree = family
    carried = quant_tree_from_jax(jax_tree, port.model_cfg)
    assert list(port_tree) == quant.eligible_names(port.model_cfg)
    assert set(carried) == set(port_tree) and len(port_tree) == N_ELIGIBLE[name]
    assert not any("depthwise" in n or n.startswith("rnn") or "norm" in n for n in port_tree)
    assert all(quant.eligible(port.get_submodule(n)) for n in port_tree)
    skipped = {n for n, m in port.named_modules()
               if isinstance(m, (torch.nn.GRU, torch.nn.Conv1d))}
    assert skipped.isdisjoint(port_tree)
    if name in ("conformer", "crnn"):
        assert skipped  # the depthwise conv / the GRU exist and stay float


def test_quantized_weights_equal_jax(family):
    """w_q bit-equal, s_w and the bias equal, s_x within 1e-5 relative (the
    calibration forwards differ by float32 rounding: measured <= 1.1e-6)."""
    _, _, _, _, _, jax_tree, port, port_tree = family
    carried = quant_tree_from_jax(jax_tree, port.model_cfg)
    for n, entry in port_tree.items():
        assert entry["w_q"].dtype == torch.int8
        assert torch.equal(entry["w_q"], carried[n]["w_q"]), n
        assert torch.equal(entry["s_w"], carried[n]["s_w"]), n
        assert ("bias" in entry) == ("bias" in carried[n]), n
        if "bias" in entry:
            assert torch.equal(entry["bias"], carried[n]["bias"]), n
        np.testing.assert_allclose(float(entry["s_x"]), float(carried[n]["s_x"]), rtol=1e-5)


def test_quantized_forward_matches_jax(family, record_property):
    """The whole int8 forward with the JAX tree carried across. Where the
    float parts agree to float32 rounding so do the outputs (measured
    <= 2.4e-7); a float32 difference upstream can move an activation across
    an int8 rounding edge, which the CSPDarkNet's L2-normalised classifier
    input does (measured 0.0175 on logits of magnitude ~1.1): held to 0.05
    and argmax agreement >= 0.95, which is recorded."""
    name, model, variables, _, batches, jax_tree, port, _ = family
    want = np.asarray(jax.jit(lambda v, q, x: jq.quantized_apply(model, v, q, x))(
        variables, jax_tree, batches[0]))
    carried = quant_tree_from_jax(jax_tree, port.model_cfg)
    with torch.no_grad():
        got = quant.QuantizedModel(port, carried)(torch.from_numpy(batches[0])).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)
    if name in ("resnet_conformer", "conformer", "crnn", "cnn"):
        agree = float((got.argmax(2) == want.argmax(2)).mean())
        record_property("argmax_agreement", agree)
        assert agree >= 0.95


def test_quant_tree_from_jax_raises_on_an_unknown_or_missing_key(family):
    _, _, _, _, _, jax_tree, port, _ = family
    extra = {**jax_tree, "nowhere/Dense_9": next(iter(jax_tree.values()))}
    with pytest.raises(KeyError, match="does not know"):
        quant_tree_from_jax(extra, port.model_cfg)
    missing = dict(jax_tree)
    missing.pop(sorted(missing)[0])
    with pytest.raises(KeyError, match="has no"):
        quant_tree_from_jax(missing, port.model_cfg)


def test_calibration_needs_a_batch_and_a_built_model():
    cfg = pc.parse_overrides(pc.Config(), FAMILIES["crnn"])
    model = build_model(cfg.model, cfg.grid, device="cpu", seed=0)
    with pytest.raises(ValueError, match="at least one batch"):
        quant.calibrate_activation_scales(model, [])
    bare = build_model(cfg.model, cfg.grid, device="cpu", seed=0)
    del bare.model_cfg
    with pytest.raises(ValueError, match="build_model"):
        quant.quantize_model(bare, [np.zeros((1, 4, 4, 64), np.float32)])


# --- quantization-aware training --------------------------------------------------


@pytest.fixture(scope="module")
def qat_conformer():
    overrides = FAMILIES["conformer"] + ["model.compute_dtype=float32"]
    cfg = parse_overrides(Config(), overrides)
    model = build_jax_model(cfg.model, cfg.grid)
    variables = random_variables(model, jnp.zeros((B, T, 4, 64), jnp.float32), seed=2)
    x = np.random.default_rng(3).standard_normal((B, T, 4, 64)).astype(np.float32)
    weights = np.random.default_rng(4).standard_normal((B, T, 14, 648)).astype(np.float32)
    return model, variables, overrides, x, weights


def _port_qat_grads(port, x, weights, inside=True):
    """(output, {param name: grad}) of sum(out * weights) under qat();
    inside=False runs the backward after the context has closed."""
    port.zero_grad(set_to_none=True)
    with quant.qat():
        out = port(torch.from_numpy(x))
        loss = (out * torch.from_numpy(weights)).sum()
        if inside:
            loss.backward()
    if not inside:
        loss.backward()
    return out.detach().numpy(), {n: p.grad.clone() for n, p in port.named_parameters()}


def test_qat_forward_and_gradients_match_jax(qat_conformer):
    """The fake-quant forward and its straight-through gradients (eval mode,
    float32) against jax.grad of qat_apply. The live scales come from
    activations that agree to float32 rounding, so an element on an int8
    rounding edge may snap the other way: the forward within 1e-5 but for
    at most 0.1% of its elements, all within 2e-3 (measured 0.007%,
    8.5e-4); each parameter's gradient within 1e-4 of its largest magnitude
    (measured 3.1e-5), plus 1e-5 for gradients that are 0 in exact
    arithmetic (the key bias's, by the softmax's shift invariance: ~3e-6)."""
    model, variables, overrides, x, weights = qat_conformer

    def loss(params):
        out = jq.qat_apply(model, {**variables, "params": params}, x, train=False)
        return jnp.sum(out * weights), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    want_grads = state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, grads), "batch_stats": variables["batch_stats"]},
        pc.parse_overrides(pc.Config(), overrides).model)
    port = port_model(variables, overrides)
    got, got_grads = _port_qat_grads(port, x, weights)
    want = np.asarray(want)
    err = np.abs(got - want)
    assert (err > 1e-5 + 1e-5 * np.abs(want)).mean() <= 1e-3 and err.max() <= 2e-3
    # fake-quant moved the output: QAT is not the float forward
    with torch.no_grad():
        assert np.abs(port(torch.from_numpy(x)).numpy() - got).max() > 1e-2
    for n, g in got_grads.items():
        scale = float(want_grads[n].abs().max())
        assert float((g - want_grads[n]).abs().max()) <= 1e-4 * scale + 1e-5, n


def test_qat_remat_recomputes_under_fake_quant(qat_conformer):
    """With remat the recompute fake-quantizes as the forward did, even when
    the backward runs outside the qat() context: the gradients equal those
    of the model without remat, bit for bit."""
    _, variables, overrides, x, weights = qat_conformer
    plain = port_model(variables, overrides)
    remat = port_model(variables, overrides + ["model.remat=conformer"])
    _, want = _port_qat_grads(plain, x, weights, inside=False)
    _, got = _port_qat_grads(remat, x, weights, inside=False)
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_qat_under_a_mesh_of_more_than_one_rank_names_item_10(monkeypatch, tmp_path):
    class TwoRanks:
        world_size = 2

    cfg = pc.parse_overrides(pc.Config(), FAMILIES["crnn"])
    model = build_model(cfg.model, cfg.grid, device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        make_train_step(model, None, torch.optim.Adam(model.parameters()), 14,
                        mesh=TwoRanks(), qat=True)
    monkeypatch.setenv("WORLD_SIZE", "2")
    port_fails(["train", "--synthetic", "--device", "cpu", f"data.base_path={tmp_path}",
               "train.qat=true", *FAMILIES["crnn"]],
               NotImplementedError, "train.qat under a process mesh")
    assert not list(tmp_path.iterdir())


# --- the port's int8 paths ----------------------------------------------------------

TINY = ["model.crnn_cnn_channels=8,16", "model.conf_d_model=16", "model.conf_n_heads=2",
        "model.conf_n_layers=1", "model.compute_dtype=float32", "window.window_seconds=0.4",
        "window.hop_seconds=0.4", "train.batch_size=4", "train.num_epochs=1"]
MEL_IV = ["model.model_type=conformer", "features.feature_set=mel_iv"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A run directory with a seeded tiny mel_iv Conformer as its best
    checkpoint, its config, two clips written as WAVs and the clips."""
    base = tmp_path_factory.mktemp("torch_quant")
    cfg = pc.parse_overrides(pc.Config(), [*TINY, *MEL_IV, f"data.base_path={base}"])
    model = build_model(cfg.model, cfg.grid, device="cpu", seed=5,
                        in_channels=feature_channels(cfg.features.feature_set))
    save_checkpoint(base / "checkpoints" / "best" / "epoch_0001.pt", model, cfg, epoch=1,
                    meta={"epoch": 1, "train_loss": 1.0, "test_loss": 1.0})
    rng = np.random.default_rng(6)
    waves = [(0.2 * rng.standard_normal((4, int(SR * s)))).astype(np.float32)
             for s in (2.3, 1.1)]
    for i, w in enumerate(waves):
        write_wav(base / f"clip{i}.wav", w, SR)
    yield base, cfg, waves
    shutil.rmtree(base, ignore_errors=True)


def _ckpt(run_dir):
    return run_dir / "checkpoints" / "best" / "epoch_0001.pt"


def _predictor(run_dir, **kw):
    return SELDPredictor(_ckpt(run_dir), batch_windows=4, device="cpu", **kw)


def test_quantize_composes_with_tta_in_either_order_and_with_streaming(run):
    base, _, waves = run
    wave = waves[0]
    float_classes = _predictor(base).predict_waveform(wave).classes
    p = _predictor(base).quantize(calib_waves=waves)
    assert p.quantized and not p.int8_weight_only
    offline = p.predict_waveform(wave).classes
    assert (offline != float_classes).any()  # the int8 forward is not the float one
    assert (offline == float_classes).mean() > 0.9
    for overlap in (0.0, 0.5):
        chunks = [wave[:, i:i + 7000] for i in range(0, wave.shape[1], 7000)]
        np.testing.assert_array_equal(stream_predict(p, chunks, overlap=overlap).classes,
                                      p.predict_waveform(wave, overlap=overlap).classes)
    first = _predictor(base).quantize(calib_waves=waves).tta([0, 5, 10])
    then = _predictor(base).tta([0, 5, 10]).quantize(calib_waves=waves)
    np.testing.assert_array_equal(first.predict_waveform(wave).classes,
                                  then.predict_waveform(wave).classes)
    assert (first.predict_waveform(wave).classes
            != _predictor(base).tta([0, 5, 10]).predict_waveform(wave).classes).any()


def test_quantize_calibrates_on_whole_windows_and_features(run):
    """calib_waves are cut into their whole windows (a clip shorter than a
    window zero-padded to one), as the JAX predictor cuts them: the same
    scales as calib_mel of those windows."""
    base, _, waves = run
    p = _predictor(base)
    from seld_tpu_torch.data.corpus import compute_mel_features

    mels = []
    for w in waves:
        mel = compute_mel_features(w, p.cfg.features, "cpu")
        n = max(mel.shape[0] // p.win, 1)
        mel = torch.cat([mel, mel.new_zeros((max(n * p.win - mel.shape[0], 0),
                                             *mel.shape[1:]))])
        mels.append(mel[:n * p.win].reshape(n, p.win, *mel.shape[1:]).numpy())
    a = p.quantize(calib_waves=waves)._qmodel.quant_tree()
    b = _predictor(base).quantize(calib_mel=mels)._qmodel.quant_tree()
    assert all(torch.equal(a[n]["s_x"], b[n]["s_x"]) for n in a)
    wo = _predictor(base).quantize(calib_waves=waves, weight_only=True)
    assert wo.int8_weight_only and all("s_x" not in e for e in wo._qmodel.quant_tree().values())
    with pytest.raises(ValueError, match="needs calibration data"):
        _predictor(base).quantize()


@pytest.fixture(scope="module")
def corpus(run):
    return synthetic_corpus(run[1], n_files=1, seconds=3.0, seed=1, train=False,
                            event_rate_hz=3.0, device="cpu")


def test_evaluate_model_int8_and_weight_only(run, corpus):
    base, cfg, _ = run
    reports = {mode: evaluate_model(cfg, corpus, cfg.data.checkpoint_path, device="cpu",
                                    save_visualizations=False, **kw)
               for mode, kw in (("float", {}), ("int8", {"int8": True}),
                                ("weight_only", {"int8": True, "int8_weight_only": True}))}
    assert [r["quantized_int8"] for r in reports.values()] == [False, True, True]
    for r in reports.values():
        assert np.isfinite(r["test_loss"]) and "SELD_error" in r["dcase2022"]
    # the loss of the quantized logits: near the float one, not equal to it
    assert reports["int8"]["test_loss"] != reports["float"]["test_loss"]
    np.testing.assert_allclose(reports["int8"]["test_loss"], reports["float"]["test_loss"],
                               rtol=0.05)
    with pytest.raises(ValueError, match="requires int8"):
        evaluate_model(cfg, corpus, cfg.data.checkpoint_path, device="cpu",
                       int8_weight_only=True)


def test_int8_calibration_file_turns_int8_on_for_predict_and_export(run, corpus, tmp_path):
    """run_calibration(int8=True) records int8 in its file (weight-only
    too); `predict --calibration` then serves int8 (the CSV of --int8 with
    the file's knobs), `export --calibration` demands --int8-calib-wavs,
    and a weight-only file is refused by predict, which has no weight-only
    forward (the JAX package's rules, cli.py:165-184)."""
    base, cfg, _ = run
    out = tmp_path / "c.json"
    for weight_only in (True, False):
        calib = port_calibrate.run_calibration(
            cfg, corpus, cfg.data.checkpoint_path, int8=True, int8_weight_only=weight_only,
            bias_grid=[0.0, 1.0], median_widths=[1, 3], device="cpu")
        assert calib["int8"] is True and calib["int8_weight_only"] is weight_only
    port_calibrate.write_calibration(calib, out)
    assert port_calibrate.load_calibration(out) == json.loads(json.dumps(calib))
    wav = str(base / "clip0.wav")
    csv = {}
    for name, flags in (("file", ["--calibration", str(out)]),
                        ("flags", ["--int8", "--bg-bias", str(calib["bg_bias"]),
                                   "--median-filter", str(calib["median_filter"])])):
        assert port_main(["predict", "--checkpoint", str(_ckpt(base)), "--wavs", wav,
                          "--out", str(tmp_path / name), "--device", "cpu", *flags]) == 0
        csv[name] = (tmp_path / name / "predictions" / "clip0.csv").read_text()
    assert csv["file"] == csv["flags"]
    port_fails(["export", "--checkpoint", str(_ckpt(base)), "--out",
               str(tmp_path / "a.pt2"), "--calibration", str(out), "--device", "cpu"],
               ValueError, "tuned under int8 — pass --int8-calib-wavs")
    out.write_text(json.dumps({**calib, "int8_weight_only": True}))
    port_fails(["predict", "--checkpoint", str(_ckpt(base)), "--wavs", wav, "--out",
               str(tmp_path / "wo"), "--calibration", str(out), "--device", "cpu"],
               ValueError, "weight-only quantization, which this command")


def test_int8_artifacts_equal_the_predictors_int8_grid(run, tmp_path):
    """The int8 and the weight-only artifact (cli export --int8-calib-wavs)
    serve the predictor's int8 grids bit for bit, report .quantized from
    the sidecar, and the weight-only artifact is smaller on disk than the
    float one (tests/test_quant.py:308)."""
    base, _, waves = run
    calib = str(base / "clip1.wav")
    sizes = {}
    for mode, flags in (("float", []), ("int8", ["--int8-calib-wavs", calib]),
                        ("weight_only", ["--int8-calib-wavs", calib, "--int8-weight-only"])):
        art = tmp_path / f"{mode}.pt2"
        assert port_main(["export", "--checkpoint", str(_ckpt(base)), "--out", str(art),
                          "--batch-windows", "4", "--device", "cpu", *flags]) == 0
        sizes[mode] = art.stat().st_size
        served = SELDPredictor.from_artifact(art, device="cpu")
        assert served.quantized == (mode != "float")
        assert served.int8_weight_only == (mode == "weight_only")
        live = _predictor(base)
        if mode != "float":
            live.quantize(calib_waves=[load_wav(calib)[0]], weight_only=mode == "weight_only")
        for overlap in (0.0, 0.5):
            np.testing.assert_array_equal(served.predict_waveform(waves[0], overlap).classes,
                                          live.predict_waveform(waves[0], overlap).classes)
        if mode != "float":
            with pytest.raises(RuntimeError, match="cannot re-quantize"):
                served.quantize(calib_waves=waves)
    assert sizes["weight_only"] < sizes["float"] / 1.5, sizes


def test_served_int8_stream_equals_offline_int8(run):
    """`cli serve --int8-calib-wavs` serves one stream bit-equal to the
    offline int8 predict, and logs that it serves int8."""
    base, _, waves = run
    calib = str(base / "clip1.wav")
    rc, records = {}, []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("seld_tpu_torch")
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    t = threading.Thread(target=lambda: rc.setdefault("rc", port_main([
        "serve", "--checkpoint", str(_ckpt(base)), "--port", "0", "--max-streams", "1",
        "--int8-calib-wavs", calib, "--device", "cpu"])))
    try:
        t.start()
        port = None
        for _ in range(WAIT * 20):
            found = [re.search(r"Serving conformer on 127\.0\.0\.1:(\d+) \(int8",
                               r.getMessage()) for r in records]
            port = next((int(m.group(1)) for m in found if m), None)
            if port or not t.is_alive():
                break
            time.sleep(0.05)
        assert port, "no int8 Serving line"
        chunks = [waves[0][:, i:i + 6000] for i in range(0, waves[0].shape[1], 6000)]
        classes, _ = stream_client("127.0.0.1", port, chunks, timeout=WAIT)
        t.join(timeout=WAIT)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    assert not t.is_alive() and rc["rc"] == 0
    want = SELDPredictor(_ckpt(base), device="cpu").quantize(calib_waves=[load_wav(calib)[0]])
    np.testing.assert_array_equal(classes, want.predict_waveform(waves[0]).classes)


def test_cli_train_qat_on_the_cpu(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="seld_tpu_torch"):
        assert port_main(["train", "--synthetic", "--device", "cpu",
                          f"data.base_path={tmp_path}", "train.qat=true",
                          *[o for o in TINY if not o.startswith("window.hop")],
                          "window.hop_seconds=4.0", "model.model_type=conformer"]) == 0
    assert any("Quantization-aware training" in r.getMessage() for r in caplog.records)
    history = json.loads((tmp_path / "checkpoints" / "training_history.json").read_text())
    assert np.isfinite(history["best_train_loss"])
    assert list((tmp_path / "checkpoints" / "best").iterdir())


@pytest.mark.parametrize("argv,match", [
    (["eval", "--int8-weight-only"], "--int8-weight-only requires --int8"),
    (["calibrate", "--int8-weight-only"], "--int8-weight-only requires --int8"),
    (["export", "--out", "{tmp}/a.pt2", "--int8-weight-only"],
     "--int8-weight-only requires --int8-calib-wavs"),
    (["predict", "--wavs", "{base}/clip0.wav", "--artifact", "{tmp}/a.pt2", "--int8"],
     "--int8 does not compose with --artifact"),
    (["serve", "--artifact", "{tmp}/a.pt2", "--int8-calib-wavs", "{base}/clip0.wav"],
     "--int8-calib-wavs does not compose with --artifact"),
], ids=["eval", "calibrate", "export", "predict", "serve"])
def test_int8_flags_are_refused_as_jax_refuses_them(run, tmp_path, argv, match):
    base, _, _ = run
    argv = [a.format(tmp=tmp_path, base=base) for a in argv]
    port_fails([*argv, "--device", "cpu", "--synthetic" if argv[0] in ("eval", "calibrate")
               else f"data.base_path={base}", *TINY, *MEL_IV]
              + ([f"data.base_path={base}"] if argv[0] in ("eval", "calibrate") else []),
               ValueError, match)
    assert not (tmp_path / "a.pt2").exists()
