"""Ground rules of the PyTorch port: it imports neither JAX nor seld_tpu,
its entry points refuse to run without a CUDA device unless the caller
asks for the CPU, kernels K1's and K4's wrappers check their input and take
the plain version only for CPU tensors, and attention has no unported case
and no library kernel behind it."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import seld_tpu_torch
from seld_tpu_torch.config import Config, FeatureConfig, ModelConfig
from seld_tpu_torch.data.corpus import compute_mel_features
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.models import build_model
from seld_tpu_torch.ops import mel_cuda
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|optax|orbax|ml_dtypes|seld_tpu(?!_torch))\b",
    re.M,
)


def test_import_leaves_jax_and_seld_tpu_out():
    # a fresh interpreter: this test process has imported JAX already
    probe = (
        "import sys, seld_tpu_torch, seld_tpu_torch.infer, seld_tpu_torch.cli, "
        "seld_tpu_torch.convert, seld_tpu_torch.train.trainer, "
        "seld_tpu_torch.data.synthetic, seld_tpu_torch.data.discovery, "
        "seld_tpu_torch.eval, seld_tpu_torch.eval.metrics, "
        "seld_tpu_torch.train.completion, seld_tpu_torch.ops.flash_attention, "
        "seld_tpu_torch.ops.spatial_cuda, seld_tpu_torch.features.acs, "
        "seld_tpu_torch.features.specaugment, seld_tpu_torch.targets.gaussian, "
        "seld_tpu_torch.data.cache, seld_tpu_torch.stream, seld_tpu_torch.tta, "
        "seld_tpu_torch.tools.average_ckpt, seld_tpu_torch.serve, seld_tpu_torch.export, "
        "seld_tpu_torch.ops.counters, seld_tpu_torch.viz, seld_tpu_torch.tools.replot, "
        "seld_tpu_torch.tools.augment_compare, seld_tpu_torch.quant, seld_tpu_torch.distill, "
        "seld_tpu_torch.train.optimizer, seld_tpu_torch.tools.torch_import\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_dtypes', 'seld_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_matplotlib_is_imported_only_to_draw():
    """Every entry point imports seld_tpu_torch.viz, and with it matplotlib,
    only where it draws a PNG: a machine without matplotlib trains, scores
    with --num-visualizations 0, predicts and serves."""
    probe = (
        "import sys, seld_tpu_torch.eval, seld_tpu_torch.train.trainer, seld_tpu_torch.cli, "
        "seld_tpu_torch.calibrate, seld_tpu_torch.tools.replot, "
        "seld_tpu_torch.tools.augment_compare, seld_tpu_torch.serve, seld_tpu_torch.export\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'matplotlib' "
        "or m == 'seld_tpu_torch.viz')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "seld_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
))
def test_no_source_imports_jax_or_seld_tpu(path):
    assert not FORBIDDEN.findall((ROOT / path).read_text())


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "seld_tpu_torch" / "ops").glob("*_cuda.py"),
                                       ROOT / "seld_tpu_torch" / "ops" / "flash_attention.py",
                                       ROOT / "seld_tpu_torch" / "ops" / "attention.py"]
))
def test_kernel_wrappers_have_no_try_around_a_launch(path):
    """A wrapper launches or raises: no handler that could fall back."""
    text = (ROOT / path).read_text()
    assert "_kernel" in text or "flash_attention" in text  # a wrapper or its dispatch
    # force_flash restores its ContextVar in a finally: the one handler allowed
    text = text.replace("""    try:
        yield
    finally:
        _FORCE.reset(token)""", "")
    assert not re.search(r"^\s*(try\s*:|except\b|finally\s*:)", text, re.M)


def test_attention_has_no_unported_length_left():
    """T >= 512 on CUDA runs K3: the dispatch raises NotImplementedError
    nowhere, and reaches K3's wrapper."""
    text = (ROOT / "seld_tpu_torch" / "ops" / "attention.py").read_text()
    assert "NotImplementedError" not in text and "not ported" not in text
    assert "flash_attention(q, k, v, scale=scale)" in text
    assert "FLASH_MIN_SEQ_LEN = 512" in text


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "seld_tpu_torch").rglob("*.py"),
                                       *(ROOT / "seld_tpu_torch").rglob("*.cu")]
))
def test_no_library_attention_in_the_port(path):
    """PyTorch's fused attention is the yardstick that chip_smoke.py times,
    never a path of the package; nor is torch.compile."""
    text = (ROOT / path).read_text()
    assert "scaled_dot_product_attention" not in text
    assert "torch.compile" not in text


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_needs_cuda_unless_cpu_is_named(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seld_tpu_torch.resolve_device()
    assert seld_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    missing = tmp_path / "absent.pt"  # the device check comes first
    with pytest.raises(RuntimeError, match="CUDA"):
        SELDPredictor(missing)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(ModelConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_mel_features(np.zeros((4, 4800), np.float32), FeatureConfig())
    port_fails(["predict", "--checkpoint", str(missing), "--wavs", "x.wav"], RuntimeError, "CUDA")


def test_evaluation_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from seld_tpu_torch.eval import evaluate_model

    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_model(Config(), None, tmp_path)
    port_fails(["eval", "--synthetic", f"data.base_path={tmp_path}"], RuntimeError, "CUDA")
    port_fails(["verify"], RuntimeError, "CUDA")
    assert not list(tmp_path.iterdir())  # the device check comes first


def test_training_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from seld_tpu_torch.data.corpus import build_corpus
    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.train.trainer import train_model

    cfg = Config()
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_corpus(cfg, n_files=1, seconds=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_corpus([], [], cfg.features, cfg.grid, cfg.window, cfg.targets)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_model(cfg, None, None, workdir=tmp_path)
    port_fails(["train", "--synthetic", f"data.base_path={tmp_path}"], RuntimeError, "CUDA")
    assert not list(tmp_path.iterdir())  # the device check comes first


def test_spatial_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from seld_tpu_torch.data.cache import cached_build_corpus

    cfg = Config()
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_mel_features(np.zeros((4, 4800), np.float32), FeatureConfig(feature_set="mel_iv"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cached_build_corpus([], [], cfg.features, cfg.grid, cfg.window, cfg.targets,
                            cache_dir=str(tmp_path / "cache"))
    assert not list(tmp_path.iterdir())  # the device check comes first


def test_k4_wrapper_refuses_other_devices():
    from seld_tpu_torch.ops.spatial_cuda import spatial_features

    with pytest.raises(ValueError, match="CUDA or CPU"):
        spatial_features(torch.zeros((4, 8, 960), device="meta"), "mel_iv")


def test_cpu_is_served_when_named(tmp_path):
    feats = compute_mel_features(np.zeros((4, 4800), np.float32), FeatureConfig(),
                                 device="cpu")
    assert feats.device.type == "cpu" and feats.shape == (11, 4, 64)


@pytest.mark.parametrize("dtype,inside", [("float32", False), ("bfloat16", True)])
def test_float32_forward_turns_tf32_off_for_its_own_call_only(monkeypatch, dtype, inside):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = ModelConfig(resnet_conf_d_model=32, resnet_conf_n_heads=2,
                      resnet_conf_n_layers=1, compute_dtype=dtype)
    model = build_model(cfg, device="cpu", seed=0)
    seen = []
    model.encoder.stem.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    with torch.inference_mode():
        model(torch.zeros((1, 4, 4, 64)))
    assert seen == [(inside, inside)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_unported_families_name_their_roadmap_item():
    """Every model_type of the JAX package builds, with float32 and with
    bf16 parameters: nothing of the models is left unported (no ROADMAP
    item 13 remains)."""
    for model_type in ("crnn", "conformer", "resnet_conformer", "cnn", "cspdarknet",
                       "accdoa_conformer", "multi_accdoa_conformer"):
        for param_dtype in ("float32", "bfloat16"):
            model = build_model(ModelConfig(model_type=model_type, param_dtype=param_dtype),
                                device="meta", seed=None)
            assert {p.dtype for p in model.parameters()} == {getattr(torch, param_dtype)}


@pytest.mark.parametrize("frames,err", [
    (torch.zeros((8, 960), dtype=torch.float64), TypeError),
    (torch.zeros((8, 1920))[:, ::2], ValueError),  # not contiguous
    (torch.zeros((8, 950)), ValueError),  # wrong width
    (torch.zeros((2, 2, 8, 960)), ValueError),  # wrong rank
])
def test_k1_wrapper_checks_cpu_input(frames, err):
    with pytest.raises(err):
        mel_cuda.log_mel_frames(frames)


def test_k1_wrapper_takes_plain_version_for_cpu_tensors(monkeypatch):
    calls = []
    plain = mel_cuda.log_mel_frames_reference

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(mel_cuda, "log_mel_frames_reference", spy)
    before = mel_cuda.log_mel_frames.launches
    out = mel_cuda.log_mel_frames(torch.zeros((5, 960)))
    # one block of CPU_BLOCK_FRAMES frames, the 5 given and zero rows
    assert calls == [(mel_cuda.CPU_BLOCK_FRAMES, 960)] and out.shape == (5, 64)
    assert mel_cuda.log_mel_frames.launches == before  # no kernel launched


def test_checkpoint_round_trip(tmp_path):
    from seld_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    cfg = Config()
    state = {"w": torch.arange(6.0).reshape(2, 3)}
    save_checkpoint(tmp_path / "c.pt", state, cfg, epoch=4)
    got_cfg, got_state, epoch = load_checkpoint(tmp_path / "c.pt")
    assert got_cfg == cfg and epoch == 4
    torch.testing.assert_close(got_state["w"], state["w"])
