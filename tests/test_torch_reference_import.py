"""Checkpoints of the reference PyTorch pipeline into the port
(seld_tpu_torch.tools.torch_import and `cli import-torch`) on the CPU.

The reference repository is not here, so its state_dicts are made: random
seld_tpu variables (shapes from jax.eval_shape) are put into the
reference's layout by chip_smoke.reference_state_dict, the inverse of the
converter under the key names it reads. Such a dict then goes the JAX
package's way (seld_tpu.tools.torch_import, then the port's
state_dict_from_jax) and the port's way (import_state_dict), and the two
must give the same tensors exactly, for the four backbones the reference
has; both must also give back the variables it was made from. Then `cli
import-torch` of a tiny CRNN's .pth, as a bare state_dict and as the
reference trainer's dict with its pickled Config, and `cli predict` from
the imported checkpoint."""

import shutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import reference_state_dict
from seld_tpu.config import Config, parse_overrides
from seld_tpu.models import build_model
from seld_tpu.tools.torch_import import convert_torch_state_dict as jax_convert
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.data.audio import write_wav
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.tools.torch_import import import_state_dict
from seld_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_backbones import random_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails

# the JAX converter reads four CNN blocks (seld_tpu/tools/torch_import.py:104)
BACKBONES = {  # model type: (overrides, the JAX converter's keyword arguments)
    "crnn": (["model.model_type=crnn", "model.crnn_cnn_channels=4,4,8,8",
              "model.crnn_rnn_hidden=8", "model.crnn_rnn_layers=2"],
             dict(rnn_layers=2, num_classes=14)),
    "conformer": (["model.model_type=conformer", "model.crnn_cnn_channels=4,4,8,8",
                   "model.conf_d_model=16", "model.conf_n_heads=2", "model.conf_n_layers=1"],
                  dict(n_layers=1, num_classes=14)),
    "resnet_conformer": (["model.resnet_conf_d_model=16", "model.resnet_conf_n_heads=2",
                          "model.resnet_conf_n_layers=1"], dict(n_layers=1, num_classes=14)),
    "cnn": (["model.model_type=cnn"], {}),  # CSPDarkNet at its small default widths
}


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out.update(_flat(value, path) if isinstance(value, dict) else {path: np.asarray(value)})
    return out


def reference_of(overrides, seed=0):
    """(random seld_tpu variables, the reference-layout state_dict of them,
    the port's config) of the model that `overrides` describe."""
    cfg = parse_overrides(Config(), overrides)
    x0 = jnp.zeros((1, 8, 4, 64), jnp.float32)
    variables = random_variables(build_model(cfg.model, cfg.grid), x0, seed)
    variables = {k: dict(v) for k, v in variables.items()}
    pcfg = pc.parse_overrides(pc.Config(), overrides)
    ref = reference_state_dict(_flat(variables), pcfg.model, pcfg.grid.num_classes)
    return variables, ref, pcfg


@pytest.mark.parametrize("model_type", sorted(BACKBONES))
def test_the_port_s_route_equals_jax_s_exactly(model_type):
    overrides, kwargs = BACKBONES[model_type]
    variables, ref, pcfg = reference_of(overrides)
    assert any(k.endswith("num_batches_tracked") for k in ref)  # ignored on both ways
    via_jax = state_dict_from_jax(jax_convert(ref, model_type, **kwargs), pcfg.model)
    port = import_state_dict(ref, pcfg.model, pcfg.grid.num_classes)
    direct = state_dict_from_jax(variables, pcfg.model)  # the variables it was made from
    assert port.keys() == via_jax.keys() == direct.keys()
    for key, value in port.items():
        assert value.dtype == torch.float32
        assert torch.equal(value, via_jax[key]), key
        assert torch.equal(value, direct[key]), key


def test_a_missing_or_unused_key_raises():
    _, ref, pcfg = reference_of(BACKBONES["crnn"][0])
    with pytest.raises(KeyError, match="rnn.bias_hh_l1_reverse.* is this a crnn checkpoint"):
        import_state_dict({k: v for k, v in ref.items() if k != "rnn.bias_hh_l1_reverse"},
                          pcfg.model)
    with pytest.raises(ValueError, match=r"unconverted torch keys: \['extra.weight'\]"):
        import_state_dict({**ref, "extra.weight": np.zeros(3, np.float32)}, pcfg.model)
    with pytest.raises(NotImplementedError, match="accdoa_conformer"):
        import_state_dict(ref, pcfg.model.__class__(model_type="accdoa_conformer"))


TINY_CRNN = ["model.model_type=crnn", "model.crnn_cnn_channels=8,16", "model.crnn_rnn_hidden=16",
             "model.crnn_rnn_layers=1", "model.compute_dtype=float32",
             "window.window_seconds=1.0", "window.hop_seconds=1.0"]


def _reference_trainer_file(path, state_dict):
    """The reference trainer's checkpoint: its dict with the Config instance
    of its module `config` pickled inside (which weights_only refuses)."""
    module = types.ModuleType("config")

    class RefConfig:
        pass

    RefConfig.__name__ = RefConfig.__qualname__ = "Config"
    RefConfig.__module__ = "config"
    module.Config = RefConfig
    saved = sys.modules.get("config")
    sys.modules["config"] = module
    try:
        cfg = RefConfig()
        cfg.batch_size, cfg.lr = 16, 1e-3
        torch.save({"epoch": 7, "model_state_dict": state_dict, "optimizer_state_dict": {},
                    "train_loss": 0.75, "test_loss": 0.5, "config": cfg}, path)
    finally:
        if saved is None:
            del sys.modules["config"]
        else:
            sys.modules["config"] = saved


def test_cli_import_torch_then_predict(tmp_path):
    variables, ref, pcfg = reference_of(TINY_CRNN, seed=3)
    want = import_state_dict(ref, pcfg.model, pcfg.grid.num_classes)
    tensors = {k: torch.from_numpy(v) for k, v in ref.items()}
    torch.save(tensors, tmp_path / "bare.pth")
    _reference_trainer_file(tmp_path / "trainer.pth", tensors)
    saved = sys.modules.get("config")
    try:
        for name, epoch, test_loss in (("bare", 1, float("inf")), ("trainer", 7, 0.5)):
            run = tmp_path / name
            assert port_main(["import-torch", "--torch-checkpoint", str(tmp_path / f"{name}.pth"),
                              "--device", "cpu", "--synthetic", *TINY_CRNN,
                              f"data.base_path={run}"]) == 0
            (best,) = (run / "checkpoints" / "best").glob("*.pt")
            assert best.name == f"epoch_{epoch:04d}.pt"
            cfg, state, got_epoch = load_checkpoint(best)
            assert cfg.model == pcfg.model and got_epoch == epoch
            assert state.keys() == want.keys()
            assert all(torch.equal(state[k], want[k]) for k in want)
            blob = torch.load(best, weights_only=True)
            assert blob["meta"]["test_loss"] == test_loss and blob["optimizer"]["state"] == {}
    finally:  # the unpickler's stand-in module of the reference's Config
        if saved is None:
            sys.modules.pop("config", None)
        else:
            sys.modules["config"] = saved

    # predict from the imported checkpoint: the grid of the same weights
    # saved by the port itself
    wave = (0.1 * np.random.default_rng(0).standard_normal((4, 3 * 24_000))).astype(np.float32)
    write_wav(tmp_path / "clip.wav", wave, 24_000)
    assert port_main(["predict", "--checkpoint", str(best), "--wavs", str(tmp_path / "clip.wav"),
                      "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert (tmp_path / "out" / "predictions" / "clip.csv").exists()
    save_checkpoint(tmp_path / "direct.pt", state_dict_from_jax(variables, pcfg.model), pcfg)
    grids = [SELDPredictor(p, device="cpu").predict_file(tmp_path / "clip.wav").classes
             for p in (best, tmp_path / "direct.pt")]
    np.testing.assert_array_equal(*grids)
    # a model the reference does not have, and a file of another model
    port_fails(["import-torch", "--torch-checkpoint", str(tmp_path / "bare.pth"), "--device",
                "cpu", "model.model_type=accdoa_conformer", f"data.base_path={tmp_path / 'x'}"],
               NotImplementedError, "no reference-checkpoint converter")
    port_fails(["import-torch", "--torch-checkpoint", str(tmp_path / "bare.pth"), "--device",
                "cpu", "model.model_type=conformer", f"data.base_path={tmp_path / 'y'}"],
               KeyError, "is this a conformer checkpoint")
    shutil.rmtree(tmp_path)
