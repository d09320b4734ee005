"""Decode calibration: tune a model's decode knobs on a validation corpus
and write a calibration file that `predict` and `eval` take back with
--calibration (counterpart: seld_tpu/calibrate.py).

Two evaluation passes over the corpus:

  pass 1  sweeps the family's operating point, the background bias of a
          grid model or the activity threshold of an ACCDOA model, every
          candidate decoded on the device from one forward per batch;
  pass 2  fixes the best one and sweeps the median-filter width on the
          host, every width from one more forward per batch.

With tta_transforms both passes run the test-time-augmented decode
(seld_tpu_torch.tta), whose optimum differs from the plain decode's, and
the file says so ("tta", "tta_transforms"): `predict` and `eval
--calibration` then turn TTA on. With int8 both passes run the int8
forward (seld_tpu_torch.quant), and the file says so ("int8",
"int8_weight_only"): `predict` and `eval --calibration` then turn int8 on,
and `export --calibration` asks for --int8-calib-wavs. The file keeps the
JAX package's keys, so either package reads what the other wrote.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import torch

from seld_tpu_torch.config import Config
from seld_tpu_torch.eval.evaluate import evaluate_model
from seld_tpu_torch.models.registry import ACCDOA_MODELS
from seld_tpu_torch.train.checkpoint import load_checkpoint_config

logger = logging.getLogger(__name__)

CALIBRATION_VERSION = 1

# The JAX package's grids: biases that bracket the optima its studies saw,
# thresholds around the DCASE baseline's 0.5, widths 1 (off) to 7 frames.
DEFAULT_BIAS_GRID = (-1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 3.0)
DEFAULT_THRESHOLD_GRID = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7)
DEFAULT_MEDIAN_WIDTHS = (1, 3, 5, 7)

_METRIC_KEYS = ("ER", "F_macro", "LE_macro", "LR_macro", "SELD_error")


def run_calibration(cfg: Config, val_corpus, checkpoint_dir, *, tta_transforms=None,
                    int8: bool = False, int8_weight_only: bool = False,
                    bias_grid=None, threshold_grid=None, median_widths=None,
                    use_checkpoint: str = "best",
                    device: str | torch.device | None = None) -> dict:
    """The two passes on `device` (CUDA unless named); returns the
    calibration dict, not yet written. The knob family, model_type and
    feature_set follow the config stored in the checkpoint, which is what
    evaluate_model runs. tta_transforms: None calibrates the plain decode,
    a transform subset (seld_tpu_torch.tta.validate_transforms) the TTA
    decode."""
    stored = load_checkpoint_config(checkpoint_dir)
    eff_cfg = stored if stored is not None else cfg
    if eff_cfg.model.model_type in ACCDOA_MODELS:
        if bias_grid is not None:
            raise ValueError("bias_grid applies to grid models only — ACCDOA families "
                             "calibrate the activity threshold (threshold_grid)")
        knob = "accdoa_threshold"
        values = [float(t) for t in (threshold_grid or DEFAULT_THRESHOLD_GRID)]
    else:
        if threshold_grid is not None:
            raise ValueError("threshold_grid applies to ACCDOA families only — grid models "
                             "calibrate the background bias (bias_grid)")
        knob = "bg_bias"
        values = [float(b) for b in (bias_grid or DEFAULT_BIAS_GRID)]
    widths = [int(w) for w in (median_widths or DEFAULT_MEDIAN_WIDTHS)]
    common = dict(use_checkpoint=use_checkpoint, device=device, tta_transforms=tta_transforms,
                  int8=int8, int8_weight_only=int8_weight_only, num_visualizations=0,
                  save_visualizations=False)

    logger.info("Calibration pass 1/2: %s sweep over %s (tta=%s int8=%s)", knob, values,
                tta_transforms is not None, int8)
    r1 = evaluate_model(cfg, val_corpus, checkpoint_dir, **{f"{knob}_sweep": values}, **common)
    sweep_report = r1[f"{knob}_sweep"]
    best_knob = float(sweep_report["best"][knob])
    logger.info("Calibration pass 2/2: median-width sweep over %s at %s=%g",
                widths, knob, best_knob)
    r2 = evaluate_model(cfg, val_corpus, checkpoint_dir, **{knob: best_knob},
                        median_filter_sweep=widths, **common)
    mf_report = r2["median_filter_sweep"]
    best_w = int(mf_report["best"]["median_filter"])
    final = {k: float(mf_report["metrics"][str(best_w)][k]) for k in _METRIC_KEYS}
    calib = {
        "calibration_version": CALIBRATION_VERSION,
        "model_type": eff_cfg.model.model_type,
        "feature_set": eff_cfg.features.feature_set,
        "checkpoint": str(checkpoint_dir),
        "use_checkpoint": use_checkpoint,
        "tta": tta_transforms is not None,
        "tta_transforms": (None if tta_transforms is None
                           else [int(t) for t in tta_transforms]),
        "int8": bool(int8),
        "int8_weight_only": bool(int8_weight_only),
        knob: best_knob,
        "median_filter": best_w,
        "val_metrics": final,
        # the audit trail: both passes' tables
        "knob_sweep": {"knob": knob, **sweep_report},
        "median_sweep": mf_report,
    }
    logger.info("Calibrated decode: %s=%g median_filter=%d -> val SELD_error %.4f (ER %.3f "
                "F %.3f LE %.1f deg LR %.3f)", knob, best_knob, best_w, final["SELD_error"],
                final["ER"], final["F_macro"], final["LE_macro"], final["LR_macro"])
    return calib


def write_calibration(calib: dict, out_path) -> Path:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(calib, indent=2))
    logger.info("Calibration written: %s", out_path)
    return out_path


def load_calibration(path) -> dict:
    """A decode_calibration.json, checked: its version, its keys and exactly
    one operating-point knob."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"calibration file not found: {path}")
    calib = json.loads(path.read_text())
    version = calib.get("calibration_version")
    if version != CALIBRATION_VERSION:
        raise ValueError(f"{path}: calibration_version {version!r} not supported "
                         f"(expected {CALIBRATION_VERSION})")
    for key in ("model_type", "median_filter"):
        if key not in calib:
            raise ValueError(f"{path}: missing calibration key {key!r}")
    if ("bg_bias" in calib) == ("accdoa_threshold" in calib):
        raise ValueError(f"{path}: calibration must carry exactly one operating-point knob "
                         "(bg_bias for grid models, accdoa_threshold for ACCDOA)")
    return calib


def check_calibration_matches(calib: dict, cfg: Config) -> None:
    """Raise for a calibration made for another model_type or feature set:
    the knobs are operating points of one model on one feature set."""
    if calib["model_type"] != cfg.model.model_type:
        raise ValueError(f"calibration was made for model_type={calib['model_type']!r} but "
                         f"the config selects {cfg.model.model_type!r} — recalibrate")
    feat = calib.get("feature_set")
    if feat is not None and feat != cfg.features.feature_set:
        raise ValueError(f"calibration was made for feature_set={feat!r} but the config "
                         f"selects {cfg.features.feature_set!r} — recalibrate")
