"""Serving export: a checkpoint -> a self-contained torch.export artifact
(counterpart: seld_tpu/export.py, `export_serving` and `load_serving`).

`export_serving` exports the predictor's two forwards with torch.export,
where the JAX package writes StableHLO, the trained weights inside:

    <out>        (batch_windows, window_frames, C_feat, n_mels) float32
                     -> (batch_windows, window_frames, n_cells) int8 class grid
    <out>.probs  the same input -> the float16 representation overlapped
                 windows average (softmax probabilities, ACCDOA vectors or
                 multi-ACCDOA votes)
    <out>.json   the sidecar: JAX's keys with their meanings, the full config
                 among them, so that `SELDPredictor.from_artifact` serves
                 every surface (predict, streaming, the daemon) from the
                 artifact alone.

With int8 calibration data (`int8_calib_waves` / `int8_calib_mel`) the
programs are the int8 post-training-quantized forwards
(seld_tpu_torch.quant): the int8 weights and their scales are buffers of
the program, the quantized layers' float weights are left out of it, and
the int8 products are `aten._int_mm` nodes (cuBLASLt's int8 GEMM on CUDA).
`int8_weight_only` keeps int8 weights dequantized to the compute dtype: a
smaller artifact with float products.

As in JAX, the programs start at features: the predictor computes them
before the program, through K1 ("mel") or K4 ("mel_iv", "mel_gcc"). At
windows of 512 frames and more on CUDA, each conformer block's attention
is K3's forward, recorded in the graph as the operator
`seld_tpu_torch::flash_attention_fwd`, which launches the kernel when the
program runs. A program holds the device type it was exported for
(`platforms` in the sidecar, one entry: JAX's `--platforms` has no torch
meaning, `--device` takes its place) and runs only there; nothing moves
it. Loading needs torch and the operator's registration in
seld_tpu_torch.ops.flash_attention, and no model code.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


class _Forward(torch.nn.Module):
    """One forward of a predictor as a module for torch.export: `net` (the
    model, or its QuantizedModel), whose weights the program lifts, the
    predictor's bias, then `head` on its output."""

    def __init__(self, predictor, net, head):
        super().__init__()
        self.net = net
        self.predictor = predictor
        self.head = head

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.head(self.predictor._biased(self.net(mel)))


def export_serving(checkpoint, out_path, batch_windows: int = 8, bg_bias: float = 0.0,
                   median_filter: int = 0, accdoa_threshold: float | None = None,
                   device: str | torch.device | None = None, int8_calib_waves=None,
                   int8_calib_mel=None, int8_weight_only: bool = False) -> Path:
    """Export the checkpoint's forwards for `device` (CUDA unless named);
    returns the artifact's path. bg_bias (grid models) and
    accdoa_threshold (ACCDOA models) bake into both programs;
    median_filter, a host-side post-op, is recorded in the sidecar for
    from_artifact to apply. int8_calib_waves ((C, N) float32 waveforms)
    and/or int8_calib_mel ((B, win, C, F) batches) export the int8 forwards
    (SELDPredictor.quantize), weight-only with int8_weight_only."""
    from seld_tpu_torch.config import config_to_dict
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.postprocess import validate_width
    from seld_tpu_torch.quant import QuantizedModel, without_float_weights

    p = SELDPredictor(checkpoint, batch_windows=batch_windows, bg_bias=bg_bias,
                      accdoa_threshold=accdoa_threshold, device=device)
    net = p.model
    if int8_calib_waves is not None or int8_calib_mel is not None:
        p.quantize(calib_waves=int8_calib_waves, calib_mel=int8_calib_mel,
                   weight_only=int8_weight_only)
        tree = p._qmodel.quant_tree()
        net = QuantizedModel(without_float_weights(p.model, tree), tree)
    cfg = p.cfg
    mel = torch.zeros((p.batch_windows, p.win,
                       feature_channels(cfg.features.feature_set, cfg.model.n_channels),
                       cfg.model.n_mels), device=p.device)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        for path, head in ((out_path, p._decode), (Path(f"{out_path}.probs"), p._rep)):
            program = torch.export.export(_Forward(p, net, head), (mel,))
            with open(path, "wb") as f:  # a file object: torch names no suffix then
                torch.export.save(program, f)
    sidecar = {
        "input_shape": list(mel.shape),
        "input_dtype": "float32",
        "output": "int8 argmax class grid (B, T, n_cells)",
        "n_el": cfg.grid.n_el,
        "n_az": cfg.grid.n_az,
        "num_classes": cfg.grid.num_classes,
        "model_type": cfg.model.model_type,
        "feature_set": cfg.features.feature_set,
        "window_frames": p.win,
        "batch_windows": p.batch_windows,
        "has_probs": True,
        "platforms": [p.device.type],
        "source_epoch": p.epoch,
        "quantized_int8": p.quantized,
        "int8_weight_only": p.int8_weight_only,
        "bg_bias": p.bg_bias,
        "accdoa_threshold": p.accdoa_threshold,
        "median_filter": validate_width(median_filter),
        "config": config_to_dict(cfg),
    }
    Path(f"{out_path}.json").write_text(json.dumps(sidecar, indent=2))
    logger.info("Exported %s (%s, epoch %d%s) -> %s (%.1f MB, platforms %s)",
                cfg.model.model_type, cfg.features.feature_set, p.epoch,
                ", int8 weight-only" if p.int8_weight_only else ", int8" if p.quantized
                else "", out_path, out_path.stat().st_size / 1e6, sidecar["platforms"])
    return out_path


def read_sidecar(path) -> dict:
    """The sidecar `<path>.json` of an artifact."""
    return json.loads(Path(f"{path}.json").read_text())


def load_program(path):
    """One exported program, callable on a feature batch on the device it
    was exported for."""
    import seld_tpu_torch.ops.flash_attention  # noqa: F401 (registers K3's operator)

    with open(path, "rb") as f:
        return torch.export.load(f).module()


def load_serving(path):
    """An artifact -> (callable(mel) -> int8 class grid, sidecar dict):
    torch and K3's operator, no model code, no checkpoint."""
    return load_program(path), read_sidecar(path)
