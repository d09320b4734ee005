"""Serving: WAV in -> per-frame grid predictions + event rows
(counterpart: seld_tpu/infer.py, `Prediction`, `SELDPredictor` and
`validate_accdoa_threshold`).

A predictor loads a checkpoint once (the architecture and the feature
set come from the config stored in it), computes features on the device
(log-mel through K1, "mel_iv" / "mel_gcc" through K4), runs the
eval-mode model over fixed-shape batches of windows, and decodes its
output on the device into a (T, G) class grid, which `Prediction` turns
into STARSS22-style metadata rows: grid logits by argmax, ACCDOA and
multi-ACCDOA vectors by their activity threshold (seld_tpu_torch.accdoa).
`SELDPredictor.tta` swaps in the test-time-augmented forwards
(seld_tpu_torch.tta); `predict_file(stream=True)` feeds the clip through a
StreamingSession (seld_tpu_torch.stream), bit-equal to the offline path;
`SELDPredictor.from_artifact` serves an artifact of seld_tpu_torch.export
in place of a checkpoint; `dispatch` is the serving daemon's hook for
batching windows across streams (seld_tpu_torch.serve).
`SELDPredictor.quantize` switches the forwards to int8 post-training
quantization (seld_tpu_torch.quant), under every one of those surfaces.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from seld_tpu_torch import resolve_device
from seld_tpu_torch.accdoa import (
    decode_accdoa_to_grid,
    decode_multi_accdoa_to_grid,
    decode_vote_grid,
    multi_accdoa_class_activity,
)
from seld_tpu_torch.data.audio import load_wav
from seld_tpu_torch.data.corpus import compute_mel_features
from seld_tpu_torch.features.spatial import feature_channels
from seld_tpu_torch.grid import cell_centers
from seld_tpu_torch.models import build_model
from seld_tpu_torch.models.registry import ACCDOA_MODELS, MULTI_ACCDOA_MODELS
from seld_tpu_torch.postprocess import smooth_classes, validate_width
from seld_tpu_torch.train.checkpoint import load_checkpoint

logger = logging.getLogger(__name__)


def bias_background_logits(out: torch.Tensor, bias) -> torch.Tensor:
    """Class-major (B, T, M, G) grid logits with the background class's
    (last) row reduced by `bias`, as a new tensor: the one encoding of the
    decode bias, which the predictor, TTA and evaluation all call."""
    out = out.clone()
    out[:, :, -1, :] -= bias
    return out


def validate_accdoa_threshold(threshold, accdoa_mode: bool) -> float:
    """The one check of the ACCDOA activity threshold (the predictor and
    evaluation call it): None means the DCASE2022 baseline's 0.5; a value
    needs an ACCDOA family and must be >= 0 (norms are non-negative)."""
    if threshold is None:
        return 0.5
    if not accdoa_mode:
        raise ValueError("accdoa_threshold applies to ACCDOA / multi-ACCDOA models only — "
                         "grid models tune their operating point with bg_bias")
    threshold = float(threshold)
    if threshold < 0:
        raise ValueError(f"accdoa_threshold must be >= 0, got {threshold}")
    return threshold


@dataclass
class Prediction:
    """Per-frame grid predictions for one clip."""

    classes: np.ndarray  # (T, G) int8 argmax class per cell
    n_el: int
    n_az: int
    num_classes: int

    @property
    def background_class(self) -> int:
        return self.num_classes - 1

    def events(self) -> list[tuple[int, int, int, int]]:
        """Active cells as (frame_20ms, class, azimuth_deg, elevation_deg)
        at grid-cell-centre resolution."""
        el, az = cell_centers(self.n_el, self.n_az)
        t_idx, cell_idx = np.nonzero(self.classes != self.background_class)
        out = []
        for t, c in zip(t_idx, cell_idx):
            i, j = divmod(int(c), self.n_az)
            out.append(
                (int(t), int(self.classes[t, c]), int(round(az[j])), int(round(el[i])))
            )
        return out

    def to_metadata_rows(self, min_votes: int = 3) -> np.ndarray:
        """Collapse 20 ms frames to 100 ms STARSS22 metadata rows
        (frame, class, source=0, azimuth, elevation): a (class, cell) is
        emitted for a metadata frame when it is active in >= min_votes of
        the frame's 5 label frames."""
        t, g = self.classes.shape
        fanout = 5
        n_meta = t // fanout
        el, az = cell_centers(self.n_el, self.n_az)
        rows = []
        cls = self.classes[: n_meta * fanout].reshape(n_meta, fanout, g)
        for mf in range(n_meta):
            block = cls[mf]  # (5, G)
            for c in range(g):
                vals, counts = np.unique(block[:, c], return_counts=True)
                for v, n in zip(vals, counts):
                    if v != self.background_class and n >= min_votes:
                        i, j = divmod(c, self.n_az)
                        rows.append(
                            (mf, int(v), 0, int(round(az[j])), int(round(el[i])))
                        )
        return np.asarray(rows, np.int64).reshape(-1, 5)


class SELDPredictor:
    """A checkpoint's predictor (or an artifact's: from_artifact); `kind`
    is "grid", "accdoa" or "multi_accdoa", after the model_type."""

    def __init__(self, checkpoint, batch_windows: int = 8, bg_bias: float = 0.0,
                 median_filter: int = 0, accdoa_threshold: float | None = None,
                 device: str | torch.device | None = None):
        """checkpoint: a file written by train.checkpoint.save_checkpoint.

        batch_windows: windows per model call; every call, the last one
        included, is zero-padded to this batch so the model always runs
        at one shape.

        bg_bias: background-logit decode bias (grid models): the background
        class's logit is reduced by this amount before every argmax or
        softmax.

        median_filter: odd temporal window (frames) of majority smoothing
        on the decoded class grid; 0 disables it.

        accdoa_threshold: the vector-norm activity threshold of ACCDOA and
        multi-ACCDOA decodes (None: 0.5), the ACCDOA counterpart of bg_bias,
        tuned with `eval --accdoa-threshold-sweep`.

        device: CUDA unless named; no CUDA device raises."""
        self.device = resolve_device(device)
        self.cfg, state, self.epoch = load_checkpoint(checkpoint)
        self.model = build_model(
            self.cfg.model, self.cfg.grid, device=self.device, seed=None,
            in_channels=feature_channels(self.cfg.features.feature_set,
                                         self.cfg.model.n_channels),
        )
        self.model.load_state_dict(state)
        self.batch_windows = int(batch_windows)
        self.win = self.cfg.window.window_frames(self.cfg.features)
        model_type = self.cfg.model.model_type
        self.accdoa_mode = model_type in ACCDOA_MODELS
        self.kind = ("multi_accdoa" if model_type in MULTI_ACCDOA_MODELS
                     else "accdoa" if self.accdoa_mode else "grid")
        self.bg_bias = float(bg_bias)
        if self.bg_bias and self.accdoa_mode:
            raise ValueError("bg_bias applies to grid models only — ACCDOA decodes have no "
                             "background logit")
        self.accdoa_threshold = validate_accdoa_threshold(accdoa_threshold, self.accdoa_mode)
        self.median_filter = validate_width(median_filter)
        self._tta_transforms = None
        self._tta_fold = 1
        self._qmodel = None  # quant.QuantizedModel after quantize()
        self.quantized = self.int8_weight_only = False
        # cross-stream window dispatcher (seld_tpu_torch.serve.WindowBatcher):
        # when set, _batched hands it the rows
        self.dispatch = None
        logger.info("Predictor: %s from epoch %d on %s",
                    self.cfg.model.model_type, self.epoch, self.device)

    @classmethod
    def from_artifact(cls, artifact, device: str | torch.device | None = None
                      ) -> "SELDPredictor":
        """A predictor from an `export_serving` artifact alone (no checkpoint,
        no model code): config, window, batch, output kind, bias, threshold
        and median width come from the sidecar `<artifact>.json`, and the two
        forwards are the exported programs `<artifact>` and
        `<artifact>.probs`. Every serving surface works as with a
        checkpoint (predict_waveform, predict_file, streaming, the daemon);
        `tta()` raises, as the programs are the plain forwards. An artifact
        runs only on the device type it was exported for: another raises,
        naming both; device None means CUDA, as everywhere."""
        from seld_tpu_torch.config import config_from_dict
        from seld_tpu_torch.export import load_program, read_sidecar

        device = resolve_device(device)
        sidecar = read_sidecar(artifact)
        if sidecar["platforms"] != [device.type]:
            raise ValueError(
                f"{artifact} was exported for {sidecar['platforms']} and cannot run on "
                f"{device.type}: export it again with --device {device.type}")
        self = cls.__new__(cls)
        self.device = device
        self.cfg = config_from_dict(sidecar["config"])
        self.epoch = int(sidecar["source_epoch"])
        self.model = None
        self.batch_windows = int(sidecar["batch_windows"])
        self.win = int(sidecar["window_frames"])
        model_type = sidecar["model_type"]
        self.accdoa_mode = model_type in ACCDOA_MODELS
        self.kind = ("multi_accdoa" if model_type in MULTI_ACCDOA_MODELS
                     else "accdoa" if self.accdoa_mode else "grid")
        self.bg_bias = float(sidecar["bg_bias"])  # baked into both programs
        # baked into the programs too; single-ACCDOA's overlap decode reads it
        self.accdoa_threshold = float(sidecar["accdoa_threshold"])
        self.median_filter = validate_width(sidecar["median_filter"])
        self._tta_transforms = None
        self._tta_fold = 1
        self._qmodel = None
        # int8 is baked into the programs at export time
        self.quantized = bool(sidecar["quantized_int8"])
        self.int8_weight_only = bool(sidecar["int8_weight_only"])
        self.dispatch = None
        self._forward = torch.inference_mode()(load_program(artifact))
        self._forward_probs = torch.inference_mode()(load_program(f"{artifact}.probs"))
        logger.info("Predictor: %s from artifact %s (epoch %d) on %s", model_type, artifact,
                    self.epoch, device)
        return self

    def _raw(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, win, C, F) -> the model's float32 output (int8 after
        quantize()): (B, win, M, G) logits with the background class reduced
        by bg_bias, or ACCDOA vectors. The undecorated bodies (_biased,
        _decode, _rep) are what seld_tpu_torch.export traces."""
        return self._biased((self.model if self._qmodel is None else self._qmodel)(mel))

    def _biased(self, out: torch.Tensor) -> torch.Tensor:
        return bias_background_logits(out, self.bg_bias) if self.bg_bias else out

    def _decode(self, out: torch.Tensor) -> torch.Tensor:
        """The model's output -> (B, win, G) int8 class per cell."""
        grid = self.cfg.grid
        if self.kind == "grid":
            return torch.argmax(out, dim=2).to(torch.int8)
        decode = decode_multi_accdoa_to_grid if self.kind == "multi_accdoa" else \
            decode_accdoa_to_grid
        return decode(out, grid.n_el, grid.n_az, grid.num_classes, self.accdoa_threshold)

    @torch.inference_mode()
    def _raw_apply(self, mel: torch.Tensor) -> torch.Tensor:
        return self._raw(mel)

    @torch.inference_mode()
    def _forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, win, C, F) -> (B, win, G) int8 class per cell."""
        return self._decode(self._raw(mel))

    @torch.inference_mode()
    def _forward_probs(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, win, C, F) -> the float16 representation overlapped windows
        average (_rep)."""
        return self._rep(self._raw(mel))

    def _rep(self, out: torch.Tensor) -> torch.Tensor:
        """The model's output -> its averageable per-frame representation,
        float16: (B, win, M, G) softmax probabilities (grid), the (B, win,
        C, 3) vectors (single-ACCDOA: a mean vector shrinks where windows
        disagree), or the (B, win, C, G) {0, 1} class-activity map
        (multi-ACCDOA: the track order is arbitrary per forward, the map
        is not)."""
        if self.kind == "grid":
            return torch.softmax(out, dim=2).to(torch.float16)
        if self.kind == "multi_accdoa":
            grid = self.cfg.grid
            out = multi_accdoa_class_activity(out, grid.n_el, grid.n_az, self.accdoa_threshold)
        return out.to(torch.float16)

    @torch.inference_mode()
    def _decode_avg(self, avg: torch.Tensor) -> np.ndarray:
        """The coverage-averaged representation (T, ...) float32 -> (T, G)
        int8 class grid, decoded on the device."""
        grid = self.cfg.grid
        if self.kind == "grid":
            classes = torch.argmax(avg, dim=1).to(torch.int8)
        elif self.kind == "multi_accdoa":
            classes = decode_vote_grid(avg, grid.num_classes)
        else:
            classes = decode_accdoa_to_grid(avg, grid.n_el, grid.n_az, grid.num_classes,
                                            self.accdoa_threshold)
        return classes.cpu().numpy()

    def tta(self, transforms=None, fold: int = 1) -> "SELDPredictor":
        """Serve with ACS test-time augmentation (seld_tpu_torch.tta): every
        window is predicted under each selected FOA scene transform (None:
        all 16), each output mapped back with the exact inverse and the
        views averaged: mean probabilities (grid, decoded by argmax), mean
        vectors (single-ACCDOA, thresholded), or class-activity votes
        (multi-ACCDOA, decode_vote_grid). `fold` views share one forward's
        batch. Needs features.feature_set "mel_iv". Replaces the plain and
        the overlap forwards, so streaming and overlap run under TTA too,
        bit-equal to offline at one fold. Costs len(transforms) forwards a
        batch."""
        from seld_tpu_torch.tta import make_tta_forward, validate_transforms

        if self.model is None:
            raise RuntimeError("an artifact serves the plain forward it was exported with: "
                               "TTA needs the checkpoint (SELDPredictor(checkpoint).tta())")
        sel = validate_transforms(transforms)
        grid = self.cfg.grid
        tta_fwd = make_tta_forward(self._raw_apply, grid.n_el, grid.n_az,
                                   self.cfg.features.feature_set, transforms=sel,
                                   kind=self.kind, activity_threshold=self.accdoa_threshold,
                                   fold=fold)

        @torch.inference_mode()
        def forward_tta(mel: torch.Tensor) -> torch.Tensor:
            avg = tta_fwd(mel)
            if self.kind == "multi_accdoa":
                return decode_vote_grid(avg, grid.num_classes)
            if self.kind == "accdoa":
                return decode_accdoa_to_grid(avg, grid.n_el, grid.n_az, grid.num_classes,
                                             self.accdoa_threshold)
            return torch.argmax(avg, dim=2).to(torch.int8)

        @torch.inference_mode()
        def forward_probs_tta(mel: torch.Tensor) -> torch.Tensor:
            # the TTA average is each kind's averageable representation
            return tta_fwd(mel).to(torch.float16)

        self._forward = forward_tta
        self._forward_probs = forward_probs_tta
        self._tta_transforms = sel
        self._tta_fold = int(fold)
        logger.info("Predictor: TTA enabled (%d transforms, fold %d%s)", len(sel), fold,
                    ", int8" if self.quantized else "")
        return self

    def quantize(self, calib_waves=None, calib_mel=None,
                 weight_only: bool = False) -> "SELDPredictor":
        """Serve int8 post-training-quantized (seld_tpu_torch.quant): the
        trunk convolutions, the dense layers and the head run int8 x int8 ->
        int32 products (cuBLASLt's int8 GEMM on the card), with activation
        scales calibrated on `calib_waves` (raw (C, N) float32 waveforms,
        each cut into its whole windows, a clip shorter than one window
        zero-padded to one) and/or `calib_mel` ((B, win, C, F) feature
        batches). weight_only=True keeps int8 weights and computes in the
        compute dtype. Every forward reads the quantized model at call
        time, so quantize() composes with tta() in either order, with
        streaming and with the daemon's dispatch; the windows keep their
        offline batch slots, so streamed int8 grids equal offline ones."""
        if self.model is None:
            raise RuntimeError("artifact-backed predictors cannot re-quantize: int8 is baked "
                               "at export time (export --int8-calib-wavs)")
        from seld_tpu_torch.quant import QuantizedModel, quantize_model

        batches = []
        for wave in calib_waves if calib_waves is not None else ():
            mel = compute_mel_features(np.asarray(wave, np.float32), self.cfg.features,
                                       self.device)
            n = max(mel.shape[0] // self.win, 1)
            pad = n * self.win - mel.shape[0]
            if pad > 0:
                mel = torch.cat([mel, mel.new_zeros((pad, *mel.shape[1:]))])
            batches.append(mel[:n * self.win].reshape(n, self.win, *mel.shape[1:]))
        if calib_mel is not None:
            batches.extend(torch.as_tensor(np.asarray(b, np.float32)) for b in calib_mel)
        if not batches:
            raise ValueError("int8 quantization needs calibration data: pass calib_waves "
                             "and/or calib_mel")
        tree = quantize_model(self.model, batches, weight_only=weight_only)
        self._qmodel = QuantizedModel(self.model, tree)
        self.quantized, self.int8_weight_only = True, bool(weight_only)
        logger.info("Predictor: int8 PTQ enabled (%d quantized layers, %d calibration "
                    "batches%s)", len(tree), len(batches),
                    ", weight-only" if weight_only else "")
        return self

    def _batched(self, windows: torch.Tensor, fn, lead: int = 0):
        """Run fn over batch_windows-sized batches of windows, the first
        window in batch slot `lead` (a stream's windows take the slots they
        take offline), zeros in the slots before it and after the last, and
        yield the windows' rows of each result; with a dispatcher set, hand
        it the windows and their first slot."""
        if self.dispatch is not None and windows.shape[0] > 0:
            yield self.dispatch(fn, windows, lead)
            return
        if lead:
            windows = torch.cat([windows.new_zeros((lead, *windows.shape[1:])), windows])
        bw = self.batch_windows
        for start in range(0, windows.shape[0], bw):
            chunk = windows[start:start + bw]
            n_valid = chunk.shape[0]
            if n_valid < bw:
                chunk = torch.cat([chunk, chunk.new_zeros((bw - n_valid, *chunk.shape[1:]))])
            yield fn(chunk)[lead if start == 0 else 0:n_valid]

    def _smooth(self, classes: np.ndarray) -> np.ndarray:
        if self.median_filter <= 1:
            return classes
        return smooth_classes(classes, self.median_filter, self.cfg.grid.num_classes)

    def _prediction(self, classes: np.ndarray) -> Prediction:
        grid = self.cfg.grid
        return Prediction(classes=self._smooth(classes), n_el=grid.n_el,
                          n_az=grid.n_az, num_classes=grid.num_classes)

    def predict_waveform(self, wave, overlap: float = 0.0) -> Prediction:
        """wave: float32 (C, N) at the configured sample rate.

        overlap=0 tiles non-overlapping windows and decodes each. overlap in
        (0, 1) strides windows at hop = win * (1 - overlap), averages the
        representation of _rep over each frame's coverage in
        float32 on the device, and decodes the average."""
        if not 0.0 <= overlap < 1.0:
            raise ValueError(f"overlap must be in [0, 1), got {overlap}")
        mel = compute_mel_features(wave, self.cfg.features, self.device)  # (T, C, F)
        if overlap > 0.0:
            return self._prediction(self._decode_avg(self._average_probs(mel, overlap)))
        t_total = mel.shape[0]
        win = self.win
        n_windows = -(-t_total // win)
        pad_t = n_windows * win - t_total
        if pad_t:
            mel = torch.cat([mel, mel.new_zeros((pad_t, *mel.shape[1:]))])
        windows = mel.reshape(n_windows, win, *mel.shape[1:])
        classes = torch.cat(list(self._batched(windows, self._forward)))
        classes = classes.reshape(n_windows * win, -1)[:t_total]
        return self._prediction(classes.cpu().numpy())

    def _average_probs(self, mel: torch.Tensor, overlap: float) -> torch.Tensor:
        """(T, C, F) features -> (T, ...) float32 representation (class
        probabilities, ACCDOA vectors or class-activity votes) averaged over
        the windows that cover each frame, windows strided at
        hop = win * (1 - overlap) plus one window covering the tail."""
        t_total = mel.shape[0]
        win = self.win
        hop = max(int(win * (1.0 - overlap)), 1)
        starts = list(range(0, max(t_total - win, 0) + 1, hop))
        if starts[-1] + win < t_total:  # cover the tail
            starts.append(max(t_total - win, 0))
        pad_t = starts[-1] + win - t_total
        if pad_t > 0:
            mel = torch.cat([mel, mel.new_zeros((pad_t, *mel.shape[1:]))])
        windows = torch.stack([mel[s:s + win] for s in starts])

        prob_sum = count = None
        row = 0
        for probs in self._batched(windows, self._forward_probs):
            if prob_sum is None:
                total = t_total + max(pad_t, 0)
                prob_sum = torch.zeros((total, *probs.shape[2:]), device=self.device)
                count = torch.zeros((total, *(1,) * (probs.dim() - 2)), device=self.device)
            for p in probs:  # (win, M, G), accumulated in window order
                s = starts[row]
                prob_sum[s:s + win] += p.float()
                count[s:s + win] += 1.0
                row += 1
        return prob_sum[:t_total] / torch.clamp_min(count[:t_total], 1.0)

    def predict_file(self, wav_path, csv_out=None, overlap: float = 0.0,
                     stream: bool = False) -> Prediction:
        """Decode a WAV, predict, and optionally write the metadata rows
        as CSV. stream=True feeds the clip in 1 s chunks through a
        StreamingSession (seld_tpu_torch.stream), bit-equal to the offline
        predict, overlap included."""
        wave, sr = load_wav(wav_path)
        if sr != self.cfg.features.sample_rate:
            raise ValueError(
                f"{wav_path}: sample rate {sr} != configured "
                f"{self.cfg.features.sample_rate}"
            )
        if stream:
            from seld_tpu_torch.stream import stream_predict

            chunks = np.array_split(wave, max(1, wave.shape[1] // sr), axis=1)
            pred = stream_predict(self, chunks, overlap=overlap)
        else:
            pred = self.predict_waveform(wave, overlap=overlap)
        if not (pred.classes != pred.background_class).any():
            logger.warning("%s: no events detected (all cells background)", wav_path)
        if csv_out is not None:
            Path(csv_out).parent.mkdir(parents=True, exist_ok=True)
            np.savetxt(csv_out, pred.to_metadata_rows(), fmt="%d", delimiter=",")
        return pred
