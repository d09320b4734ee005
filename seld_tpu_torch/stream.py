"""Streaming inference: chunked audio in, predictions out as their windows
complete, in memory bounded by a window (counterpart: seld_tpu/stream.py).

`StreamingSession` takes waveform chunks of any size. A frame is computed
once its whole n_fft context has arrived: the session cuts each new block
of frames' raw samples from its buffer on the host, with the offline
framer's reflections at the clip's start and, at flush(), its end, uploads
that segment once (from pinned memory on a CUDA device) and frames it on
the device as a strided view, which kernel K1 ("mel") or K4 ("mel_iv",
"mel_gcc") reads in place through `features_from_frames`: one launch a
block. A clip that never reaches n_fft // 2 + 1 samples goes whole through
the offline framer at flush (np.pad's multi-fold reflection).

Windows run through `predictor._batched` at the predictor's batch shape,
each in the batch slot it takes in the offline predict (slot = its index
modulo batch_windows), so a window's output is computed at the same shape
and place as offline, under the daemon's batcher (seld_tpu_torch.serve)
too. With overlap the per-frame representation (class
probabilities, ACCDOA vectors or multi-ACCDOA votes, or their TTA
averages) accumulates in float32 on the device in the offline window
order and is decoded by `predictor._decode_avg`.

Contract (tests/test_torch_stream.py, chip_smoke.py phase 15): any
chunking of a clip gives classes bit-equal to
`SELDPredictor.predict_waveform` of the whole clip, with overlap, under
TTA at one fold, and with the median filter, which runs on the assembled
grid.
"""

from __future__ import annotations

import numpy as np
import torch

from seld_tpu_torch.data.corpus import compute_mel_features, features_from_frames
from seld_tpu_torch.features.mel import num_stft_frames
from seld_tpu_torch.infer import Prediction, SELDPredictor


class StreamingSession:
    """One audio stream: push() chunks, each returning the (start_frame,
    classes (k, G) int8) fragments it completed, then flush() at its end.

    With overlap > 0 windows stride at hop = win * (1 - overlap), as in
    predict_waveform(overlap=...), and a frame is emitted once the last
    window covering it has run: a latency of one window and one hop.

    `frame_blocks` counts the feature computations (K1 or K4 launches on
    a CUDA device)."""

    def __init__(self, predictor: SELDPredictor, overlap: float = 0.0):
        self.p = predictor
        feat = predictor.cfg.features
        self.n_fft = feat.n_fft
        self.hop = feat.hop_length
        self.pad = self.n_fft // 2
        self.win = predictor.win
        self._buf = None  # (C, n) raw samples future frames still need
        self._buf_start = 0  # absolute index of _buf[:, 0]
        self._total = 0  # samples seen
        self._frames_done = 0  # frames featurized
        self._mel = None  # (T_pending, C_out, F) device features awaiting windows
        self._mel_base = 0  # absolute frame of _mel[0]
        self._emitted_frames = 0
        self._windows_run = 0  # windows through the model: the next one's batch slot
        self._flushed = False
        self.frame_blocks = 0

        if overlap:
            if not 0.0 < overlap < 1.0:
                raise ValueError(f"overlap must be in [0, 1), got {overlap}")
            self.whop = max(int(self.win * (1.0 - overlap)), 1)
        else:
            self.whop = None
        self._next_start = 0  # next window start (overlap)
        self._prob = None  # (pending, *rep) float32 sums (overlap)
        self._pcount = None  # (pending, 1, ...) float32 coverage counts

    # -- features ------------------------------------------------------------

    def _frame_block(self, t0: int, t1: int, end_reflect: bool) -> np.ndarray:
        """The (C, L) raw samples of frames t0..t1-1, contiguous, with the
        offline framer's reflect padding at the clip's edges: frame t is
        samples [t * hop, t * hop + n_fft) of it."""
        c = self._buf.shape[0]
        left_need = t0 * self.hop - self.pad
        right_need = (t1 - 1) * self.hop - self.pad + self.n_fft
        seg_start = max(left_need, 0)
        seg = self._buf[:, seg_start - self._buf_start:right_need - self._buf_start]
        if left_need < 0:  # clip start: reflect
            seg = np.concatenate([self._buf[:, 1:1 - left_need][:, ::-1], seg], axis=1)
        if seg.shape[1] < right_need - left_need:  # clip end (flush)
            assert end_reflect, "interior frame requested past the buffer"
            missing = right_need - left_need - seg.shape[1]
            # as frame_signal: reflect at most pad samples past the end, then
            # zero-pad what the last frame still lacks (odd n_fft only)
            k = min(missing, self.pad, self._buf.shape[1] - 1)
            tail = (self._buf[:, -k - 1:-1][:, ::-1] if k > 0
                    else np.zeros((c, 0), self._buf.dtype))
            if tail.shape[1] < missing:
                tail = np.pad(tail, ((0, 0), (0, missing - tail.shape[1])))
            seg = np.concatenate([seg, tail], axis=1)
        return np.ascontiguousarray(seg)

    def _features(self, seg: np.ndarray, n_frames: int) -> torch.Tensor:
        """A block's segment, uploaded once and framed on the device as a
        strided view -> its (n_frames, C_out, F) features."""
        x = torch.from_numpy(seg)
        if self.p.device.type == "cuda":
            x = x.pin_memory().to(self.p.device, non_blocking=True)
        else:
            x = x.to(self.p.device)
        frames = x.as_strided((x.shape[0], n_frames, self.n_fft), (x.shape[1], self.hop, 1))
        self.frame_blocks += 1
        return features_from_frames(frames, self.p.cfg.features)

    def _append(self, mel: torch.Tensor) -> None:
        self._mel = mel if self._mel is None else torch.cat([self._mel, mel])

    def _produce_frames(self, t1: int, end_reflect: bool = False) -> None:
        if t1 <= self._frames_done:
            return
        t0 = self._frames_done
        self._append(self._features(self._frame_block(t0, t1, end_reflect), t1 - t0))
        self._frames_done = t1
        # the next frame needs samples from here on; one n_fft more is kept
        # for the end reflection at flush
        keep_from = max(t1 * self.hop - self.pad - self.n_fft, self._buf_start)
        if keep_from > self._buf_start:
            self._buf = self._buf[:, keep_from - self._buf_start:]
            self._buf_start = keep_from

    # -- windows ---------------------------------------------------------------

    def _run(self, windows: torch.Tensor, fn) -> torch.Tensor:
        """fn over windows through predictor._batched, each window in the
        batch slot its index takes offline (under the daemon's batcher
        too)."""
        lead = self._windows_run % self.p.batch_windows
        self._windows_run += windows.shape[0]
        return torch.cat(list(self.p._batched(windows, fn, lead)))

    def _drop_mel(self, n: int) -> None:
        self._mel = self._mel[n:]
        self._mel_base += n
        if self._mel.shape[0] == 0:
            self._mel = None

    def _emit_ready(self, final: bool) -> list:
        """Run every complete window (at flush, also the final partial one,
        zero-padded as predict_waveform pads it) and emit its classes."""
        if self.whop is not None:
            return self._emit_ready_overlap(final)
        if self._mel is None:
            return []
        pending = self._mel.shape[0]
        n_windows, tail = divmod(pending, self.win)
        if final and tail:
            n_windows += 1
        if n_windows == 0:
            return []
        valid = [self.win] * n_windows
        block = self._mel[:n_windows * self.win]
        if block.shape[0] < n_windows * self.win:
            valid[-1] = tail
            block = torch.cat([block, block.new_zeros((self.win - tail, *block.shape[1:]))])
        classes = self._run(block.reshape(n_windows, self.win, *block.shape[1:]),
                            self.p._forward).cpu().numpy()
        out = []
        for w, n in enumerate(valid):
            out.append((self._emitted_frames, classes[w][:n]))
            self._emitted_frames += n
        self._drop_mel(sum(valid))
        return out

    def _emit_ready_overlap(self, final: bool) -> list:
        """Run every window whose frames have arrived (at flush, the rest of
        predict_waveform's schedule, zero-padded), add its representation
        into the float32 sums, and emit the frames no later window covers."""
        t = self._frames_done
        starts = []
        if not final:
            while self._next_start + self.win <= t:
                starts.append(self._next_start)
                self._next_start += self.whop
        else:
            # the schedule's rest: starts up to max(T - win, 0), then the
            # tail window when the grid stops short of the end
            last_grid = max(t - self.win, 0)
            while self._next_start <= last_grid:
                starts.append(self._next_start)
                self._next_start += self.whop
            prev = starts[-1] if starts else (
                self._next_start - self.whop if self._next_start > 0 else None)
            if prev is not None and prev + self.win < t:
                starts.append(max(t - self.win, 0))

        frags = []
        if starts:
            need_through = starts[-1] + self.win  # past T at flush
            have = self._mel_base + self._mel.shape[0]
            if have < need_through:  # the zero-padded tail (flush)
                self._append(self._mel.new_zeros((need_through - have,
                                                  *self._mel.shape[1:])))
            windows = torch.stack([self._mel[s - self._mel_base:s - self._mel_base + self.win]
                                   for s in starts])
            probs = self._run(windows, self.p._forward_probs)
            rep = probs.shape[2:]
            held = 0 if self._prob is None else self._prob.shape[0]
            grow = need_through - self._emitted_frames - held
            if grow > 0:
                z = probs.new_zeros((grow, *rep), dtype=torch.float32)
                zc = probs.new_zeros((grow, *(1,) * len(rep)), dtype=torch.float32)
                self._prob = z if self._prob is None else torch.cat([self._prob, z])
                self._pcount = zc if self._pcount is None else torch.cat([self._pcount, zc])
            for s, p in zip(starts, probs):  # the offline accumulation order
                lo = s - self._emitted_frames
                self._prob[lo:lo + self.win] += p.float()
                self._pcount[lo:lo + self.win] += 1.0

        # a frame is final once no later window can cover it: later grid
        # windows start at _next_start, and flush's tail window at
        # T_final - win >= T_now - win
        final_through = t if final else min(self._next_start, max(t - self.win, 0))
        n_emit = final_through - self._emitted_frames
        if n_emit > 0 and self._prob is not None:
            n_emit = min(n_emit, self._prob.shape[0])
            avg = self._prob[:n_emit] / torch.clamp_min(self._pcount[:n_emit], 1.0)
            frags.append((self._emitted_frames, self.p._decode_avg(avg)))
            self._emitted_frames += n_emit
            self._prob = self._prob[n_emit:]
            self._pcount = self._pcount[n_emit:]
        # drop the features no later window (grid or tail) can need
        keep_from = self._next_start if final else min(self._next_start,
                                                       max(t - self.win, 0))
        if self._mel is not None and keep_from > self._mel_base:
            self._drop_mel(min(keep_from - self._mel_base, self._mel.shape[0]))
        return frags

    # -- public API --------------------------------------------------------------

    def push(self, chunk) -> list:
        """Feed (C, n) samples; returns the [(start_frame, classes (k, G))]
        fragments this chunk completed (possibly none)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        chunk = np.asarray(chunk, np.float32)
        self._buf = chunk if self._buf is None else np.concatenate([self._buf, chunk], axis=1)
        self._total += chunk.shape[1]
        # interior frames only: frame t needs samples through
        # t * hop + n_fft - pad, frame 0 pad + 1 for its start reflection
        if self._total < self.pad + 1:
            return []
        t_ready = max(0, (self._total - (self.n_fft - self.pad)) // self.hop + 1)
        self._produce_frames(min(t_ready, num_stft_frames(self._total, self.hop)))
        return self._emit_ready(final=False)

    def flush(self) -> list:
        """End of stream: the end-reflected last frames and the final
        (possibly partial) window."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        self._flushed = True
        if self._total == 0:
            return []
        if self._frames_done == 0:
            # the buffer still holds the whole clip: the offline framer
            # reflects as often as a clip of at most n_fft // 2 samples needs
            self._mel = compute_mel_features(self._buf, self.p.cfg.features, self.p.device)
            self.frame_blocks += 1
            self._frames_done = self._mel.shape[0]
        else:
            self._produce_frames(num_stft_frames(self._total, self.hop), end_reflect=True)
        return self._emit_ready(final=True)


def stream_predict(predictor: SELDPredictor, chunks, overlap: float = 0.0) -> Prediction:
    """A chunk iterator through one StreamingSession, assembled into the
    clip's Prediction: bit-equal to predictor.predict_waveform of the
    concatenated audio. The median filter runs on the assembled grid, as
    offline."""
    s = StreamingSession(predictor, overlap=overlap)
    parts = []
    for chunk in chunks:
        parts.extend(cls for _, cls in s.push(chunk))
    parts.extend(cls for _, cls in s.flush())
    grid = predictor.cfg.grid
    classes = (np.concatenate(parts, axis=0) if parts
               else np.zeros((0, grid.n_cells), np.int8))
    return Prediction(classes=predictor._smooth(classes), n_el=grid.n_el, n_az=grid.n_az,
                      num_classes=grid.num_classes)
