"""The port's streaming inference (seld_tpu_torch/stream.py) and the framing
fault F3, on the CPU at tiny widths: the counterparts of
tests/test_stream.py's cases, each holding the port's stream bit-equal to
the port's offline predict (chunkings random, second-long, pad-sized and
whole; tiny clips of 100 / 479 / 481 / 700 samples; the empty stream;
push after flush; "mel_iv"; overlap; the ACCDOA families; odd n_fft; TTA
at one fold; the median filter; `cli predict --stream` against the
offline CSV), the port's stream against seld_tpu's stream_predict on the
same weights, and frame_signal against seld_tpu's framer for every clip
length up to 2 n_fft. Every test removes what it writes."""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from seld_tpu.data.corpus import _frame_view
from seld_tpu.infer import SELDPredictor as JaxPredictor
from seld_tpu.stream import stream_predict as jax_stream_predict
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.data import corpus as port_corpus
from seld_tpu_torch.data.audio import write_wav
from seld_tpu_torch.data.corpus import compute_mel_features
from seld_tpu_torch.features.mel import frame_signal
from seld_tpu_torch.features.spatial import feature_channels
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.models import build_model
from seld_tpu_torch.stream import StreamingSession, stream_predict
from seld_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_predict import _assert_same_decisions
from tests.test_torch_tta import jax_and_port_checkpoints

SR = 24_000
TINY = ["model.crnn_cnn_channels=8,16", "model.conf_d_model=16", "model.conf_n_heads=2",
        "model.conf_n_layers=1", "model.compute_dtype=float32", "window.window_seconds=0.4",
        "window.hop_seconds=0.4"]
MODELS = {  # name -> overrides of a seeded, untrained tiny model
    "mel": ["model.model_type=conformer"],
    "mel_iv": ["model.model_type=conformer", "features.feature_set=mel_iv"],
    "accdoa": ["model.model_type=accdoa_conformer"],
    "multi_accdoa": ["model.model_type=multi_accdoa_conformer"],
}
BATCH = 3  # windows a forward: streamed windows take offline's batch slots


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_stream")
    paths = {}
    for i, (name, over) in enumerate(MODELS.items()):
        cfg = pc.parse_overrides(pc.Config(), [*TINY, *over])
        model = build_model(cfg.model, cfg.grid, device="cpu", seed=i,
                            in_channels=feature_channels(cfg.features.feature_set))
        save_checkpoint(tmp / f"{name}.pt", model, cfg)
        paths[name] = tmp / f"{name}.pt"
    yield tmp, paths
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def predictor(checkpoints):
    return SELDPredictor(checkpoints[1]["mel"], batch_windows=BATCH, device="cpu")


def _clip(seconds, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, int(seconds * SR))) * 0.2).astype(np.float32)


def _chunks(wave, size):
    return [wave[:, i:i + size] for i in range(0, wave.shape[1], size)]


def _assert_stream_equals_offline(pred, wave, chunks, overlap=0.0):
    offline = pred.predict_waveform(wave, overlap=overlap)
    streamed = stream_predict(pred, chunks, overlap=overlap)
    assert streamed.classes.shape == offline.classes.shape
    np.testing.assert_array_equal(streamed.classes, offline.classes)
    return offline


# --- F3: framing of clips of any length -----------------------------------------


@pytest.mark.parametrize("n_fft,hop", [(960, 480), (511, 256)])
def test_frame_signal_equals_jax_framer_for_every_length(n_fft, hop):
    """F3: clips of at most n_fft // 2 samples reflect more than once, as
    np.pad does; every length from 1 to 2 n_fft frames as seld_tpu frames."""
    rng = np.random.default_rng(n_fft)
    for n in range(1, 2 * n_fft + 1):
        wave = rng.standard_normal((4, n)).astype(np.float32)
        got = frame_signal(torch.from_numpy(wave), n_fft, hop).numpy()
        want = _frame_view(wave, n_fft, hop)
        assert got.shape == want.shape, n
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    """(JAX predictor, port predictor) of a tiny "mel" Conformer on the same
    random weights."""
    tmp = tmp_path_factory.mktemp("stream_jax")
    ckpt, port_path = jax_and_port_checkpoints(tmp, ["model.model_type=conformer", *TINY[:5]],
                                               batch=2)
    yield (JaxPredictor(ckpt, batch_windows=2),
           SELDPredictor(port_path, batch_windows=2, device="cpu"))
    shutil.rmtree(tmp, ignore_errors=True)


def _logit_margin(port, wave):
    """(T, G) gap between the two best logits of the port's offline forward."""
    mel = compute_mel_features(wave, port.cfg.features, device="cpu")
    t, win = mel.shape[0], port.win
    n = -(-t // win)
    mel = torch.cat([mel, mel.new_zeros((n * win - t, *mel.shape[1:]))])
    logits = port._raw_apply(mel.reshape(n, win, *mel.shape[1:]))
    top = torch.topk(logits.reshape(n * win, *logits.shape[2:])[:t], 2, dim=1).values
    return (top[:, 0] - top[:, 1]).numpy()


@pytest.mark.parametrize("n", [1, 100, 480])
def test_tiny_clip_predicts_as_jax(jax_and_port, n):
    """predict_waveform answers for a clip of at most n_fft // 2 samples
    (it raised before F3's repair), as the JAX predictor answers."""
    jax_pred, port = jax_and_port
    wave = _clip(0.05, seed=n)[:, :n]
    got = port.predict_waveform(wave)
    assert got.classes.shape == (1 + n // 480, 648)
    _assert_same_decisions(jax_pred.predict_waveform(wave).classes, got.classes,
                           _logit_margin(port, wave))
    _assert_stream_equals_offline(port, wave, [wave])


# --- the port's stream against its offline predict ----------------------------------


@pytest.mark.parametrize("chunking", ["one_shot", "seconds", "ragged"])
def test_stream_matches_offline_predictor(predictor, chunking):
    wave = _clip(3.3)
    n = wave.shape[1]
    if chunking == "one_shot":
        cuts = [n]
    elif chunking == "seconds":
        cuts = list(range(SR, n, SR)) + [n]
    else:  # ragged, tiny and prime-sized chunks among them
        rng = np.random.default_rng(0)
        cuts, pos = [], 0
        while pos < n:
            pos = min(pos + int(rng.integers(1, 40_000)), n)
            cuts.append(pos)
    chunks = [wave[:, a:b] for a, b in zip([0] + cuts[:-1], cuts)]
    _assert_stream_equals_offline(predictor, wave, chunks)


def test_stream_incremental_emission_and_bounded_buffer(predictor):
    wave = _clip(2.6)
    s = StreamingSession(predictor)
    frags, max_buf, step = [], 0, 12_000
    for start in range(0, wave.shape[1], step):
        frags.extend(s.push(wave[:, start:start + step]))
        if s._buf is not None:
            max_buf = max(max_buf, s._buf.shape[1])
    frags.extend(s.flush())
    assert frags[0][0] == 0
    ends = [f0 + cls.shape[0] for f0, cls in frags]
    assert [f0 for f0, _ in frags][1:] == ends[:-1]  # fragments tile the clip
    feat = predictor.cfg.features
    assert max_buf <= predictor.win * feat.hop_length + step + 2 * feat.n_fft
    assert len(frags) >= 2 and frags[0][1].shape[0] == predictor.win


def test_stream_short_clip_and_empty(predictor):
    wave = _clip(0.3)  # shorter than one window: one fragment at flush
    _assert_stream_equals_offline(predictor, wave, [wave])
    assert StreamingSession(predictor).flush() == []
    empty = stream_predict(predictor, [])
    assert empty.classes.shape == (0, 648)


def test_stream_rejects_push_after_flush(predictor):
    s = StreamingSession(predictor)
    s.push(_clip(0.2))
    s.flush()
    with pytest.raises(RuntimeError, match="already flushed"):
        s.push(_clip(0.1))
    with pytest.raises(RuntimeError, match="already flushed"):
        s.flush()


def test_stream_exact_pad_sized_chunks(predictor):
    """480-sample (n_fft // 2, 20 ms) chunks, a live stream's natural size."""
    wave = _clip(1.7)
    _assert_stream_equals_offline(predictor, wave, _chunks(wave, 480))


@pytest.mark.parametrize("feature_set", ["mel", "mel_iv"])
@pytest.mark.parametrize("n", [100, 479, 481, 700])
def test_stream_tiny_clip_multifold_reflection(checkpoints, feature_set, n):
    """Clips shorter than n_fft // 2 + 1 samples go whole through the offline
    framer at flush (F3); longer ones frame from the buffer."""
    pred = SELDPredictor(checkpoints[1][feature_set], batch_windows=BATCH, device="cpu")
    wave = _clip(0.05, seed=n)[:, :n]
    _assert_stream_equals_offline(pred, wave, [wave])
    _assert_stream_equals_offline(pred, wave, _chunks(wave, 37))


def test_stream_matches_offline_with_spatial_features(checkpoints):
    pred = SELDPredictor(checkpoints[1]["mel_iv"], batch_windows=BATCH, device="cpu")
    wave = _clip(2.4)
    _assert_stream_equals_offline(pred, wave, _chunks(wave, 17_000))
    _assert_stream_equals_offline(pred, wave, _chunks(wave, 11_111), overlap=0.5)


@pytest.mark.parametrize("overlap", [0.5, 0.8])
def test_stream_overlap_matches_offline_overlap(predictor, overlap):
    wave = _clip(3.1)
    _assert_stream_equals_offline(predictor, wave, _chunks(wave, 13_000), overlap)


def test_stream_overlap_short_clip(predictor):
    wave = _clip(0.3)
    _assert_stream_equals_offline(predictor, wave, [wave], overlap=0.5)


def test_stream_overlap_emits_incrementally(predictor):
    wave = _clip(3.0)
    s = StreamingSession(predictor, overlap=0.5)
    frags = []
    for chunk in _chunks(wave, SR):
        frags.extend(s.push(chunk))
    assert len(frags) >= 2  # before the end of the stream
    frags.extend(s.flush())
    ends = [f0 + c.shape[0] for f0, c in frags]
    assert [f0 for f0, _ in frags][1:] == ends[:-1] and ends[-1] == 1 + wave.shape[1] // 480


@pytest.mark.parametrize("family", ["accdoa", "multi_accdoa"])
def test_overlap_for_accdoa_models(checkpoints, family):
    """The ACCDOA families' averageable representations (vectors, activity
    votes) stream bit-equal, overlapped or not, and decode to a class grid."""
    pred = SELDPredictor(checkpoints[1][family], batch_windows=2, device="cpu",
                         accdoa_threshold=0.2)
    wave = _clip(2.3)
    off = _assert_stream_equals_offline(pred, wave, _chunks(wave, 6000), overlap=0.5)
    assert off.classes.dtype == np.int8 and off.classes.shape[1] == 648
    assert off.classes.max() <= 13 and (off.classes != 13).any()
    _assert_stream_equals_offline(pred, wave, _chunks(wave, 9000))


@pytest.mark.parametrize("fold", [1, 2])
def test_stream_under_tta_at_a_fixed_fold(checkpoints, fold):
    pred = SELDPredictor(checkpoints[1]["mel_iv"], batch_windows=2, device="cpu")
    pred.tta((0, 4, 9, 14), fold=fold)
    wave = _clip(2.2)
    chunks = np.array_split(wave, max(1, wave.shape[1] // SR), axis=1)
    _assert_stream_equals_offline(pred, wave, chunks)
    _assert_stream_equals_offline(pred, wave, _chunks(wave, 7_000), overlap=0.5)


def test_stream_with_median_filter(checkpoints):
    """The filter runs on the assembled grid, so the stream stays bit-equal."""
    pred = SELDPredictor(checkpoints[1]["mel"], batch_windows=BATCH, device="cpu",
                         median_filter=5)
    wave = _clip(2.1)
    off = _assert_stream_equals_offline(pred, wave, _chunks(wave, 5_000))
    raw = SELDPredictor(checkpoints[1]["mel"], batch_windows=BATCH,
                        device="cpu").predict_waveform(wave)
    assert not np.array_equal(off.classes, raw.classes)  # the filter did something


def test_stream_frame_blocks_are_its_feature_calls(predictor, monkeypatch):
    """A session computes features once per block it frames (on the card:
    one K1 or K4 launch each) and counts them."""
    calls = []
    real = port_corpus.features_from_frames

    def counted(frames, feat):
        calls.append(frames.shape[1])
        return real(frames, feat)

    monkeypatch.setattr("seld_tpu_torch.stream.features_from_frames", counted)
    wave = _clip(2.0)
    s = StreamingSession(predictor)
    for chunk in _chunks(wave, 9_000):
        s.push(chunk)
    s.flush()
    assert s.frame_blocks == len(calls) == len(_chunks(wave, 9_000)) + 1
    assert sum(calls) == 1 + wave.shape[1] // 480


# --- the command line --------------------------------------------------------------


def _cli_csvs(tmp_path, ckpt, wave, *flags_each):
    wav = tmp_path / "clip.wav"
    write_wav(wav, wave, SR)
    out = []
    for i, flags in enumerate(flags_each):
        assert port_main(["predict", "--checkpoint", str(ckpt), "--wavs", str(wav), "--out",
                          str(tmp_path / f"o{i}"), "--device", "cpu", *flags]) == 0
        out.append((tmp_path / f"o{i}" / "predictions" / "clip.csv").read_text())
    shutil.rmtree(tmp_path, ignore_errors=True)
    return out


def test_cli_stream_predict_matches_offline_csv(checkpoints, tmp_path):
    off, streamed = _cli_csvs(tmp_path, checkpoints[1]["mel"], _clip(2.2), [], ["--stream"])
    assert off and streamed == off


def test_cli_predict_overlap_flag(checkpoints, tmp_path):
    (csv,) = _cli_csvs(tmp_path, checkpoints[1]["mel"], _clip(1.8), ["--overlap", "0.5"])
    assert csv


def test_cli_stream_with_overlap_matches_offline_overlap(checkpoints, tmp_path):
    off, streamed = _cli_csvs(tmp_path, checkpoints[1]["mel"], _clip(2.3),
                              ["--overlap", "0.5"], ["--stream", "--overlap", "0.5"])
    assert off and streamed == off


def test_cli_stream_under_tta_matches_offline_tta(checkpoints, tmp_path):
    off, streamed = _cli_csvs(tmp_path, checkpoints[1]["mel_iv"], _clip(2.0),
                              ["--tta-transforms", "0,6", "--overlap", "0.5"],
                              ["--tta-transforms", "0,6", "--overlap", "0.5", "--stream"])
    assert streamed == off


# --- streamed features alone --------------------------------------------------------


def _streamed_features(cfg, wave, sizes):
    """The features a session computes for the chunk sizes, windows never
    run."""
    fake = SimpleNamespace(cfg=cfg, win=50, device=torch.device("cpu"), batch_windows=1)
    s = StreamingSession(fake)
    collected = []

    def keep(final):
        if s._mel is not None:
            collected.append(s._mel.clone())
        s._mel = None
        return []

    s._emit_ready = keep
    pos = 0
    for size in sizes:
        if pos >= wave.shape[1]:
            break
        s.push(wave[:, pos:pos + size])
        pos += size
    if pos < wave.shape[1]:
        s.push(wave[:, pos:])
    s.flush()
    return torch.cat(collected)


@pytest.mark.parametrize("n_fft,hop", [(961, 480), (511, 256), (960, 480)])
def test_streamed_mel_frames_bit_equal_odd_nfft(n_fft, hop):
    """Odd n_fft: the offline framer reflects pad samples at the end and
    zero-pads the last frame's final sample; the stream must match."""
    cfg = pc.parse_overrides(pc.Config(), [f"features.n_fft={n_fft}",
                                           f"features.hop_length={hop}"])
    wave = (np.random.default_rng(3).standard_normal((2, hop * 37 + 5)) * 0.4).astype(
        np.float32)
    offline = compute_mel_features(wave, cfg.features, device="cpu")
    got = _streamed_features(cfg, wave, [7001] * 100)
    assert got.shape == offline.shape
    assert torch.equal(got, offline)


def test_streamed_mel_random_chunkings_bit_equal():
    """Any split, empty and one-sample chunks included: the streamed frames
    equal the offline frames bit for bit."""
    cfg = pc.parse_overrides(pc.Config(), ["features.feature_set=mel_iv"])
    wave = (np.random.default_rng(11).standard_normal((4, 30_000)) * 0.4).astype(np.float32)
    offline = compute_mel_features(wave, cfg.features, device="cpu")

    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.integers(0, 9000), min_size=1, max_size=12))
    def check(sizes):
        assert torch.equal(_streamed_features(cfg, wave, sizes), offline)

    check()


# --- against seld_tpu's stream_predict ----------------------------------------------


def test_stream_matches_jax_stream_predict(jax_and_port):
    """The same weights in both packages, the same chunks: the port's
    streamed decisions are JAX's outside the margin band of the two
    float32 forwards."""
    jax_pred, port = jax_and_port
    wave = _clip(1.6, seed=3)
    chunks = _chunks(wave, 10_000)
    got = stream_predict(port, chunks)
    _assert_same_decisions(jax_stream_predict(jax_pred, chunks).classes, got.classes,
                           _logit_margin(port, wave))
    np.testing.assert_array_equal(got.classes, port.predict_waveform(wave).classes)
