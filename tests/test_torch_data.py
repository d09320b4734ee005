"""The port's data path against seld_tpu's, on the CPU: the same seeds
give the same synthetic clips, label bitmasks, window starts and batch
order; features agree to K1's 5e-3 dB (the plain version of K1 against the
JAX package's rFFT path)."""

import numpy as np
import pytest
import torch

from seld_tpu.config import Config, parse_overrides
from seld_tpu.data.sampler import BatchIterator
from seld_tpu.data.synthetic import (
    foa_gains,
    synthetic_clip,
    synthetic_corpus,
    synthetic_raw_files,
)
from seld_tpu_torch import config as pc
from seld_tpu_torch.data import synthetic as port_synthetic
from seld_tpu_torch.data.audio import load_wav, write_wav
from seld_tpu_torch.data.corpus import build_corpus
from seld_tpu_torch.data.discovery import discover_files
from seld_tpu_torch.data.sampler import BatchIterator as PortBatchIterator
from seld_tpu_torch.data.sampler import device_prefetch, place_batch
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

OVERRIDES = ["window.window_seconds=1.0", "window.hop_seconds=0.5"]
DB_ATOL = 5e-3


@pytest.fixture(scope="module")
def corpora():
    """The same synthetic corpus from both packages: 2 clips of 3 s."""
    want = synthetic_corpus(parse_overrides(Config(), OVERRIDES), n_files=2, seconds=3.0, seed=5)
    got = port_synthetic.synthetic_corpus(pc.parse_overrides(pc.Config(), OVERRIDES),
                                          n_files=2, seconds=3.0, seed=5, device="cpu")
    return want, got


def test_synthetic_corpus_equals_jax(corpora):
    want, got = corpora
    assert got.label_mask.dtype == np.uint16 and got.label_mask.any()
    np.testing.assert_array_equal(got.label_mask, want.label_mask)
    np.testing.assert_array_equal(got.starts, want.starts)
    assert got.starts.dtype == want.starts.dtype
    assert (got.window_frames, got.total_frames, len(got)) == (
        want.window_frames, want.total_frames, len(want)) == (50, 300, 12)
    assert (got.n_el, got.n_az, got.num_classes) == (want.n_el, want.n_az, want.num_classes)
    assert got.mel.shape == want.mel.shape and got.mel.dtype == np.float32
    np.testing.assert_allclose(got.mel, want.mel, atol=DB_ATOL, rtol=0)
    assert not got.mel[got.total_frames:].any()  # the tail pad: zeros, background


@pytest.mark.parametrize("kwargs", [
    {}, {"doa_step_deg": 45, "event_rate_hz": 1.0},
    {"doa_step_deg": 30, "event_rate_hz": 0.5, "motion_deg_per_s": 40.0},
])
def test_synthetic_clip_draws_like_jax(kwargs):
    want_wave, want_rows = synthetic_clip(np.random.default_rng(3), 4.0, 24_000, **kwargs)
    got_wave, got_rows = port_synthetic.synthetic_clip(
        np.random.default_rng(3), 4.0, 24_000, **kwargs)
    np.testing.assert_array_equal(got_wave, want_wave)
    np.testing.assert_array_equal(got_rows, want_rows)
    assert len(got_rows) > 0
    np.testing.assert_array_equal(port_synthetic.foa_gains(30, -20), foa_gains(30, -20))


def test_synthetic_raw_files_lay_out_like_jax(tmp_path):
    want = synthetic_raw_files(tmp_path / "jax", Config(), n_files=2, seconds=1.0, seed=2,
                               split_dirs=True)
    got = port_synthetic.synthetic_raw_files(tmp_path / "port", pc.Config(), n_files=2,
                                             seconds=1.0, seed=2, split_dirs=True)
    for w_files, g_files in zip(want, got):
        assert [f.split("/jax/")[1] for f in w_files] == [f.split("/port/")[1] for f in g_files]
        for w, g in zip(w_files, g_files):
            assert open(w, "rb").read() == open(g, "rb").read()


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_gives_jax_batches(corpora, shuffle):
    want_c, got_c = corpora
    want_it = BatchIterator(want_c, 5, shuffle=shuffle, seed=7, prefetch=2)
    got_it = PortBatchIterator(got_c, 5, shuffle=shuffle, seed=7, prefetch=2)
    assert len(got_it) == len(want_it) == 3
    for _ in range(2):  # two epochs: the shuffle follows (seed, epoch)
        want, got = list(want_it), list(got_it)
        assert [b.n_valid for b in got] == [b.n_valid for b in want] == [5, 5, 2]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.label_mask, w.label_mask)
            np.testing.assert_allclose(g.mel, w.mel, atol=DB_ATOL, rtol=0)
            assert g.mel.shape == (5, 50, 4, 64)  # the tail is padded to the batch
    inline = list(PortBatchIterator(got_c, 5, shuffle=shuffle, seed=7, prefetch=0))
    np.testing.assert_array_equal(inline[1].label_mask,  # epoch 0 again, without the thread
                                  list(BatchIterator(want_c, 5, shuffle=shuffle, seed=7))[1]
                                  .label_mask)


def test_place_batch_carries_the_mask_bits_as_int16(corpora):
    _, got_c = corpora
    batch = list(PortBatchIterator(got_c, 5, shuffle=False, prefetch=0))[2]
    batch.label_mask[0, 0, 0] = 0x9001  # bit 15 set: the reinterpretation keeps it
    mel, mask, em = place_batch(batch, torch.device("cpu"))
    assert (mel.dtype, mask.dtype, em.dtype) == (torch.float32, torch.int16, torch.float32)
    assert em.tolist() == [1.0, 1.0, 0.0, 0.0, 0.0]
    np.testing.assert_array_equal(mask.numpy().view(np.uint16), batch.label_mask)
    np.testing.assert_array_equal(mel.numpy(), batch.mel)


def test_device_prefetch_keeps_order_and_depth():
    placed = []

    def place(i):
        placed.append(i)
        return i * 10

    seen = []
    for item in device_prefetch(range(5), place, depth=2):
        seen.append((item, len(placed)))
    assert seen == [(0, 3), (10, 4), (20, 5), (30, 5), (40, 5)]
    assert list(device_prefetch(range(3), place, depth=0)) == [0, 10, 20]


def test_build_corpus_crops_pads_and_refuses(tmp_path):
    cfg = pc.parse_overrides(pc.Config(), OVERRIDES)
    audio, meta = port_synthetic.synthetic_raw_files(tmp_path, cfg, n_files=1, seconds=1.3)
    corpus = build_corpus(audio, meta, cfg.features, cfg.grid, cfg.window, cfg.targets,
                          device="cpu")
    # 1.3 s: 66 feature frames, 65 label frames -> 65; windows at 0, 25, 50
    assert corpus.total_frames == 65 and corpus.starts.tolist() == [0, 25, 50]
    assert corpus.mel.shape == (100, 4, 64) and corpus.label_mask.shape == (100, 648)
    mel, mask = corpus.gather(np.array([2, 0]))
    assert mel.shape == (2, 50, 4, 64) and mask.shape == (2, 50, 648)
    np.testing.assert_array_equal(mel[0], corpus.mel[50:100])
    with pytest.raises(ValueError, match="metadata files"):
        build_corpus(audio, [], cfg.features, cfg.grid, cfg.window, cfg.targets, device="cpu")


def test_wav_round_trip_and_discovery(tmp_path):
    wave = (0.5 * np.random.default_rng(0).uniform(-1, 1, (4, 480))).astype(np.float32)
    write_wav(tmp_path / "a" / "x.wav", wave, 24_000)
    got, sr = load_wav(tmp_path / "a" / "x.wav")
    assert sr == 24_000 and got.shape == wave.shape
    np.testing.assert_allclose(got, wave, atol=2 / 32768)  # 16-bit PCM, 32767 up, 32768 down

    cfg = pc.Config()
    port_synthetic.synthetic_raw_files(tmp_path, cfg, n_files=2, seconds=0.5, split_dirs=True)
    data = pc.DataConfig(base_path=str(tmp_path))
    tr_a, tr_m, te_a, te_m = discover_files(data)
    assert [f.rsplit("/", 2)[1:] for f in tr_a] == [
        ["dev-train-sony", "fold3_room1_mix000.wav"], ["dev-train-tau", "fold3_room1_mix001.wav"]]
    assert [m.endswith(".csv") for m in tr_m] == [True, True] and te_a == te_m == []
    (tmp_path / "metadata_dev" / "dev-train-tau" / "fold3_room1_mix001.csv").unlink()
    with pytest.raises(FileNotFoundError, match="fold3_room1_mix001.csv"):
        discover_files(data)
    single = discover_files(pc.DataConfig(base_path=str(tmp_path), use_full_dataset=False))
    assert single[0][0].endswith("foa_dev/dev-train-sony/fold3_room21_mix001.wav")
