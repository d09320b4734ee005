"""The accuracy recipe's training side against seld_tpu's: the ACS tables
and transforms, SpecAugment, the Gaussian label rasterizer and the corpus
cache, the train step's augmentation hooks, and `cli train` with the
recipe's overrides on the CPU.

JAX's random draws are not torch's, so ACS and SpecAugment are compared
on draws made on the JAX side (the transform indices of make_acs_augment,
the masks of _axis_keep_mask) and fed to the port's pure functions; the
port's own draws are held to distribution properties."""

import json
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.data.cache import corpus_cache_key as jax_cache_key
from seld_tpu.features import acs as jax_acs
from seld_tpu.features.specaugment import _axis_keep_mask
from seld_tpu.features.specaugment import spec_augment as jax_spec_augment
from seld_tpu.grid import wrap_angle_diff as jax_wrap_angle_diff
from seld_tpu.targets import gaussian as jax_gaussian
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.data import cache as port_cache
from seld_tpu_torch.data.synthetic import synthetic_raw_files
from seld_tpu_torch.features import acs
from seld_tpu_torch.features.specaugment import (
    apply_spec_augment,
    axis_mask,
    make_spec_augment,
    spec_augment,
)
from seld_tpu_torch.grid import wrap_angle_diff
from seld_tpu_torch.losses import SELDLossFn
from seld_tpu_torch.ops.spatial_cuda import spatial_features
from seld_tpu_torch.targets import gaussian
from seld_tpu_torch.train.optimizer import make_optimizer
from seld_tpu_torch.train.state import create_train_state
from seld_tpu_torch.train.steps import make_train_step
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

N_EL, N_AZ, G = 18, 36, 648


# --- ACS ------------------------------------------------------------------


@pytest.mark.parametrize("t", range(16))
def test_acs_transform_matches_jax(t):
    assert acs.transform_params(t) == jax_acs.transform_params(t)
    az = np.linspace(-180, 179, 37)
    el = np.linspace(-90, 90, 37)
    for got, want in zip(acs.transform_angles(az, el, t), jax_acs.transform_angles(az, el, t)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(acs.audio_channel_transform(t), jax_acs.audio_channel_transform(t)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_el,n_az", [(18, 36), (6, 12)])
def test_acs_tables_match_jax(n_el, n_az):
    for got, want in zip(acs.acs_tables(n_el, n_az), jax_acs.acs_tables(n_el, n_az)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(acs.vector_tables(), jax_acs.vector_tables()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("feature_set", ["mel", "mel_gcc"])
def test_acs_rejects_unsigned_feature_sets(feature_set):
    with pytest.raises(ValueError, match="signed spatial features") as port_err:
        acs.make_acs_augment(N_EL, N_AZ, feature_set)
    with pytest.raises(ValueError) as jax_err:
        jax_acs.acs_tables(N_EL, N_AZ, feature_set)
    assert str(port_err.value) == str(jax_err.value)


def test_apply_acs_equals_jax_on_its_draws():
    """make_acs_augment draws t = randint(key, (B,), 0, 16); the port's
    apply_acs on those t gives the same features and labels exactly."""
    rng = np.random.default_rng(0)
    b, t = 6, 5
    feats = rng.standard_normal((b, t, 7, 16)).astype(np.float32)
    mask = rng.integers(0, 1 << 13, (b, t, G)).astype(np.uint16)
    mask[rng.random((b, t, G)) < 0.9] = 0
    key = jax.random.PRNGKey(3)
    want_f, want_m = jax_acs.make_acs_augment(N_EL, N_AZ)(key, jnp.asarray(feats),
                                                          jnp.asarray(mask))
    draws = np.array(jax.random.randint(key, (b,), 0, 16))
    got_f, got_m = acs.apply_acs(torch.from_numpy(feats),
                                 torch.from_numpy(mask.view(np.int16)),
                                 torch.from_numpy(draws), N_EL, N_AZ)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_m.numpy().view(np.uint16), np.asarray(want_m))


def test_make_acs_augment_moves_events_with_features():
    augment = acs.make_acs_augment(N_EL, N_AZ)
    b, t = 64, 3
    feats = torch.randn((b, t, 7, 8))
    mask = torch.zeros((b, t, G), dtype=torch.int16)
    mask[:, :, 100] = 1 << 5
    f1, m1 = augment(torch.Generator().manual_seed(0), feats, mask)
    f2, m2 = augment(torch.Generator().manual_seed(0), feats, mask)
    assert torch.equal(f1, f2) and torch.equal(m1, m2)  # a pure function of the seed
    assert int((m1 != 0).sum()) == b * t  # one active cell per frame still
    moved = {int(np.flatnonzero(m1[i, 0].numpy())[0]) for i in range(b)}
    assert len(moved) > 8  # 64 draws over 16 transforms land on many cells


def test_acs_commutes_with_plain_k4():
    """Transforming the audio and then K4 equals K4 and then the
    feature-side transform (tests/test_acs.py holds 1e-5 on the jnp path)."""
    frames = np.random.default_rng(1).standard_normal((4, 6, 960)).astype(np.float32)
    _, ch_perm, ch_sign = acs.acs_tables(N_EL, N_AZ)
    base = spatial_features(torch.from_numpy(frames), "mel_iv").numpy()
    for t in range(acs.N_TRANSFORMS):
        perm, sign = acs.audio_channel_transform(t)
        audio_t = np.ascontiguousarray(sign[:, None, None] * frames[perm])
        want = spatial_features(torch.from_numpy(audio_t), "mel_iv").numpy()
        got = ch_sign[t][None, :, None] * base[:, ch_perm[t]]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"t={t}")


# --- SpecAugment ----------------------------------------------------------


@pytest.mark.parametrize("time_masks,freq_masks", [(2, 0), (0, 2), (2, 2)])
def test_spec_augment_equals_jax_on_its_masks(time_masks, freq_masks):
    mel = np.random.default_rng(2).standard_normal((3, 40, 7, 16)).astype(np.float32) + 2.0
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_spec_augment(key, jnp.asarray(mel), time_masks, 10, freq_masks, 4))
    k_t, k_f = jax.random.split(key)  # spec_augment's own split
    tm = np.array(_axis_keep_mask(k_t, 3, time_masks, 10, 40)) if time_masks else None
    fm = np.array(_axis_keep_mask(k_f, 3, freq_masks, 4, 16)) if freq_masks else None
    got = apply_spec_augment(torch.from_numpy(mel),
                             None if tm is None else torch.from_numpy(tm),
                             None if fm is None else torch.from_numpy(fm)).numpy()
    # the same positions are filled; the fills are float32 means of 640
    # values near 2, summed in another order: a few ulps apart
    np.testing.assert_array_equal(got == mel, want == mel)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_spec_augment_off_is_the_input():
    mel = torch.randn((2, 10, 4, 8))
    assert spec_augment(torch.Generator().manual_seed(0), mel, 0, 10, 0, 4) is mel
    assert make_spec_augment(pc.TrainConfig()) is None


def test_axis_mask_draws_stay_in_bounds():
    g = torch.Generator().manual_seed(1)
    masks = axis_mask(g, 2000, 1, 5, 12)
    widths = masks.sum(dim=1)
    assert masks.shape == (2000, 12) and int(widths.max()) == 5 and int(widths.min()) == 0
    # a single interval per row, anywhere in the axis
    starts = masks.float().argmax(dim=1)[widths > 0]
    assert int(starts.min()) == 0 and int(starts.max()) == 11
    runs = (masks[:, 1:] & ~masks[:, :-1]).sum(dim=1) + masks[:, 0].long()
    assert int(runs.max()) == 1


def test_spec_augment_fills_whole_frames_and_bins_with_the_channel_mean():
    mel = torch.randn((3, 40, 4, 16)) + 2.0
    fill = mel.mean(dim=(1, 3))  # (B, C)
    by_time = spec_augment(torch.Generator().manual_seed(2), mel, 2, 10, 0, 4)
    by_freq = spec_augment(torch.Generator().manual_seed(2), mel, 0, 10, 2, 4)
    for b in range(3):
        frames = (by_time[b] != mel[b]).any(dim=2).any(dim=1)
        bins = (by_freq[b] != mel[b]).any(dim=0).any(dim=0)
        assert 0 < int(frames.sum()) <= 20 and 0 < int(bins.sum()) <= 8
        for c in range(4):
            assert torch.equal(by_time[b, frames, c], fill[b, c].expand(int(frames.sum()), 16))
            assert torch.equal(by_freq[b, :, c][:, bins], fill[b, c].expand(40, int(bins.sum())))
    both = spec_augment(torch.Generator().manual_seed(2), mel, 2, 10, 2, 4)
    again = spec_augment(torch.Generator().manual_seed(2), mel, 2, 10, 2, 4)
    other = spec_augment(torch.Generator().manual_seed(3), mel, 2, 10, 2, 4)
    assert torch.equal(both, again) and not torch.equal(both, other)


# --- Gaussian label targets -----------------------------------------------


def test_wrap_angle_diff_matches_jax_in_float32():
    a = np.array([179.5, -179.5, 0.0, 90.0, -180.0, 175.0])
    b = np.array([-179.5, 179.5, 359.0, -90.0, 180.0, -175.0])
    got = wrap_angle_diff(a, b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_wrap_angle_diff(a, b))


def test_draw_source_noise_matches_jax():
    classes = np.array([3, 3, 1, 7, 1])
    sources = np.array([0, 1, 0, 2, 0])
    for seed, file_key in ((0, 0), (5, 3)):
        assert (gaussian.draw_source_noise(classes, sources, 5.0, 7.0, seed, file_key)
                == jax_gaussian.draw_source_noise(classes, sources, 5.0, 7.0, seed, file_key))


def test_gaussian_region_mask_matches_jax():
    rng = np.random.default_rng(4)
    az = np.concatenate([rng.uniform(-180, 180, 40), [179.0, -179.0, 185.0, -186.0]])
    el = np.concatenate([rng.uniform(-95, 95, 40), [0.0, 88.0, -91.0, 45.0]])
    for sig_az, sig_el in ((5.0, 5.0), (20.0, 3.0)):
        np.testing.assert_array_equal(
            gaussian.gaussian_region_mask(az, el, sig_az, sig_el),
            jax_gaussian.gaussian_region_mask(az, el, sig_az, sig_el),
        )


@pytest.mark.parametrize("seed,file_key", [(0, 0), (1, 2), (7, 5)])
def test_rasterize_gaussian_labels_bit_equal_to_jax(seed, file_key):
    rng = np.random.default_rng(seed)
    n = 30
    frames = rng.integers(0, 20, n)
    classes = rng.integers(0, 13, n)
    sources = rng.integers(0, 3, n)
    az = rng.integers(-180, 180, n)
    el = rng.integers(-90, 91, n)
    az[:3] = [179, -180, 178]  # on the dateline: the regions wrap
    kwargs = dict(total_frames=97, sigma_azimuth=5.0, sigma_elevation=5.0, seed=seed,
                  file_key=file_key, return_dense=False)
    got = gaussian.rasterize_gaussian_labels(frames, classes, sources, az, el, **kwargs)
    want = jax_gaussian.rasterize_gaussian_labels(frames, classes, sources, az, el, **kwargs)
    assert got.dtype == np.uint16 and got.any()
    np.testing.assert_array_equal(got, want)
    cells = np.flatnonzero(got.any(axis=0)) % N_AZ
    assert {0, N_AZ - 1} <= set(cells.tolist())  # both sides of the dateline
    dense = gaussian.rasterize_gaussian_labels(frames, classes, sources, az, el,
                                               **{**kwargs, "return_dense": True})
    np.testing.assert_array_equal(dense, jax_gaussian.rasterize_gaussian_labels(
        frames, classes, sources, az, el, **{**kwargs, "return_dense": True}))


# --- the corpus cache -----------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cache")
    yield synthetic_raw_files(root, pc.Config(), n_files=2, seconds=1.0, seed=3)
    shutil.rmtree(root, ignore_errors=True)


def _recipe_cfg():
    return pc.parse_overrides(pc.Config(), ["features.feature_set=mel_iv",
                                            "targets.use_gaussian_augmentation=true"])


def _build(cfg, files, cache_dir, train=True):
    return port_cache.cached_build_corpus(*files, cfg.features, cfg.grid, cfg.window,
                                          cfg.targets, train=train, cache_dir=cache_dir,
                                          device="cpu")


def _assert_equal(a, b):
    np.testing.assert_array_equal(a.mel, b.mel)
    np.testing.assert_array_equal(a.label_mask, b.label_mask)
    np.testing.assert_array_equal(a.starts, b.starts)
    assert (a.window_frames, a.total_frames, a.n_el, a.n_az, a.num_classes) == (
        b.window_frames, b.total_frames, b.n_el, b.n_az, b.num_classes)


def test_cache_hit_is_bit_identical_and_skips_the_build(files, tmp_path, monkeypatch):
    cfg = _recipe_cfg()
    fresh = _build(cfg, files, str(tmp_path / "cache"))
    assert fresh.mel.shape[1] == 7 and len(list((tmp_path / "cache").glob("corpus_*.npz"))) == 1

    def boom(*a, **k):
        raise AssertionError("build_corpus called on a cache hit")

    monkeypatch.setattr(port_cache, "build_corpus", boom)
    _assert_equal(fresh, _build(cfg, files, str(tmp_path / "cache")))


def test_empty_cache_dir_is_a_plain_build(files):
    from seld_tpu_torch.data.corpus import build_corpus

    cfg = _recipe_cfg()
    direct = build_corpus(*files, cfg.features, cfg.grid, cfg.window, cfg.targets,
                          device="cpu")
    _assert_equal(direct, _build(cfg, files, ""))


def test_gaussian_corpus_labels_key_on_the_file_index(files):
    """build_corpus rasterizes file i with file_key=i, as the JAX package."""
    from seld_tpu_torch.targets.rasterize import load_metadata_csv, total_label_frames

    cfg = _recipe_cfg()
    corpus = _build(cfg, files, "")
    want = []
    for idx, mpath in enumerate(files[1]):
        frames, classes, sources, az, el = load_metadata_csv(mpath)
        t_lab = total_label_frames(24_000, 24_000)
        want.append(jax_gaussian.rasterize_gaussian_labels(
            frames, classes, sources, az, el, t_lab, seed=0, file_key=idx,
            return_dense=False)[:50])  # 50 label frames a clip
    want = np.concatenate(want)
    np.testing.assert_array_equal(corpus.label_mask[:len(want)], want)


def test_cache_key_changes_on_edits_and_is_not_the_jax_key(files, tmp_path):
    cfg = _recipe_cfg()
    a, m = files
    parts = (cfg.features, cfg.grid, cfg.window, cfg.targets)
    k0 = port_cache.corpus_cache_key(a, m, *parts, train=True)
    assert port_cache.corpus_cache_key(a, m, *parts, train=False) != k0
    cfg2 = cfg.replace_path("targets.sigma_azimuth", 6.0)
    assert port_cache.corpus_cache_key(a, m, cfg2.features, cfg2.grid, cfg2.window,
                                       cfg2.targets, train=True) != k0
    from seld_tpu.config import Config as JaxConfig

    j = JaxConfig()
    assert jax_cache_key(a, m, j.features, j.grid, j.window, j.targets, True) != \
        port_cache.corpus_cache_key(a, m, pc.FeatureConfig(), pc.GridConfig(),
                                    pc.WindowConfig(), pc.TargetConfig(), train=True)
    edited = tmp_path / "edited.csv"
    shutil.copy(m[0], edited)
    with open(edited, "a") as fh:
        fh.write("0,0,0,0,0\n")
    assert port_cache.corpus_cache_key(a, [str(edited), m[1]], *parts, train=True) != k0


def test_corrupt_cache_entry_is_rebuilt(files, tmp_path):
    cfg = _recipe_cfg()
    fresh = _build(cfg, files, str(tmp_path))
    (entry,) = tmp_path.glob("corpus_*.npz")
    entry.write_bytes(b"not an npz")
    _assert_equal(fresh, _build(cfg, files, str(tmp_path)))
    _assert_equal(fresh, _build(cfg, files, str(tmp_path)))  # a loadable entry again


def test_failed_cache_store_warns_and_returns_the_corpus(files, tmp_path, monkeypatch, caplog):
    def full_disk(*a, **k):
        raise OSError("No space left on device")

    monkeypatch.setattr(port_cache.np, "savez", full_disk)
    corpus = _build(_recipe_cfg(), files, str(tmp_path))
    assert len(corpus) > 0 and not list(tmp_path.glob("*.npz*"))
    assert any("store failed" in r.getMessage() for r in caplog.records)


# --- the train step's hooks and the recipe through the CLI ----------------

TINY = ["model.resnet_conf_d_model=16", "model.resnet_conf_n_heads=2",
        "model.resnet_conf_n_layers=1", "model.compute_dtype=float32",
        "grid.cell_degrees=30", "window.window_seconds=0.2", "window.hop_seconds=0.2",
        "train.batch_size=4", "train.save_every_n_epochs=1"]
RECIPE = ["features.feature_set=mel_iv", "train.acs_augment=true",
          "targets.use_gaussian_augmentation=true", "train.specaugment_time_masks=2",
          "train.specaugment_freq_masks=2"]


class _LinearGrid(torch.nn.Module):
    """A stand-in for the flagship in the train step: (B, T, C, F) ->
    (B, T, M, G) logits through one linear layer."""

    def __init__(self, grid):
        super().__init__()
        self.m, self.g = grid.num_classes, grid.n_cells
        self.lin = torch.nn.Linear(64, self.m * self.g)

    def seed_dropout(self, seed):
        pass

    def forward(self, x):
        b, t = x.shape[:2]
        return self.lin(x.mean(dim=2)).view(b, t, self.m, self.g)


@pytest.mark.parametrize("override", [
    "train.acs_augment=true", "train.specaugment_time_masks=2",
    "train.specaugment_time_width=10", "train.specaugment_freq_masks=2",
    "train.specaugment_freq_width=4", "targets.use_gaussian_augmentation=true",
    "targets.sigma_azimuth=7.5", "targets.sigma_elevation=2.5",
    "targets.augmentation_seed=3", "data.cache_dir=./cache",
])
def test_recipe_fields_parse_as_in_jax(override):
    from seld_tpu.config import Config as JaxConfig
    from seld_tpu.config import config_to_dict
    from seld_tpu.config import parse_overrides as jax_parse

    key, _, _ = override.partition("=")
    section, field = key.split(".")
    assert getattr(getattr(pc.Config(), section), field) == \
        config_to_dict(JaxConfig())[section][field]  # the JAX default
    got = getattr(getattr(pc.parse_overrides(pc.Config(), [override]), section), field)
    assert got == getattr(getattr(jax_parse(JaxConfig(), [override]), section), field)


def test_hooks_see_the_whole_batch_in_order_and_repeat_per_step():
    cfg = pc.parse_overrides(pc.Config(), [*TINY, *RECIPE])
    model = _LinearGrid(cfg.grid)
    optimizer = make_optimizer(model.parameters(), 1e-3)
    seen = []

    def spatial(generator, mel, mask):
        seen.append(("spatial", mel.shape[0], torch.randint(0, 1 << 30, (1,),
                                                            generator=generator).item()))
        return mel, mask

    def inputs(generator, mel):
        seen.append(("input", mel.shape[0], None))
        return mel

    step = make_train_step(model, SELDLossFn(cfg.loss, cfg.grid), optimizer,
                           cfg.grid.num_classes, accum_steps=2, input_augment=inputs,
                           spatial_augment=spatial)
    state = create_train_state(model, optimizer)
    mel = torch.randn((2, 4, 7, 64))
    mask = torch.zeros((2, 4, cfg.grid.n_cells), dtype=torch.int16)
    for _ in range(2):
        state.step = 5
        step(state, mel, mask, None, (0, 1))
    assert [s[:2] for s in seen] == [("spatial", 2), ("input", 2)] * 2  # before the split
    assert seen[0][2] == seen[2][2]  # the draw follows (seed, epoch, step)


def test_acs_without_mel_iv_is_a_named_error_before_anything_is_cleared(tmp_path):
    from seld_tpu_torch.train.trainer import train_model

    cfg = pc.parse_overrides(pc.Config(), [*TINY, "train.acs_augment=true"])
    (tmp_path / "best").mkdir()
    with pytest.raises(ValueError, match="signed spatial features"):
        train_model(cfg, None, None, workdir=tmp_path, device="cpu")
    assert (tmp_path / "best").exists()


@pytest.fixture
def starss(tmp_path):
    """Synthetic WAV files in the STARSS22 layout: two train clips and one
    test clip; everything the test writes is removed."""
    cfg = pc.Config()
    synthetic_raw_files(tmp_path, cfg, n_files=2, seconds=1.0, seed=0, split_dirs=True)
    synthetic_raw_files(tmp_path / "staging", cfg, n_files=1, seconds=0.6, seed=1,
                        split_dirs=True)
    for sub in (cfg.data.audio_dirname, cfg.data.metadata_dirname):
        (tmp_path / "staging" / sub / "dev-train-sony").rename(tmp_path / sub / "dev-test-sony")
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_train_of_the_recipe_falls_and_resumes_exactly(starss, caplog):
    caplog.set_level(logging.INFO)
    cache = f"data.cache_dir={starss / 'cache'}"
    common = [*TINY, *RECIPE, cache]
    straight, split = starss / "straight", starss / "split"
    assert port_main(["train", "--device", "cpu", f"data.base_path={starss}", *common,
                      "train.num_epochs=2", f"data.checkpoint_dirname={straight.name}"]) == 0
    assert sum("Corpus cache stored" in r.getMessage() for r in caplog.records) == 2
    records = [json.loads(x) for x in (straight / "metrics.jsonl").read_text().splitlines()]
    losses = [r[s]["loss"] for r in records for s in ("train", "test")]
    assert np.isfinite(losses).all() and records[1]["train"]["loss"] < records[0]["train"]["loss"]

    caplog.clear()
    for extra in ([], ["--resume"]):
        assert port_main(["train", *extra, "--device", "cpu", f"data.base_path={starss}", *common,
                          f"train.num_epochs={1 + len(extra)}",
                          f"data.checkpoint_dirname={split.name}"]) == 0
    assert sum("Corpus cache hit" in r.getMessage() for r in caplog.records) == 4
    resumed = [json.loads(x) for x in (split / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in resumed] == [1, 2]
    assert resumed[1]["train"] == records[1]["train"] and resumed[1]["test"] == records[1]["test"]
