"""The port's multi-GPU layer on the CPU, over gloo process groups of 2 and
4 processes: the process mesh, the sequence-parallel collectives (halo
exchange, all-reduce, all-gather over time) with their gradients against
unsharded autograd, the sharded tiny Conformer train step (2 x 2 mesh,
time split over the model axis, ring attention K5) against the port's
one-device step and against seld_tpu's step on the same converted weights,
the trainer's refusals, a checkpoint written by a sharded run resumed by a
one-device run, and the copies of seld_tpu.parallel.multihost's pure
helpers.

Workers are spawned processes (`run_ranks`) that meet at a file:// store
under the test's tmp_path, run torch on one thread, and are killed when
their group outlives its timeout. Nothing here imports JAX at module level:
the workers import this module."""

import datetime
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from seld_tpu_torch.parallel.multihost import local_batch_size, process_local_indices

GROUP_TIMEOUT_S = 240.0  # one spawned group, start-up included


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as every port test module runs (see
    tests/test_torch_model.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bootstrap(rank, world, store, fn, args, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = fn(rank, world, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path: Path, *args, timeout: float = GROUP_TIMEOUT_S):
    """fn(rank, world, *args) in `world` spawned processes of one gloo group;
    the list of their results by rank. A group that outlives `timeout` is
    killed and fails the test."""
    out = Path(tmp_path) / f"ranks_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    store = out / "store"
    ctx = mp.start_processes(_bootstrap, args=(world, str(store), fn, args, str(out)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"process group of {world} outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# -- the copies of seld_tpu.parallel.multihost's helpers (tests/test_multihost.py)

@pytest.mark.parametrize("n_proc", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("n_items", [0, 1, 8, 23, 64])
def test_process_local_indices_partition(n_proc, n_items):
    chunks = [process_local_indices(n_items, process_id=p, num_processes=n_proc)
              for p in range(n_proc)]
    merged = np.concatenate(chunks) if chunks else np.array([])
    np.testing.assert_array_equal(merged, np.arange(n_items))
    sizes = [len(c) for c in chunks]
    assert max(sizes) - min(sizes) <= 1  # balanced


def test_process_local_indices_default_process():
    # without a process group the one process covers all
    np.testing.assert_array_equal(process_local_indices(5), np.arange(5))


def test_local_batch_size_single_process():
    assert local_batch_size(16) == 16


def test_local_batch_size_divisibility():
    assert local_batch_size(16, num_processes=4) == 4
    with pytest.raises(AssertionError):
        local_batch_size(6, num_processes=4)


# -- the mesh config

def test_mesh_config_fields_and_refusals():
    from seld_tpu_torch import config as pc
    from seld_tpu_torch.parallel.mesh import mesh_from_config

    cfg = pc.parse_overrides(pc.Config(), ["mesh.enable=on", "mesh.data_axis=2",
                                           "mesh.model_axis=2", "mesh.shard_time=true"])
    assert (cfg.mesh.enable, cfg.mesh.data_axis, cfg.mesh.model_axis,
            cfg.mesh.shard_time) == ("on", 2, 2, True)
    assert pc.config_from_dict(pc.config_to_dict(cfg)) == cfg
    # a JAX config dict with the unported ZeRO-1 / FSDP switches still loads
    stored = pc.config_to_dict(cfg)
    stored["mesh"].update(shard_opt_state=True, shard_params=False)
    assert pc.config_from_dict(stored).mesh == cfg.mesh
    for field in ("mesh.shard_opt_state=true", "mesh.shard_params=true"):
        with pytest.raises(KeyError, match="unknown config field"):
            pc.parse_overrides(pc.Config(), [field])
    tp = pc.parse_overrides(pc.Config(), ["mesh.enable=on", "mesh.model_axis=2"]).mesh
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        mesh_from_config(tp, torch.device("cpu"))
    bad = pc.parse_overrides(pc.Config(), ["mesh.enable=always"]).mesh
    with pytest.raises(ValueError, match="mesh.enable"):
        mesh_from_config(bad, torch.device("cpu"))
    assert mesh_from_config(pc.Config().mesh, torch.device("cpu")) is None  # auto, 1 process
    assert not dist.is_initialized()


# -- the collectives against unsharded autograd

def _collectives_worker(rank, world, x_np, w_np, width):
    from seld_tpu_torch.parallel.mesh import make_mesh
    from seld_tpu_torch.parallel.sequence import all_gather_time, all_reduce_sum, halo_exchange

    mesh = make_mesh(1, world)
    assert (mesh.data_rank, mesh.model_rank) == (0, rank)
    t = x_np.shape[2] // world
    x = torch.from_numpy(x_np[:, :, rank * t:(rank + 1) * t].copy()).requires_grad_(True)
    w = torch.from_numpy(w_np)
    padded = halo_exchange(x, 2, width, 0.0, mesh)
    conv = torch.nn.functional.conv1d(padded, w)  # a 'same' conv over the global time
    pooled = torch.nn.functional.max_pool1d(halo_exchange(x, 2, 1, float("-inf"), mesh), 3, 1)
    total = all_reduce_sum(x.square().sum(dim=(0, 2)))  # per channel, over the world
    gathered = all_gather_time(x, 2, mesh)
    loss = (conv * conv.detach().sin()).sum() + pooled.cos().sum() \
        + (total * torch.arange(1.0, 1.0 + total.numel())).sum() / world \
        + (gathered.tanh() * gathered.detach()).sum() / world
    loss.backward()
    return {"conv": conv.detach(), "pooled": pooled.detach(), "total": total.detach(),
            "gathered": gathered.detach(), "grad": x.grad}


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_their_gradients_match_unsharded(world, tmp_path):
    """Halo exchange (zeros and -inf at the window's ends), all_reduce_sum
    and all_gather_time: every rank's values and the gradient of a loss
    over all three against one process's autograd on the whole tensor
    (float64: the same sums in another order)."""
    rng = np.random.default_rng(world)
    width = 3
    x_np = rng.standard_normal((2, 3, 8 * world))
    w_np = rng.standard_normal((3, 3, 2 * width + 1))
    results = run_ranks(_collectives_worker, world, tmp_path, x_np, w_np, width)
    x = torch.from_numpy(x_np).requires_grad_(True)
    conv = torch.nn.functional.conv1d(x, torch.from_numpy(w_np), padding=width)
    pooled = torch.nn.functional.max_pool1d(x, 3, 1, padding=1)
    total = x.square().sum(dim=(0, 2))
    loss = (conv * conv.detach().sin()).sum() + pooled.cos().sum() \
        + (total * torch.arange(1.0, 1.0 + total.numel())).sum() + (x.tanh() * x.detach()).sum()
    loss.backward()
    t = x_np.shape[2] // world
    for rank, res in enumerate(results):
        chunk = slice(rank * t, (rank + 1) * t)
        torch.testing.assert_close(res["conv"], conv.detach()[:, :, chunk])
        torch.testing.assert_close(res["pooled"], pooled.detach()[:, :, chunk])
        torch.testing.assert_close(res["total"], total.detach())
        torch.testing.assert_close(res["gathered"], x.detach())
        torch.testing.assert_close(res["grad"], x.grad[:, :, chunk])


# -- the sharded train step

TINY_CONFORMER = ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                  "model.conf_d_model=32", "model.conf_n_heads=2", "model.conf_n_layers=1",
                  "model.compute_dtype=float32"]
T_RING = 512  # global frames: the ring engages (FLASH_MIN_SEQ_LEN), 256 a model rank
B_STEP = 4  # 2 rows a data rank


def _port_step(overrides, weights, batch, dropout, mesh=None):
    """One port train step from `weights` on the global `batch`: (loss, state
    dict after Adam, gradients by name)."""
    from seld_tpu_torch import config as pc
    from seld_tpu_torch.losses import SELDLossFn
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.models.layers import Dropout
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    cfg = pc.parse_overrides(pc.Config(), overrides)
    model = build_model(cfg.model, cfg.grid, device="cpu", seed=None)
    model.load_state_dict(weights)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = dropout
    optimizer = make_optimizer(model.parameters(), 1e-3, 1e-4)
    step = make_train_step(model, SELDLossFn(cfg.loss, cfg.grid), optimizer,
                           cfg.grid.num_classes, mesh=mesh, time_sharded=mesh is not None)
    _, metrics = step(create_train_state(model, optimizer), *batch, (0, 1))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics["loss"].item(), model.state_dict(), grads


def _sharded_step_worker(rank, world, overrides, weights, batch):
    import seld_tpu_torch.ops.attention as attention
    from seld_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    rings = []
    real = attention.ring_flash_attention

    def counted(*args, **kwargs):
        rings.append(args[0].shape[2])
        return real(*args, **kwargs)

    attention.ring_flash_attention = counted
    out = {}
    for dropout in (0.3, 0.0):
        loss, state, _ = _port_step(overrides, weights, batch, dropout, mesh)
        out[dropout] = {"loss": loss, "state": state}
    out["rings"] = rings
    return out


def _assert_step_close(got_state, want_state, want_grads, weights):
    """Parameters after one Adam step at the backbone tests' eval bar (5e-4
    absolute, 1e-3 relative), except where the decayed gradient g + wd p is
    within the gradient bar of its tensor (1e-3 of its largest): there its
    sign is rounding noise and the step must only be at most 2 lr (see
    tests/test_torch_backbones.py::test_one_adam_step_of_the_crnn_matches_optax);
    BatchNorm statistics at 1e-5."""
    for name, ref in want_state.items():
        got = got_state[name]
        if name not in want_grads:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5, msg=name)
            continue
        g = want_grads[name] + 1e-4 * weights[name]
        noise = g.abs() <= 1e-3 * g.abs().max()
        assert ((got - ref).abs()[noise] <= 2e-3 + 5e-4).all(), name
        np.testing.assert_allclose(got[~noise].numpy(), ref[~noise].numpy(), atol=5e-4,
                                   rtol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def step_case():
    """Random JAX variables of the tiny Conformer, their port weights and a
    seeded global batch (numpy), shared by the sharded-step tests."""
    import jax.numpy as jnp

    from seld_tpu.config import Config, parse_overrides
    from seld_tpu.models import build_model
    from seld_tpu_torch import config as pc
    from seld_tpu_torch.convert import state_dict_from_jax
    from tests.test_torch_backbones import random_variables

    cfg = parse_overrides(Config(), TINY_CONFORMER)
    model = build_model(cfg.model, cfg.grid)
    variables = random_variables(model, jnp.zeros((B_STEP, 8, 4, 64), jnp.float32), seed=7)
    weights = state_dict_from_jax(variables, pc.parse_overrides(pc.Config(),
                                                                TINY_CONFORMER).model)
    rng = np.random.default_rng(8)
    mel = rng.standard_normal((B_STEP, T_RING, 4, 64)).astype(np.float32)
    bits = rng.integers(0, 1 << 13, (B_STEP, T_RING, cfg.grid.n_cells)).astype(np.uint16)
    mask = np.where(rng.random(bits.shape) < 0.97, 0, bits).astype(np.uint16)
    em = np.array([1.0, 1.0, 1.0, 0.0], np.float32)  # a padded tail row
    batch = (torch.from_numpy(mel), torch.from_numpy(mask.view(np.int16)), torch.from_numpy(em))
    return model, variables, weights, batch, (mel, mask, em)


def test_sharded_conformer_step_matches_one_device_and_jax(step_case, tmp_path, monkeypatch):
    """The tiny Conformer's train step on a 2 x 2 gloo mesh (two data ranks
    of two rows, the 512 frames split over two model ranks: halos, global
    BatchNorm, the ring K5, global loss counts, summed gradients) against
    the port's one-device step from the same weights and batch, with dropout
    0.3 (global-shape masks) and 0: the loss at rtol 2e-4 (the JAX package's
    sequence-parallel step bar, tests/test_pallas_kernels.py:467-526) and
    every parameter after Adam at the backbone tests' bars. Then at dropout
    0 against seld_tpu's one-device step on the same weights (optax Adam,
    flax with a two-pass variance as the port's parity tests run it), which
    tests/test_pallas_kernels.py holds equal to JAX's own sharded step."""
    import jax
    import jax.numpy as jnp
    import optax

    from seld_tpu.config import Config, parse_overrides
    from seld_tpu.losses import SELDLossFn as JaxLoss
    from seld_tpu.train.optimizer import make_optimizer as jax_optimizer
    from seld_tpu_torch import config as pc
    from seld_tpu_torch.convert import state_dict_from_jax
    from tests.test_torch_backbones import two_pass_variance

    model, variables, weights, batch, (mel, mask, em) = step_case
    results = run_ranks(_sharded_step_worker, 4, tmp_path, TINY_CONFORMER, weights, batch)
    for rank, res in enumerate(results):
        # one ring per conformer block and call, on 256-frame chunks
        assert res["rings"] == [T_RING // 2] * 2, rank
    for dropout in (0.3, 0.0):
        loss, state, grads = _port_step(TINY_CONFORMER, weights, batch, dropout)
        for rank, res in enumerate(results):
            got = res[dropout]
            np.testing.assert_allclose(got["loss"], loss, rtol=2e-4)
            _assert_step_close(got["state"], state, grads, weights)
            if rank:  # every replica took the same step
                for name, value in got["state"].items():
                    torch.testing.assert_close(value, results[0][dropout]["state"][name],
                                               rtol=0, atol=0)

    cfg = parse_overrides(Config(), TINY_CONFORMER)
    jmodel = model.clone(dropout=0.0)
    loss_fn = JaxLoss(cfg.loss, cfg.grid)
    two_pass_variance(monkeypatch)

    def loss(params):
        out, upd = jmodel.apply({**variables, "params": params}, mel, train=True,
                                mutable=["batch_stats"])
        total, _ = loss_fn.from_bitmask(out, jnp.asarray(mask), jnp.asarray(em))
        return total, (total, upd)

    grads, (total, updates) = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    opt = jax_optimizer(1e-3, 1e-4)
    step, _ = opt.update(grads, opt.init(variables["params"]), variables["params"])
    pcfg = pc.parse_overrides(pc.Config(), TINY_CONFORMER).model
    want = state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": optax.apply_updates(variables["params"], step), **updates}), pcfg)
    want_grads = {k: v for k, v in state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": grads, "batch_stats": variables["batch_stats"]}), pcfg).items()
        if "running_" not in k}
    for res in results:
        np.testing.assert_allclose(res[0.0]["loss"], float(total), rtol=2e-4)
        _assert_step_close(res[0.0]["state"], want, want_grads, weights)


# -- the trainer

def _trainer_cfg(extra):
    from seld_tpu_torch import config as pc

    return pc.parse_overrides(pc.Config(), [
        *TINY_CONFORMER, "window.hop_seconds=4.0", "train.batch_size=4",
        "train.num_epochs=1", "train.save_every_n_epochs=1", *extra])


@pytest.mark.parametrize("extra,err,match", [
    (["model.model_type=crnn", "window.window_seconds=0.64", "mesh.model_axis=2"],
     ValueError, "recurrent crnn"),
    (["model.model_type=cnn", "window.window_seconds=0.64", "mesh.model_axis=2"],
     NotImplementedError, "ROADMAP item 10"),
    (["window.window_seconds=0.66", "mesh.model_axis=2"], ValueError, "must divide by"),
    (["window.window_seconds=0.4", "mesh.model_axis=2"], ValueError, "widest halo"),
    (["window.window_seconds=0.64", "mesh.model_axis=2", "mesh.shard_time=false"],
     NotImplementedError, "tensor parallelism"),
])
def test_trainer_refuses_what_the_jax_trainer_refuses(extra, err, match, tmp_path):
    """The CRNN under shard_time, a window that does not divide over the
    model axis, chunks narrower than the depthwise convolution's halo (15
    frames: 20 frames over 2), an unported backbone and tensor parallelism:
    named errors before any process group is joined."""
    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.train.trainer import train_model

    cfg = _trainer_cfg(["mesh.enable=on", "mesh.shard_time=true", *extra,
                        f"data.base_path={tmp_path}"])
    corpus = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=0, device="cpu")
    with pytest.raises(err, match=match):
        train_model(cfg, corpus, corpus, device="cpu")
    assert not dist.is_initialized()


def _sharded_train_worker(rank, world, overrides):
    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.train.trainer import train_model

    cfg = _trainer_cfg(overrides)
    train = synthetic_corpus(cfg, n_files=1, seconds=4.0, seed=0, device="cpu")
    test = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=1, train=False, device="cpu")
    _, history = train_model(cfg, train, test, device="cpu")
    return history


def test_sharded_checkpoint_resumes_in_a_one_device_run(tmp_path):
    """One epoch of the tiny Conformer on a 1 x 2 mesh (time split), the
    best checkpoint chosen on the DCASE2022 SELD error (the metric eval step
    gathers the ranks' decoded grids), written by rank 0 alone: its losses
    and validation metric are the one-device run's (rtol 1e-5: sums in
    another order), and a one-device run resumes from its rolling
    checkpoint into the second epoch. Every rank holds the whole state, so
    the file is a one-device checkpoint."""
    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.train.checkpoint import load_checkpoint
    from seld_tpu_torch.train.trainer import train_model

    base = [f"data.base_path={tmp_path}", "window.window_seconds=0.64",
            "train.select_metric=seld_error"]
    histories = run_ranks(_sharded_train_worker, 2, tmp_path, [
        *base, "mesh.enable=on", "mesh.model_axis=2", "mesh.shard_time=true"])
    assert histories[0]["train_losses"] == histories[1]["train_losses"]
    one = _sharded_train_worker(0, 1, [*base, "data.checkpoint_dirname=one"])
    for key in ("train_losses", "test_losses", "val_metric"):
        np.testing.assert_allclose(histories[0][key], one[key], rtol=1e-5, err_msg=key)
    work = tmp_path / "checkpoints"
    assert len((work / "metrics.jsonl").read_text().splitlines()) == 1
    _, state, epoch = load_checkpoint(work / "rolling" / "epoch_0001.pt")
    assert epoch == 1 and not any(k.startswith("module.") for k in state)

    cfg = _trainer_cfg([*base, "train.num_epochs=2"])
    train = synthetic_corpus(cfg, n_files=1, seconds=4.0, seed=0, device="cpu")
    test = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=1, train=False, device="cpu")
    _, history = train_model(cfg, train, test, resume=True, device="cpu")
    assert history["total_epochs"] == 2 and len(history["train_losses"]) == 1
    assert len((work / "metrics.jsonl").read_text().splitlines()) == 2
