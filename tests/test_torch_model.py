"""The port's ResNet50-Conformer against seld_tpu's, layer by layer and
whole, with the same weights carried across by
seld_tpu_torch.convert.state_dict_from_jax (eval mode, float32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import GridConfig, ModelConfig
from seld_tpu.models import build_model, init_variables
from seld_tpu.models.layers import ConformerBlock, GridHead
from seld_tpu_torch.config import ModelConfig as PortModelConfig
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.models import layers as port_layers

SMALL = dict(resnet_conf_d_model=64, resnet_conf_n_heads=4,
             resnet_conf_n_layers=1, compute_dtype="float32")
# the bar of tests/test_torch_import.py for this model: deep float32
# accumulation in another order (XLA vs ATen) drifts by a few 1e-5
ATOL, RTOL = 5e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one intra-op thread. The port's CPU
    tests use small shapes, which torch's threads barely speed up, and
    under pytest-xdist every worker's threads contend for the same cores:
    a six-worker run of the port's test files took 3x as long with
    torch's default thread count. Modules that import this fixture get it
    too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(variables, seed=0):
    """numpy copy of flax variables with random norm scales and biases
    and BatchNorm statistics (mean N(0, 0.05), var U(0.5, 1.5)), so that
    a layout or naming mistake cannot hide behind the 0/1 init."""
    rng = np.random.default_rng(seed)

    def visit(path, x):
        x = np.asarray(x, np.float32)
        keys = [getattr(p, "key", str(p)) for p in path]
        leaf = keys[-1]
        if keys[0] == "batch_stats":
            if leaf == "mean":
                return rng.normal(0, 0.05, x.shape).astype(np.float32)
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if leaf == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if leaf == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(visit, variables)


@pytest.fixture(scope="module")
def flagship():
    """(JAX model, numpy variables, port model) at the small size."""
    cfg = ModelConfig(**SMALL)
    model = build_model(cfg, GridConfig())
    x0 = jnp.zeros((2, 8, 4, 64), jnp.float32)
    variables = randomize(init_variables(model, jax.random.PRNGKey(0), x0))
    port = build_port_model(PortModelConfig(**SMALL), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables, PortModelConfig(**SMALL)))
    return model, variables, port


def test_flagship_matches_jax(flagship):
    model, variables, port = flagship
    x = np.random.default_rng(1).standard_normal((2, 8, 4, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 14, 648)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _sub(variables, name):
    return {col: variables[col][name] for col in variables if name in variables[col]}


def _port_sub_state(port, prefix):
    return {k[len(prefix):]: v for k, v in port.state_dict().items()
            if k.startswith(prefix)}


def test_conformer_block_matches_jax(flagship):
    _, variables, port = flagship
    block = ConformerBlock(d_model=64, n_heads=4, d_ff=256, kernel_size=31)
    x = np.random.default_rng(2).standard_normal((2, 8, 64)).astype(np.float32)
    want = np.asarray(block.apply(_sub(variables, "block_0"), x, train=False))
    port_block = port_layers.ConformerBlock(64, 4, 256, 31)
    port_block.load_state_dict(_port_sub_state(port, "blocks.0."))
    with torch.no_grad():
        got = port_block.eval()(torch.from_numpy(x)).numpy()
    # one block: float32 sums in another order, well inside 1e-4
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_grid_head_matches_jax(flagship):
    _, variables, port = flagship
    head = GridHead(hidden=1024, grid_cells=648, num_classes=14)
    x = np.random.default_rng(3).standard_normal((2, 8, 64)).astype(np.float32)
    want = np.asarray(head.apply(_sub(variables, "GridHead_0"), x, train=False))
    port_head = port_layers.GridHead(64, 1024, 648, 14)
    port_head.load_state_dict(_port_sub_state(port, "head."))
    with torch.no_grad():
        got = port_head.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8, 14, 648)
    # two float32 products of depth 64 and 1024
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_converter_raises_on_missing_key(flagship):
    _, variables, _ = flagship
    broken = jax.tree.map(lambda x: x, variables)
    del broken["params"]["GridHead_0"]["logits"]["bias"]
    with pytest.raises(KeyError, match="GridHead_0/logits/bias"):
        state_dict_from_jax(broken, PortModelConfig(**SMALL))


def test_converter_raises_on_unknown_key(flagship):
    _, variables, _ = flagship
    extra = jax.tree.map(lambda x: x, variables)
    extra["params"]["block_1"] = extra["params"]["block_0"]
    with pytest.raises(KeyError, match="does not know"):
        state_dict_from_jax(extra, PortModelConfig(**SMALL))
