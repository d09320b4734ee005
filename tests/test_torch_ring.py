"""Kernel K5, ring attention (seld_tpu_torch.ops.ring_attention), on the CPU:
the port's ring on a 4-process gloo group (model axis 4, the whole batch on
every rank) against seld_tpu's ring on make_mesh(n_data=2, n_model=4) at
the inputs of tests/test_pallas_kernels.py:421-465, values and all three
gradients at the JAX package's bars, bf16 within 0.05 of the float32
oracle; the virtual ring (n ranks in one process, as the card checks it)
bit-equal to the process-group ring; the plain per-chunk backward with a
given lse and delta against autograd. Nothing here imports JAX at module
level: the spawned workers import this module."""

import numpy as np
import pytest
import torch

from seld_tpu_torch.ops.flash_attention import (
    chunk_grads_reference,
    flash_attention_reference,
    row_delta,
)
from seld_tpu_torch.ops.ring_attention import (
    ring_flash_attention,
    virtual_ring_attention,
    virtual_ring_backward,
)
from tests.test_torch_parallel import one_torch_thread, run_ranks  # noqa: F401 (autouse)

B, H, T, D = 2, 4, 512, 64  # chunks of 128 over the 4-way model axis
N_MODEL = 4


def _inputs(seed: int):
    """q, k, v as tests/test_pallas_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3)]


def _ring_worker(rank, world, cases):
    """This rank's chunk of each (inputs, dtype) case through the
    process-group ring: out and the gradients of sum(out ** 2), as the JAX
    test differentiates."""
    from seld_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, world)
    t = T // world
    results = []
    for qkv, dtype in cases:
        leaves = [torch.from_numpy(x[:, :, rank * t:(rank + 1) * t].copy()).to(dtype)
                  .requires_grad_(True) for x in qkv]
        out = ring_flash_attention(*leaves, group=mesh.model_group)
        (out.float() ** 2).sum().backward()
        results.append({"out": out.detach(),
                        **{n: x.grad for n, x in zip(("dq", "dk", "dv"), leaves)}})
    return results


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """One 4-process gloo ring (model axis 4, the whole batch on every rank)
    over the float32 inputs of tests/test_pallas_kernels.py:421-465 and the
    bf16 ones of :529-549: per case, the ranks' results."""
    cases = [(_inputs(3), torch.float32), (_inputs(11), torch.bfloat16)]
    by_rank = run_ranks(_ring_worker, N_MODEL, tmp_path_factory.mktemp("ring"), cases)
    return {dtype: ([r[i] for r in by_rank], qkv) for i, (qkv, dtype) in enumerate(cases)}


def _jax_ring(qkv):
    """seld_tpu's ring on a (2, 4) mesh: out and the gradients of sum(out ** 2)."""
    import jax
    import jax.numpy as jnp

    from seld_tpu.ops.attention import attention_mesh, multi_head_attention
    from seld_tpu.parallel import make_mesh

    mesh = make_mesh(n_data=2, n_model=N_MODEL)
    q, k, v = (jnp.asarray(x) for x in qkv)

    def loss(a, bb, c):
        with attention_mesh(mesh, time_sharded=True):
            out = multi_head_attention(a, bb, c, use_flash=True, interpret=True)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _gather(results, key):
    return torch.cat([r[key] for r in results], dim=2)


def test_process_group_ring_matches_jax_ring_and_the_virtual_ring(ring_runs):
    """float32: out at rtol 2e-4 / atol 2e-5 and dq, dk, dv at 3e-4 against
    seld_tpu's ring (tests/test_pallas_kernels.py:421-465's bars); the
    virtual ring in this process bit-equal to the 4 processes, values and
    gradients."""
    results, qkv = ring_runs[torch.float32]
    want_out, want_grads = _jax_ring(qkv)
    np.testing.assert_allclose(_gather(results, "out").numpy(), want_out, rtol=2e-4, atol=2e-5)
    for name, want in zip(("dq", "dk", "dv"), want_grads):
        np.testing.assert_allclose(_gather(results, name).numpy(), want, rtol=3e-4, atol=3e-4,
                                   err_msg=name)

    chunks = [[torch.from_numpy(x).chunk(N_MODEL, dim=2)[r].contiguous() for r in
               range(N_MODEL)] for x in qkv]
    outs, lses = virtual_ring_attention(*chunks)
    grads = virtual_ring_backward(*chunks, [2.0 * o for o in outs], outs, lses)
    for r in range(N_MODEL):
        assert torch.equal(outs[r], results[r]["out"]), r
        for name, g in zip(("dq", "dk", "dv"), grads):
            assert torch.equal(g[r], results[r][name]), (r, name)


def test_bf16_ring_within_the_documented_tolerance(ring_runs):
    """bfloat16 through the process-group ring: each chunk's partial output
    is rounded to bf16 before the float32 merge, so the result is held
    within 0.05 of the float32 oracle (tests/test_pallas_kernels.py:529-549),
    and so are its gradients."""
    results, qkv = ring_runs[torch.bfloat16]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    want, _ = flash_attention_reference(*leaves)
    (want ** 2).sum().backward()
    got = _gather(results, "out")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.detach().numpy(), rtol=0.05, atol=0.05)
    for name, leaf in zip(("dq", "dk", "dv"), leaves):
        np.testing.assert_allclose(_gather(results, name).float().numpy(), leaf.grad.numpy(),
                                   rtol=0.05, atol=0.05, err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_virtual_ring_matches_whole_attention(n):
    """The virtual ring's out and global lse against the plain version over
    the whole T, its gradients against autograd's (float32: the same
    function, sums in another order)."""
    q, k, v = (torch.from_numpy(x[:, :, :128]) for x in _inputs(5))
    g = torch.from_numpy(_inputs(6)[0][:, :, :128])
    outs, lses = virtual_ring_attention(*(list(x.chunk(n, dim=2)) for x in (q, k, v)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want, lse = flash_attention_reference(*leaves)
    torch.testing.assert_close(torch.cat(outs, 2), want.detach(), rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(torch.cat([x.view(B, H, -1) for x in lses], 2),
                               lse.view(B, H, -1), rtol=2e-4, atol=2e-5)
    want.backward(g)
    grads = virtual_ring_backward(*(list(x.chunk(n, dim=2)) for x in (q, k, v)),
                                  list(g.chunk(n, dim=2)), outs, lses)
    for got, leaf in zip(grads, leaves):
        torch.testing.assert_close(torch.cat(got, 2), leaf.grad, rtol=3e-4, atol=3e-4)


def test_chunk_grads_reference_is_the_fa2_backward():
    """With the whole T as one chunk, the plain per-chunk backward given the
    forward's lse and delta = rowsum(g * out) is autograd's backward."""
    q, k, v = (torch.from_numpy(x[:, :, :64]).double() for x in _inputs(7))
    g = torch.from_numpy(_inputs(8)[0][:, :, :64]).double()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = flash_attention_reference(*leaves)
    out.backward(g)
    got = chunk_grads_reference(q, k, v, g, lse, row_delta(g, out.detach()), D ** -0.5)
    for a, leaf in zip(got, leaves):
        torch.testing.assert_close(a, leaf.grad, rtol=1e-6, atol=1e-6)


def test_ring_raises_on_unsupported_inputs():
    q = torch.zeros((1, 1, 8, 8))  # a head width K3 does not take
    with pytest.raises(ValueError, match="multiple of 16"):
        virtual_ring_attention([q], [q], [q])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        virtual_ring_attention([q.double()], [q.double()], [q.double()])
