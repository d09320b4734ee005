"""Kernel K5, ring attention (seld_tpu_torch.ops.ring_attention), on the CPU:
the port's ring on a 4-process gloo group (model axis 4, the whole batch on
every rank) against seld_tpu's ring on make_mesh(n_data=2, n_model=4) at
the inputs of tests/test_pallas_kernels.py:421-465, values and all three
gradients at the JAX package's bars, bf16 within 0.05 of the float32
oracle; the virtual ring (n ranks in one process, as the card checks it)
bit-equal to the process-group ring, and at one rank to the plain
attention; the plain versions of the kernels' ring modes against the
chunk attention followed by a float32 merge or sum; the ring's schedule of
modes; the plain per-chunk backward with a given lse and delta against
autograd. Nothing here imports JAX at module level: the spawned workers
import this module."""

import numpy as np
import pytest
import torch

from seld_tpu_torch.ops import ring_attention
from seld_tpu_torch.ops.flash_attention import (
    _empty_bthd,
    chunk_grads_reference,
    chunk_partials_reference,
    flash_attention_reference,
    row_delta,
)
from seld_tpu_torch.ops.ring_attention import (
    _merge,
    dkv_step_reference,
    dq_step_reference,
    forward_step_reference,
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
    """bfloat16 through the process-group ring: the inputs and the
    probabilities are bf16, so the result is held within 0.05 of the
    float32 oracle (tests/test_pallas_kernels.py:529-549), and so are its
    gradients."""
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


# The kernels' ring modes hold the chunk's result in float32 where the
# composition they replace rounded it to the inputs' dtype first: in bf16
# each chunk's part may differ by one bf16 rounding, at most 2^-8 of its
# size (7 stored mantissa bits, round to nearest).
BF16_PART = 2.0 ** -8


def _small(dtype, seed: int, t: int = 64):
    """q, k, v and a cotangent of (B, H, t, 64) from numpy, in dtype."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, t, D)).astype(np.float32)).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_step_matches_the_reference_then_merge(dtype):
    """Two forward steps of a lane (first: write; second: read and merge)
    against the chunk attention followed by a float32 merge from -inf and
    zeros: equal in float32; in bf16 lse equal and the running output
    within one bf16 rounding of each chunk's output, and the final out
    (final=True) the running output rounded."""
    q, k, v, _ = _small(dtype, seed=30)
    scale = D ** -0.5
    chunks = list(zip(k.chunk(2, dim=2), v.chunk(2, dim=2)))
    run = torch.zeros((B, H, 64, D))
    lse = torch.full((B * H, 64), float("-inf"))
    parts = []
    for k_c, v_c in chunks:
        o_c, lse_c = flash_attention_reference(q, k_c, v_c, scale)
        parts.append(o_c.float())
        run, lse = _merge(run, lse, o_c, lse_c)

    out, got_lse = _empty_bthd(q), torch.empty((B * H, 64))
    got_run = _empty_bthd(q, torch.float32)
    forward_step_reference(q, *chunks[0], scale, out, got_lse, got_run, False, False)
    forward_step_reference(q, *chunks[1], scale, out, got_lse, got_run, True, False)
    assert torch.equal(got_lse, lse)
    if dtype == torch.float32:
        assert torch.equal(got_run, run)
    else:
        bar = BF16_PART * torch.maximum(parts[0].abs(), parts[1].abs()) + 1e-7
        assert ((got_run - run).abs() <= bar).all()
    ended_run = got_run.clone()
    forward_step_reference(q, *chunks[0], scale, out, got_lse, got_run, False, False)
    forward_step_reference(q, *chunks[1], scale, out, got_lse, got_run, True, True)
    assert torch.equal(out, ended_run.to(dtype)) and out.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_steps_match_chunk_grads_then_add(dtype):
    """dq of one query chunk over two key chunks, and dk, dv of one key
    chunk over two query chunks (the travelling accumulator), through the
    plain dQ and dK/dV steps against chunk_grads_reference's rounded parts
    added in float32: equal in float32; in bf16 within one bf16 rounding of
    each part; the final dq the running sum rounded."""
    q, k, v, g = _small(dtype, seed=31)
    scale = D ** -0.5
    out, lse = flash_attention_reference(q, k, v, scale)
    delta = row_delta(g, out)
    lse = lse.view(B, H, 64)
    qs, gs, outs, lses, deltas = (list(x.chunk(2, dim=2)) for x in (q, g, out, lse, delta))
    ks, vs = k.chunk(2, dim=2), v.chunk(2, dim=2)

    dq_parts = [chunk_partials_reference(qs[0], ks[c], vs[c], gs[0], lses[0], deltas[0],
                                         scale)[0] for c in range(2)]
    want_dq = sum(chunk_grads_reference(qs[0], ks[c], vs[c], gs[0], lses[0], deltas[0],
                                        scale)[0].float() for c in range(2))
    dq, dq_run = _empty_bthd(qs[0]), _empty_bthd(qs[0], torch.float32)
    for c in range(2):
        dq_step_reference(qs[0], ks[c], vs[c], gs[0], outs[0], lses[0], scale, deltas[0], dq,
                          dq_run, c > 0, False)
    kv_parts = [chunk_partials_reference(qs[i], ks[0], vs[0], gs[i], lses[i], deltas[i],
                                         scale)[1:] for i in range(2)]
    want_kv = [sum(chunk_grads_reference(qs[i], ks[0], vs[0], gs[i], lses[i], deltas[i],
                                         scale)[j].float() for i in range(2)) for j in (1, 2)]
    acc = [torch.empty((B, 32, H, D)) for _ in range(2)]
    for i in range(2):
        dkv_step_reference(qs[i], ks[0], vs[0], gs[i], lses[i], deltas[i], scale, None, None,
                           acc[0].transpose(1, 2), acc[1].transpose(1, 2), i > 0, False)
    got_kv = [a.transpose(1, 2) for a in acc]
    if dtype == torch.float32:
        assert torch.equal(dq_run, want_dq)
        assert all(torch.equal(a, b) for a, b in zip(got_kv, want_kv))
    else:
        bar = BF16_PART * (dq_parts[0].abs() + dq_parts[1].abs()) + 1e-7
        assert ((dq_run - want_dq).abs() <= bar).all()
        for j in range(2):
            bar = BF16_PART * (kv_parts[0][j].abs() + kv_parts[1][j].abs()) + 1e-7
            assert ((got_kv[j] - want_kv[j]).abs() <= bar).all(), j
    ended = dq_run.clone()
    for c in range(2):
        dq_step_reference(qs[0], ks[c], vs[c], gs[0], outs[0], lses[0], scale, deltas[0], dq,
                          dq_run, c > 0, c == 1)
    assert torch.equal(dq, ended.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_virtual_ring_at_one_rank_is_the_plain_attention_bit_for_bit(dtype):
    """At n = 1 the ring is one step in K3's own mode: out and lse are
    flash_attention_reference's bits, dq, dk and dv chunk_grads_reference's
    with the ring's own lse and delta."""
    q, k, v, g = _small(dtype, seed=32, t=48)
    (out,), (lse,) = virtual_ring_attention([q], [k], [v])
    want, want_lse = flash_attention_reference(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    grads = virtual_ring_backward([q], [k], [v], [g], [out], [lse])
    want = chunk_grads_reference(q, k, v, g, lse, row_delta(g, out), D ** -0.5)
    for (got,), w in zip(grads, want):
        assert torch.equal(got, w)


def test_ring_schedule_reads_from_the_second_step_and_finishes_on_the_last(monkeypatch):
    """The modes the ring hands each step at n = 3 (the kernels get the
    same): forward and dQ write on the first step, read after it and store
    the result on the last; dK/dV reads from the second step and never
    finishes (its accumulator travels home and is cast there); every dQ
    launch of a step comes before its dK/dV launches; n x n of each."""
    calls = []

    def recording(kind, fn, read_at, final_at):
        def step(*args):
            calls.append((kind, args[read_at], args[final_at]))
            return fn(*args)
        return step

    monkeypatch.setattr(ring_attention, "_steps", lambda q, plain: (
        recording("fwd", forward_step_reference, 7, 8),
        recording("dq", dq_step_reference, 10, 11),
        recording("dkv", dkv_step_reference, 11, 12)))
    q, k, v, g = _small(torch.float32, seed=33, t=48)
    chunks = [list(x.chunk(3, dim=2)) for x in (q, k, v)]
    outs, lses = virtual_ring_attention(*chunks)
    grads = virtual_ring_backward(*chunks, list(g.chunk(3, dim=2)), outs, lses)
    fwd = [c[1:] for c in calls if c[0] == "fwd"]
    assert fwd == [(False, False)] * 3 + [(True, False)] * 3 + [(True, True)] * 3
    bwd = [c for c in calls if c[0] != "fwd"]
    assert [c[0] for c in bwd] == (["dq"] * 3 + ["dkv"] * 3) * 3
    assert [c[1:] for c in bwd if c[0] == "dq"] == fwd
    assert [c[1:] for c in bwd if c[0] == "dkv"] == [(False, False)] * 3 + [(True, False)] * 6
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want, _ = flash_attention_reference(*leaves)
    want.backward(g)
    torch.testing.assert_close(torch.cat(outs, 2), want.detach(), rtol=2e-4, atol=2e-5)
    for got, leaf in zip(grads, leaves):
        torch.testing.assert_close(torch.cat(got, 2), leaf.grad, rtol=3e-4, atol=3e-4)
