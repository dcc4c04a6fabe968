"""Attention gradients: the port's plain backward and its ``FlashAttention``
autograd function (which takes the plain versions on CPU tensors) against
``jax.vjp`` of JAX's ``attention_core`` through the Pallas flash kernel in
interpret mode, as tests/test_ops_attention.py runs it, in f32 at atol
5e-5 (that suite's gradient bar). The CUDA backward kernels are held
against ``attention_bwd_plain`` on the card in tests/test_torch_kernels_gpu.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import segma_tpu.ops.attention as jax_attn
from segma_tpu_torch.ops import attention

ATOL = 5e-5  # tests/test_ops_attention.py::test_flash_grad_matches_einsum
SM = 64**-0.5


def _inputs(b, s, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, 64)).astype(np.float32) for _ in range(4)]


def _pallas_grads(monkeypatch, q, k, v, dout):
    monkeypatch.setattr(jax_attn, "_FORCE_FLASH", True)

    def f(qq, kk, vv):
        return jax_attn.attention_core(qq, kk, vv, sm_scale=SM, dtype=jnp.float32)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(dout))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("s", [128, 199], ids=["lane-exact", "hubert-4s"])
def test_bwd_plain_matches_pallas_grad(monkeypatch, s):
    q, k, v, dout = _inputs(2, s, 2, seed=s)
    _, ref = _pallas_grads(monkeypatch, q, k, v, dout)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = attention.attention_plain(tq, tk, tv, SM, torch.float32)
    lse = attention.attention_lse_plain(tq, tk, SM)
    got = attention.attention_bwd_plain(tq, tk, tv, out, lse, tdo, SM)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("s", [128, 199], ids=["lane-exact", "hubert-4s"])
def test_flash_attention_function_matches_pallas_grad(monkeypatch, s):
    q, k, v, dout = _inputs(2, s, 2, seed=10 + s)
    ref_out, ref = _pallas_grads(monkeypatch, q, k, v, dout)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (attention.launches, attention.bwd_launches)
    out = attention.FlashAttention.apply(tq, tk, tv, SM)
    out.backward(torch.from_numpy(dout))
    assert (attention.launches, attention.bwd_launches) == before  # CPU: no kernel
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=2e-5)
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("s", [1, 70, 199])
def test_lse_plain_matches_logsumexp_of_einsum_scores(s):
    q, k, _, _ = _inputs(2, s, 3, seed=20 + s)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) * SM, jnp.asarray(k))
    ref = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    got = attention.attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k), SM)
    assert got.shape == (2, 3, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_bwd_plain_equals_autograd_in_f64():
    """The step-by-step formulas are the gradient of ``attention_plain``."""
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((2, 37, 2, 64))) for _ in range(4))
    for x in (q, k, v):
        x.requires_grad_()
    out = attention.attention_plain(q, k, v, SM, torch.float64)
    ref = torch.autograd.grad(out, (q, k, v), dout)
    lse = attention.attention_lse_plain(q.detach(), k.detach(), SM)
    got = attention.attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(), lse,
                                        dout, SM)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-10)


def test_flash_attention_function_gradcheck_f64():
    rng = np.random.default_rng(4)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((1, 6, 2, 64))).requires_grad_() for _ in range(3)
    )
    assert torch.autograd.gradcheck(lambda a, b, c: attention.FlashAttention.apply(a, b, c, SM),
                                    (q, k, v))


def test_attention_core_cpu_stays_autograd_plain():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(1, 9, 2, 5)[:3])
    out = attention.attention_core(q, k, v, sm_scale=SM, dtype=torch.float32)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    out.sum().backward()
    assert all(torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0 for x in (q, v))


def test_backward_wrapper_refuses_cpu_tensor():
    q = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attn_bwd(q, q, q, q, lse, q, 0.125)
