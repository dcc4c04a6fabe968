"""Attention parity: the port's plain attention (f32 scores) against JAX's
``_einsum_core`` and the Pallas flash kernel in interpret mode (as
tests/test_ops_attention.py runs it), at atol 2e-5. The CUDA flash kernel
is held against the plain version on the card in
tests/test_torch_kernels_gpu.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import segma_tpu.ops.attention as jax_attn
from segma_tpu_torch.ops import attention

ATOL = 2e-5  # the JAX suite's forward bar (tests/test_ops_attention.py)


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def _plain(q, k, v, sm, dtype=torch.float32):
    return attention.attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), sm, dtype
    ).float().numpy()


@pytest.mark.parametrize("s", [128, 199, 320, 1500])
def test_plain_matches_einsum_core(s):
    q, k, v = _qkv(1 if s == 1500 else 2, s, 2, 64)
    sm = 64**-0.5
    ref = np.asarray(jax_attn._einsum_core(q, k, v, sm, jnp.float32))
    np.testing.assert_allclose(_plain(q, k, v, sm), ref, atol=ATOL)


@pytest.mark.parametrize("s", [128, 199, 320], ids=["lane-exact", "fast-context", "padded-2.5x"])
def test_plain_matches_pallas_interpret(monkeypatch, s):
    monkeypatch.setattr(jax_attn, "_FORCE_FLASH", True)
    q, k, v = _qkv(2, s, 2, 64, seed=1)
    sm = 64**-0.5
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_attn.attention_core(q, k, v, sm_scale=sm, dtype=jnp.float32))
    np.testing.assert_allclose(_plain(q, k, v, sm), ref, atol=ATOL)


def test_plain_bf16_matches_einsum_core():
    """bf16 in and out: both round q*scale, the probabilities and the output
    to bf16, so they agree to one bf16 rounding (2**-8 relative)."""
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _qkv(2, 199, 2, 64, 2)))
    sm = 64**-0.5
    ref = np.asarray(jax_attn._einsum_core(q, k, v, sm, jnp.bfloat16).astype(jnp.float32))
    got = attention.attention_plain(
        *(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (q, k, v)),
        sm, torch.bfloat16,
    ).float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


def test_attention_core_routes_cpu_to_plain():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 17, 2, 64, 3))
    before = attention.launches
    out = attention.attention_core(q, k, v, sm_scale=0.125, dtype=torch.float32)
    assert attention.launches == before
    torch.testing.assert_close(out, attention.attention_plain(q, k, v, 0.125, torch.float32))


def test_kernel_wrapper_refuses_cpu_tensor():
    q = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attn_fwd(q, q, q, 0.125)
