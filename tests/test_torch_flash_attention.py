"""The port's flash attention (plain versions and wrapper) against JAX.

The same numpy inputs go through
``horovod_tpu_torch.kernels.flash_attention`` on the CPU (its plain
versions: the CUDA kernels run only on the card, where ``chip_smoke.py``
holds them against these) and through

- the JAX package's ``_scaled_dot_attention`` (its einsum path, which the
  CPU takes), forward and ``jax.vjp``;
- the library TPU flash attention that ``_scaled_dot_attention`` reaches on
  a TPU (``jax.experimental.pallas.ops.tpu.flash_attention``, three
  ``pallas_call``s), run in TPU interpret mode, forward, its ``l``/``m``
  residuals and ``jax.vjp``.

Tolerances: fp32 rtol 1e-5 / atol 1e-5 (the same arithmetic summed in
another order); bf16 one bf16 rounding step of the output's scale (both
sides round the probabilities and the output to bf16, at places that may
differ by one rounding of an fp32 sum).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as lib_fa

from horovod_tpu.models.transformer import _scaled_dot_attention
from horovod_tpu_torch.kernels import flash_attention as fa

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, seed=0, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _bhsd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_jax_scaled_dot_attention(dtype, causal):
    b, s, h, d = 2, 48, 3, 16
    q, k, v = _inputs((b, s, h, d), seed=1, n=3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    expected = np.asarray(_scaled_dot_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), causal, d)
        .astype(jnp.float32))
    o, lse = fa.attention_reference(*_torch((q, k, v), tdt), causal,
                                    d ** -0.5)
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (b, h, s)
    if dtype == "float32":
        np.testing.assert_allclose(o.numpy(), expected, **TOL)
    else:
        scale = np.abs(expected).max()
        np.testing.assert_allclose(o.float().numpy(), expected, rtol=0,
                                   atol=scale * 2.0 ** -7)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_match_library_tpu_kernel_in_interpret_mode(causal):
    """The forward, lse = m + log(l) from the kernel's residuals, and the
    gradients of the library's dK/dV and dQ kernels, at (1, 2, 128, 64)."""
    b, s, h, d = 1, 128, 2, 64
    scale = d ** -0.5
    q, k, v, do = _inputs((b, s, h, d), seed=2)
    blocks = lib_fa.BlockSizes.get_default(b, h, s, s, d)
    with pltpu.force_tpu_interpret_mode():
        _, l_res, m_res = lib_fa._flash_attention(
            _bhsd(q), _bhsd(k), _bhsd(v), None, None, True, causal, scale,
            blocks, False)
        o_lib, vjp = jax.vjp(
            lambda q_, k_, v_: lib_fa.flash_attention(
                q_, k_, v_, causal=causal, sm_scale=scale),
            _bhsd(q), _bhsd(k), _bhsd(v))
        grads_lib = vjp(_bhsd(do))
    tq, tk, tv, tdo = _torch((q, k, v, do))
    o, lse = fa.attention_reference(tq, tk, tv, causal, scale)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(o_lib).transpose(0, 2, 1, 3), **TOL)
    lse_lib = np.asarray(m_res) + np.log(np.asarray(l_res))   # [b, h, s]
    np.testing.assert_allclose(lse.numpy(), lse_lib, **TOL)
    grads = fa.attention_bwd_reference(tq, tk, tv, o, lse, tdo, causal, scale)
    for name, got, want in zip("qkv", grads, grads_lib):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).transpose(0, 2, 1, 3),
                                   err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_autograd_through_plain_forward(causal):
    b, s, h, d = 2, 40, 2, 8
    scale = 0.3
    q, k, v, do = _torch(_inputs((b, s, h, d), seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa.attention_reference(*leaves, causal, scale)
    o.backward(do)
    got = fa.attention_bwd_reference(q, k, v, o.detach(), lse.detach(), do,
                                     causal, scale)
    for name, g, leaf in zip("qkv", got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(),
                                   err_msg=f"d{name}", **TOL)
    # The plain versions of the dK/dV and of the dQ kernel, one each.
    di = fa.row_dot(o.detach(), do)
    dk, dv = fa.attention_bwd_dkv_reference(q, k, v, lse.detach(), do, di,
                                            causal, scale)
    dq = fa.attention_bwd_dq_reference(q, k, v, lse.detach(), do, di,
                                       causal, scale)
    for name, g, split in zip("qkv", got, (dq, dk, dv)):
        torch.testing.assert_close(split, g, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("s,causal", [(37, True), (37, False), (1, True),
                                      (130, False)])
def test_wrapper_on_cpu_matches_jax_vjp_at_ragged_lengths(s, causal):
    """``flash_attention`` (the autograd Function, CPU route) on the strided
    q, k, v views of a fused qkv tensor, against ``jax.vjp`` of
    ``_scaled_dot_attention`` on the same values."""
    b, h, d = 2, 3, 16
    rng = np.random.RandomState(4)
    qkv = rng.randn(b, s, 3 * h, d).astype(np.float32)
    do = rng.randn(b, s, h, d).astype(np.float32)
    fused = torch.from_numpy(qkv).requires_grad_()
    q, k, v = fused.split(h, dim=2)
    assert q.stride() == (s * 3 * h * d, 3 * h * d, d, 1)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, causal)
    out.backward(torch.from_numpy(do))
    assert fa.LAUNCHES == before   # the CPU route launches no kernel

    o_j, vjp = jax.vjp(lambda x: _scaled_dot_attention(
        *jnp.split(x, 3, axis=2), causal, d), jnp.asarray(qkv))
    (dqkv_j,) = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(fused.grad.numpy(), np.asarray(dqkv_j), **TOL)


def _meta(shape=(2, 64, 4, 64), dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "bf16"),
    ("head_dim", ValueError, "head_dim 32"),
    ("shape", ValueError, "one \\[b, s, h, d\\]"),
    ("stride", ValueError, "contiguous head dimension"),
    ("not_cuda", ValueError, "CUDA tensors"),
    ("mixed", ValueError, "one CUDA device"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(case, error, match):
    """Non-CPU tensors go to the kernels' checks (meta tensors stand in for
    tensors on a card here); every refusal raises, none falls back."""
    q, k, v = _meta(), _meta(), _meta()
    if case == "dtype":
        q, k, v = (_meta(dtype=torch.float16) for _ in range(3))
    elif case == "head_dim":
        q, k, v = (_meta((2, 64, 4, 32)) for _ in range(3))
    elif case == "shape":
        k = _meta((2, 32, 4, 64))
    elif case == "stride":
        q = _meta((2, 64, 64, 4)).transpose(2, 3)
    elif case == "mixed":
        q = torch.zeros((2, 64, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(error, match=match):
        fa.flash_attention(q, k, v, causal=False)


def test_kernels_take_the_strided_qkv_views():
    """The q, k, v views of a fused qkv projection pass every check but the
    device's: they reach the kernels without a copy."""
    qkv = torch.empty((2, 64, 3 * 4, 64), dtype=torch.bfloat16, device="meta")
    q, k, v = qkv.split(4, dim=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa._check(q, k, v)
