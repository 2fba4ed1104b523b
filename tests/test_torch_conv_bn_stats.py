"""The port's fused 1x1-conv + BN-statistics matmul against the JAX package.

The same numpy inputs go through ``horovod_tpu.kernels`` (the Pallas kernel,
in interpret mode on this CPU, as ``tests/test_conv_bn_kernel.py`` runs it)
and through ``horovod_tpu_torch.kernels``, whose CPU path is the kernel's
plain PyTorch version.  The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the same plain version.

Tolerance: fp32 atol/rtol 1e-5 unless stated; the two sides sum the same
products in different orders.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.kernels import FusedConv1x1BN as JaxFusedConv1x1BN
from horovod_tpu.kernels import matmul_bn_stats as jax_matmul_bn_stats
from horovod_tpu_torch.convert import from_flax
from horovod_tpu_torch.kernels import (
    FusedConv1x1BN,
    MatmulBNStats,
    matmul_bn_stats,
)
from horovod_tpu_torch.kernels.conv_bn_stats import (
    _check,
    matmul_bn_stats_reference,
    pad_operands,
    unpad_outputs,
)

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    # Scaled so that y, s1 and s2 stay O(1) whatever K and M are: the
    # tolerance then means the same thing for every shape.
    x = (rng.randn(m, k) / np.sqrt(k)).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    return x, w


@pytest.mark.parametrize("m,k,n", [
    (64, 32, 48),        # everything unaligned to the 128-blocks
    (256, 256, 256),     # exact multi-block
    (300, 130, 70),      # ragged
])
def test_matmul_stats_matches_jax_kernel(m, k, n):
    x, w = _inputs(0, m, k, n)
    yj, s1j, s2j = jax_matmul_bn_stats(jnp.asarray(x), jnp.asarray(w),
                                       128, 128, 128, True)
    y, s1, s2 = matmul_bn_stats(torch.from_numpy(x), torch.from_numpy(w))
    scale = np.float32(np.sqrt(m))  # |s1| grows like sqrt(M), s2 like M
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(s1.numpy() / scale, np.asarray(s1j) / scale,
                               **TOL)
    np.testing.assert_allclose(s2.numpy() / m, np.asarray(s2j) / m, **TOL)


def test_matmul_stats_bf16_inputs():
    """bf16 in, bf16 y out, fp32 statistics from the fp32 product.  y may
    round to a neighbouring bf16 value where the two fp32 sums straddle a
    rounding boundary: one bf16 ulp, at most 2^-7 relative."""
    x, w = _inputs(1, 128, 64, 96)
    xb = x.astype(ml_dtypes.bfloat16)
    wb = w.astype(ml_dtypes.bfloat16)
    yj, s1j, s2j = jax_matmul_bn_stats(jnp.asarray(xb), jnp.asarray(wb),
                                       128, 128, 128, True)
    xt = torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)
    wt = torch.from_numpy(wb.astype(np.float32)).to(torch.bfloat16)
    y, s1, s2 = matmul_bn_stats(xt, wt)
    assert y.dtype == torch.bfloat16
    assert s1.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yj, np.float32),
                               rtol=2.0 ** -7, atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1j), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2j), **TOL)


def _bn_loss(y, s1, s2, rsqrt, total):
    mean = s1 / y.shape[0]
    var = s2 / y.shape[0] - mean * mean
    return total((y - mean) * rsqrt(var + 1e-5)) + 0.1 * total(s2)


@pytest.mark.parametrize("m,k,n", [(96, 40, 24), (300, 130, 70)])
def test_matmul_stats_gradients_match_jax(m, k, n):
    """The autograd.Function's backward equals the JAX custom VJP for a
    loss that touches y, s1 AND s2 (the BatchNorm-shaped dependency)."""
    x, w = _inputs(2, m, k, n)

    def loss_jax(xj, wj):
        return _bn_loss(*jax_matmul_bn_stats(xj, wj, 128, 128, 128, True),
                        jax.lax.rsqrt, jnp.sum)

    gxj, gwj = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    _bn_loss(*MatmulBNStats.apply(xt, wt), torch.rsqrt, torch.sum).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gwj), **TOL)


def _fused_pair(strides, use_running_average, seed):
    """The flax module and the port's, holding the same random weights and
    running statistics."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    jmod = JaxFusedConv1x1BN(features=24, strides=(strides, strides),
                             dtype=jnp.float32,
                             use_running_average=use_running_average)
    params = {"kernel": (rng.randn(16, 24) * 0.2).astype(np.float32),
              "scale": (1.0 + 0.1 * rng.randn(24)).astype(np.float32),
              "bias": (0.1 * rng.randn(24)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.randn(24)).astype(np.float32),
             "var": (1.0 + 0.1 * rng.rand(24)).astype(np.float32)}
    tmod = FusedConv1x1BN(16, 24, strides=strides, dtype=torch.float32)
    tmod.load_state_dict(from_flax(params, stats))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    return x, jmod, variables, tmod


@pytest.mark.parametrize("strides", [1, 2])
def test_fused_module_train_matches_flax(strides):
    x, jmod, variables, tmod = _fused_pair(strides, False, 3)
    out_j, mut = jmod.apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])
    out_t = tmod.train()(torch.from_numpy(x))
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(tmod, key).numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   err_msg=f"running {key} diverged", **TOL)


@pytest.mark.parametrize("strides", [1, 2])
def test_fused_module_eval_matches_flax(strides):
    x, jmod, variables, tmod = _fused_pair(strides, True, 4)
    out_j = jmod.apply(variables, jnp.asarray(x))
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    with torch.no_grad():
        out_t = tmod.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, before[k]), f"eval changed {k}"


@pytest.mark.parametrize("x,w,err", [
    (torch.zeros(8, 8, device="meta"), torch.zeros(8, 8, device="meta"),
     ValueError),
    (torch.zeros(8, 8), torch.zeros(8, 8, device="meta"), ValueError),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(x, w, err):
    """Only CPU tensors take the plain version; anything else must be a
    CUDA pair the kernel takes, or the wrapper raises."""
    with pytest.raises(err):
        _check(x, w)
    with pytest.raises(err):
        matmul_bn_stats(x, w)


@pytest.mark.parametrize("m,k,n", [(1000, 60, 200), (37, 64, 12)])
def test_ragged_k_and_n_are_padded_like_the_jax_kernel(m, k, n):
    """The CUDA wrapper zero-pads K and N up to multiples of 8 and slices
    the outputs back to N (fault C2).  The kernel computes what its plain
    version computes on the padded operands: that, cut back, must equal the
    JAX kernel on the ragged ones, and the padding must be exactly zero
    wherever it could reach an output."""
    x, w = _inputs(3, m, k, n)
    xp, wp = pad_operands(torch.from_numpy(x), torch.from_numpy(w))
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    assert tuple(xp.shape) == (m, kp) and tuple(wp.shape) == (kp, np_)
    assert xp.is_contiguous() and wp.is_contiguous()
    assert not xp[:, k:].any() and not wp[k:].any() and not wp[:, n:].any()
    y_p, s1_p, s2_p = matmul_bn_stats_reference(xp, wp)
    assert not y_p[:, n:].any() and not s1_p[n:].any() and not s2_p[n:].any()
    y, s1, s2 = unpad_outputs(y_p, s1_p, s2_p, n)
    assert tuple(y.shape) == (m, n) and y.is_contiguous()
    yj, s1j, s2j = jax_matmul_bn_stats(jnp.asarray(x), jnp.asarray(w),
                                       128, 128, 128, True)
    scale = np.float32(np.sqrt(m))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(s1.numpy() / scale, np.asarray(s1j) / scale,
                               **TOL)
    np.testing.assert_allclose(s2.numpy() / m, np.asarray(s2j) / m, **TOL)


def test_aligned_operands_are_not_copied():
    x, w = torch.zeros(16, 64), torch.zeros(64, 128)
    xp, wp = pad_operands(x, w)
    assert xp is x and wp is w
    y, s1, s2 = torch.zeros(16, 128), torch.zeros(128), torch.zeros(128)
    assert unpad_outputs(y, s1, s2, 128)[0] is y
