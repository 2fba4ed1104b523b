"""The B8 kernel's tiling, emulated in plain torch, against the plain version
and the JAX package's Pallas kernel.

The CUDA kernel (``csrc/matmul_bn_stats.cu``) runs only on the card, where
``chip_smoke.py`` holds it against the plain version.  This file keeps its
arithmetic testable on the CPU: :func:`_b8_tiling` cuts the output into
``BLOCK_M`` x ``block_n(N)`` tiles with zero-filled edges (as TMA reads past
M, K and N), accumulates each tile in fp32 over 64-deep K steps, rounds y to
bf16, and forms each column's statistics in the kernel's fixed order: a sum
over each thread's rows g and g + 8 of a warp's 16, the butterfly over
lane bits 16, 8 and 4 (rows g, g ^ 4, g ^ 2, g ^ 1), then the 8 warps' sums
in order into the ``[ceil(M / BLOCK_M), N]`` partials that the wrapper sums.
The JAX side runs ``matmul_bn_stats(..., interpret=True)``, as
``tests/test_conv_bn_kernel.py`` runs it on the CPU.

Tolerances are ``chip_smoke.py``'s for the kernel against the plain version:
y within 2 bf16 ulps (the ulp taken at max(|y|, 2^-8 max|y|)), s1 within
1e-3 of sum|y| per column, s2 within 1e-3 relative.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.kernels import matmul_bn_stats as jax_matmul_bn_stats
from horovod_tpu_torch.kernels import conv_bn_stats

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

Y_ULPS = 2
S_REL = 1e-3
BK = 64
WARP_ROWS = 16


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = torch.zeros(rows, cols)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _column_sums(acc: torch.Tensor) -> torch.Tensor:
    """Sum over the rows of a [128, n] tile in the kernel's order."""
    warps = []
    for w in range(acc.shape[0] // WARP_ROWS):
        rows = acc[w * WARP_ROWS:(w + 1) * WARP_ROWS]
        lanes = rows[:8] + rows[8:]            # each thread's rows g, g + 8
        for bit in (4, 2, 1):                  # lane bits 16, 8, 4 of g
            lanes = torch.stack([lanes[g] + lanes[g ^ bit] for g in range(8)])
        warps.append(lanes[0])
    total = torch.zeros(acc.shape[1])
    for part in warps:
        total = total + part
    return total


def _b8_tiling(x: torch.Tensor, w: torch.Tensor):
    """B8's tiles in plain torch: bf16 y and the fp32 statistics."""
    m, k = x.shape
    n = w.shape[1]
    bm, bn = conv_bn_stats.BLOCK_M, conv_bn_stats.block_n(n)
    m_tiles, n_tiles, k_steps = -(-m // bm), -(-n // bn), -(-k // BK)
    xp = _padded(x.float(), m_tiles * bm, k_steps * BK)
    wp = _padded(w.float(), k_steps * BK, n_tiles * bn)
    y = torch.empty(m_tiles * bm, n_tiles * bn, dtype=torch.bfloat16)
    partials = torch.empty(2, m_tiles, n_tiles * bn)
    for i in range(m_tiles):
        for j in range(n_tiles):
            acc = torch.zeros(bm, bn)
            for kb in range(k_steps):
                acc += (xp[i * bm:(i + 1) * bm, kb * BK:(kb + 1) * BK]
                        @ wp[kb * BK:(kb + 1) * BK, j * bn:(j + 1) * bn])
            y[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] = acc.to(torch.bfloat16)
            partials[0, i, j * bn:(j + 1) * bn] = _column_sums(acc)
            partials[1, i, j * bn:(j + 1) * bn] = _column_sums(acc * acc)
    s = partials[:, :, :n].sum(1)   # the wrapper's reduction
    return y[:m, :n], s[0], s[1]


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    _, exp = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), exp - 8)


def _assert_close(y, s1, s2, y_ref, s1_ref, s2_ref, what: str) -> None:
    y_ref = y_ref.float()
    floor = y_ref.abs().max() * 2.0 ** -8
    tol = Y_ULPS * _bf16_ulp(torch.maximum(y_ref.abs(), floor))
    assert bool(((y.float() - y_ref).abs() <= tol).all()), what
    s1_rel = ((s1 - s1_ref).abs() / y_ref.abs().sum(0).clamp(min=1e-30)).max()
    s2_rel = ((s2 - s2_ref).abs() / s2_ref.clamp(min=1e-30)).max()
    assert s1_rel <= S_REL and s2_rel <= S_REL, (what, s1_rel, s2_rel)


@pytest.mark.parametrize("m,k,n", [
    (1000, 64, 200),     # ragged M and N; two 128-column tiles
    (300, 136, 72),      # ragged K (three 64-deep steps) and N (128 columns)
    (129, 8, 8),         # one row past a block; the smallest K and N
    (256, 128, 512),     # four 128-column tiles, two row blocks
])
def test_b8_tiling_matches_plain_version_and_jax_kernel(m, k, n):
    rng = np.random.RandomState(m + k + n)
    # bf16 inputs, as the kernel takes them; JAX gets the same values.
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
                         ).to(torch.bfloat16)
    y, s1, s2 = _b8_tiling(x, w)
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)

    y_ref = x.float() @ w.float()
    _, s1_ref, s2_ref = conv_bn_stats.matmul_bn_stats_reference(x, w)
    _assert_close(y, s1, s2, y_ref, s1_ref, s2_ref, "plain version")

    yj, s1j, s2j = jax_matmul_bn_stats(jnp.asarray(x.float().numpy()),
                                       jnp.asarray(w.float().numpy()),
                                       128, 128, 128, True)
    _assert_close(y, s1, s2, *(torch.from_numpy(np.array(t))
                               for t in (yj, s1j, s2j)), "JAX kernel")


def test_column_sums_order_is_a_permutation_of_the_rows():
    """The butterfly adds every row of a warp exactly once: on integers
    (exact in fp32) it gives the plain column sum."""
    acc = torch.arange(128 * 8, dtype=torch.float32).reshape(128, 8)
    assert torch.equal(_column_sums(acc), acc.sum(0))


@pytest.mark.parametrize("n", [8, 64, 72, 128, 136, 200, 256, 2048])
def test_tiles_fit_the_kernel(n):
    """Row blocks of two 64-row warpgroups; a tile spans one or two
    64-column panels, covering N whole up to 128, and 64 only where that
    covers N."""
    assert conv_bn_stats.BLOCK_M == 128
    bn = conv_bn_stats.block_n(n)
    assert bn in (64, 128)
    assert bn >= n or bn == 128
    assert (bn == 64) == (n <= 64)
