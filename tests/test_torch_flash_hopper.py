"""The dK/dV kernel's schedule, emulated in plain torch, against the plain
version and JAX.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against the plain versions.  This file keeps the arithmetic of the dK/dV
kernel testable on the CPU: :func:`_dkv_schedule` walks the key blocks and
q tiles in the kernel's order, with the tile sizes the wrapper exports
(``flash_attention.DKV_TILES``, checked against the CUDA source when the
library loads), starts a causal block's loop at the q tile of its first key,
masks ragged and causal pairs to exactly 0, rounds Pᵀ and dSᵀ to bf16
before their products as the kernel does, and sums in fp32.

Tolerance: 1e-2 relative RMS, the card's limit for the kernel against the
plain version (bf16 rounding of P and dS; the card measures about 3e-3).
Where the reference is all but zero (dK at s = 1, where dS = P(dP - di)
cancels), the RMS is taken against a floor of 1e-4 per element.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.transformer import _scaled_dot_attention
from horovod_tpu_torch.kernels import flash_attention as fa

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REL_RMS = 1e-2
FLOOR = 1e-4
LOG2E = 1.4426950408889634


def _rel_rms(x: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    denom = max(ref.norm().item(), FLOOR * math.sqrt(ref.numel()))
    return (x.float() - ref).norm().item() / denom


def _tile(x: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """Rows [start, start + rows) of [b, s, h, d], zero past s (as TMA
    fills them)."""
    out = torch.zeros((x.shape[0], rows) + tuple(x.shape[2:]), dtype=x.dtype)
    part = x[:, start:start + rows]
    out[:, :part.shape[1]] = part
    return out


def _dkv_schedule(q, k, v, lse, do, di, causal: bool, scale: float):
    """The dK/dV kernel's loop in plain torch: fp32 sums of bf16 inputs,
    returns bf16 ``(dk, dv)`` in ``[b, s, h, d]``."""
    b, s, h, d = q.shape
    keys, queries = fa.DKV_TILES[d]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    lse2 = torch.zeros(b, h, s + queries)   # log2e·lse, zero past s
    lse2[..., :s] = lse * LOG2E
    dis = torch.zeros(b, h, s + queries)
    dis[..., :s] = di
    dk = torch.empty(b, s, h, d, dtype=torch.bfloat16)
    dv = torch.empty(b, s, h, d, dtype=torch.bfloat16)
    for k0 in range(0, s, keys):
        kt, vt = _tile(kf, k0, keys), _tile(vf, k0, keys)
        key = torch.arange(k0, k0 + keys)[:, None]
        acc_dk = torch.zeros(b, keys, h, d)
        acc_dv = torch.zeros(b, keys, h, d)
        # Causal: only queries at or after the block's first key see it.
        q_begin = (k0 // queries) * queries if causal else 0
        for q0 in range(q_begin, s, queries):
            qt, dot = _tile(qf, q0, queries), _tile(dof, q0, queries)
            query = torch.arange(q0, q0 + queries)[None, :]
            valid = (key < s) & (query < s)
            if causal:
                valid &= key <= query
            st = torch.einsum("bkhd,bqhd->bhkq", kt, qt)
            dpt = torch.einsum("bkhd,bqhd->bhkq", vt, dot)
            pt = torch.exp2(st * (scale * LOG2E)
                            - lse2[..., None, q0:q0 + queries])
            pt = torch.where(valid, pt, torch.zeros(()))
            dst = pt * (dpt - dis[..., None, q0:q0 + queries])
            acc_dv += torch.einsum("bhkq,bqhd->bkhd",
                                   pt.to(torch.bfloat16).float(), dot)
            acc_dk += torch.einsum("bhkq,bqhd->bkhd",
                                   dst.to(torch.bfloat16).float(), qt)
        n = min(keys, s - k0)
        dk[:, k0:k0 + n] = (acc_dk[:, :n] * scale).to(torch.bfloat16)
        dv[:, k0:k0 + n] = acc_dv[:, :n].to(torch.bfloat16)
    return dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 37, 200, 513])
def test_dkv_schedule_matches_plain_version_and_jax_vjp(s, d, causal):
    b, h = 1, 2
    scale = d ** -0.5
    rng = np.random.RandomState(s * 7 + d + int(causal))
    # bf16 inputs, as the kernel takes them; JAX gets the same values in fp32.
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.attention_reference(q, k, v, causal, scale)   # as the forward
    di = fa.row_dot(o, do)
    dk, dv = _dkv_schedule(q, k, v, lse, do, di, causal, scale)

    f32 = [t.float() for t in (q, k, v, do)]
    dk_ref, dv_ref = fa.attention_bwd_dkv_reference(
        f32[0], f32[1], f32[2], lse, f32[3], di, causal, scale)
    _, vjp = jax.vjp(lambda q_, k_, v_: _scaled_dot_attention(
        q_, k_, v_, causal, d), *(jnp.asarray(t.numpy()) for t in f32[:3]))
    _, dk_jax, dv_jax = (torch.from_numpy(np.array(g))
                         for g in vjp(jnp.asarray(f32[3].numpy())))

    errors = {"dk plain": _rel_rms(dk, dk_ref), "dv plain": _rel_rms(dv, dv_ref),
              "dk jax": _rel_rms(dk, dk_jax), "dv jax": _rel_rms(dv, dv_jax)}
    assert max(errors.values()) <= REL_RMS, errors
    assert bool(torch.isfinite(dk.float()).all() and torch.isfinite(dv.float()).all())


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_tiles_fit_the_kernels(d):
    """The tiles the wrapper copies from the CUDA source: 128-row blocks of
    two 64-row warpgroups; q tiles a multiple of the 16-deep wgmma step that
    divide the block, so a causal block's loop starts at its first key."""
    fwd_queries, fwd_keys = fa.FWD_TILES[d]
    keys, queries = fa.DKV_TILES[d]
    assert fwd_queries == keys == 128
    assert fwd_keys % 16 == 0 and fwd_keys <= 256
    assert queries % 16 == 0 and keys % queries == 0
    assert set(fa.FWD_TILES) == set(fa.DKV_TILES) == set(fa.HEAD_DIMS)
