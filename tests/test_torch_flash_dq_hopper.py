"""The dQ kernel's schedule, emulated in plain torch, against the plain
version and JAX.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain version.  This file keeps its arithmetic testable on the
CPU: :func:`_dq_schedule` walks the work items and k tiles in the kernel's
order, with the tile sizes the wrapper exports (``flash_attention.DQ_TILES``,
checked against the CUDA source when the library loads).  Each work item of
128 queries is two warpgroups of 64; a causal item's k loop ends at the tile
holding its last query; masks apply only on the k tiles that cross s or a
warpgroup's diagonal, where a key past s or past the query gets P = 0; rows
past s read zeros (as TMA fills them) with lse and di 0; dS is rounded to
bf16 before dS K; sums are fp32 and the scale is applied at the store.

Tolerance: 1e-2 relative RMS, the card's limit for the kernel against the
plain version (bf16 rounding of dS; the card measures about 2.4e-3).
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
WARPGROUP_ROWS = 64


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


def _rows(v: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """Entries [start, start + rows) of [b, h, s], zero past s."""
    out = torch.zeros(v.shape[:2] + (rows,))
    part = v[..., start:start + rows]
    out[..., :part.shape[-1]] = part
    return out


def _dq_schedule(q, k, v, lse, do, di, causal: bool, scale: float):
    """The dQ kernel's loop in plain torch: fp32 sums of bf16 inputs,
    returns bf16 ``dq`` in ``[b, s, h, d]``."""
    b, s, h, d = q.shape
    queries, keys = fa.DQ_TILES[d]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dq = torch.empty(b, s, h, d, dtype=torch.bfloat16)
    for q0 in range(0, s, queries):
        end = min(s, q0 + queries) if causal else s
        acc = torch.zeros(b, queries, h, d)
        for wg in range(queries // WARPGROUP_ROWS):
            qw0 = q0 + wg * WARPGROUP_ROWS
            rows = slice(wg * WARPGROUP_ROWS, (wg + 1) * WARPGROUP_ROWS)
            qt = _tile(qf, qw0, WARPGROUP_ROWS)
            dot = _tile(dof, qw0, WARPGROUP_ROWS)
            lse2 = _rows(lse, qw0, WARPGROUP_ROWS)[..., None] * LOG2E
            dis = _rows(di, qw0, WARPGROUP_ROWS)[..., None]
            query = torch.arange(qw0, qw0 + WARPGROUP_ROWS)[:, None]
            last = query.clamp(max=s - 1) if causal else torch.full_like(
                query, s - 1)
            for k0 in range(0, end, keys):
                kt, vt = _tile(kf, k0, keys), _tile(vf, k0, keys)
                st = torch.einsum("bqhd,bkhd->bhqk", qt, kt)
                dpt = torch.einsum("bqhd,bkhd->bhqk", dot, vt)
                p = torch.exp2(st * (scale * LOG2E) - lse2)
                if k0 + keys > s or (causal and k0 + keys - 1 > qw0):
                    key = torch.arange(k0, k0 + keys)[None, :]
                    p = torch.where(key <= last, p, torch.zeros(()))
                ds = (p * (dpt - dis)).to(torch.bfloat16).float()
                acc[:, rows] += torch.einsum("bhqk,bkhd->bqhd", ds, kt)
        n = min(queries, s - q0)
        dq[:, q0:q0 + n] = (acc[:, :n] * scale).to(torch.bfloat16)
    return dq


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 37, 200, 513])
def test_dq_schedule_matches_plain_version_and_jax_vjp(s, d, causal):
    b, h = 1, 2
    scale = d ** -0.5
    rng = np.random.RandomState(s * 11 + d + int(causal))
    # bf16 inputs, as the kernel takes them; JAX gets the same values in fp32.
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.attention_reference(q, k, v, causal, scale)   # as the forward
    di = fa.row_dot(o, do)
    dq = _dq_schedule(q, k, v, lse, do, di, causal, scale)

    f32 = [t.float() for t in (q, k, v, do)]
    dq_ref = fa.attention_bwd_dq_reference(f32[0], f32[1], f32[2], lse,
                                           f32[3], di, causal, scale)
    _, vjp = jax.vjp(lambda q_, k_, v_: _scaled_dot_attention(
        q_, k_, v_, causal, d), *(jnp.asarray(t.numpy()) for t in f32[:3]))
    dq_jax = torch.from_numpy(np.array(vjp(jnp.asarray(f32[3].numpy()))[0]))

    errors = {"plain": _rel_rms(dq, dq_ref), "jax": _rel_rms(dq, dq_jax)}
    assert max(errors.values()) <= REL_RMS, errors
    assert bool(torch.isfinite(dq.float()).all())


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_dq_tiles_fit_the_kernel(d):
    """Work items of two 64-row warpgroups, as the forward's; k tiles a
    multiple of the 16-deep wgmma step, at most wgmma's 256 columns."""
    queries, keys = fa.DQ_TILES[d]
    assert queries == fa.FWD_TILES[d][0] == 2 * WARPGROUP_ROWS
    assert keys % 16 == 0 and 16 <= keys <= 256
    assert set(fa.DQ_TILES) == set(fa.HEAD_DIMS)
