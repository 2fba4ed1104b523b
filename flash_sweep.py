#!/usr/bin/env python3
"""Flash-attention kernels across sequence lengths, on one GPU.

    python3 flash_sweep.py

Times the port's forward, dK/dV and dQ kernels and the library yardstick
(``torch.nn.functional.scaled_dot_product_attention``, forward only; never
called by the port) at BERT-large's width (h 16) and head_dim 64 and 128,
for s = 512 and 4096 at the same number of work items, with CUDA events as
``chip_smoke.py`` times them.  Prints ms and achieved TFLOP/s per kernel,
then, per kernel and head_dim, a fit of the time to ``fixed + per_128 ·
s / 128``: the kernels' blocks (or work items) own 128 rows and loop over
the other sequence axis, and both lengths have the same number of them, so
the fit separates the cost of a block's start and end from that of each
128 rows it loops over.  Prints the card first.  Needs one CUDA device.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs
from horovod_tpu_torch.kernels import flash_attention as fa

HEADS = 16
# (b, s): the same b·s/128 = 32 row tiles per head at both lengths.
LENGTHS = [(8, 512), (1, 4096)]


def sweep(d: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = d ** -0.5
    times = {}
    for b, s in LENGTHS:
        qkv = torch.randn(b, s, 3 * HEADS, d, device="cuda",
                          generator=gen).to(torch.bfloat16)
        q, k, v = qkv.split(HEADS, dim=2)
        do = torch.randn(b, s, HEADS, d, device="cuda",
                         generator=gen).to(torch.bfloat16)
        o, lse = fa.flash_fwd(q, k, v, False, scale)
        di = fa.row_dot(o, do)
        ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4 * b * HEADS * s * s * d   # forward; the backward pair 2x
        for name, fn, mult in (
                ("flash_fwd", lambda: fa.flash_fwd(q, k, v, False, scale), 1),
                ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(
                    q, k, v, lse, do, di, False, scale), 2),
                ("flash_bwd_dq", lambda: fa.flash_bwd_dq(
                    q, k, v, lse, do, di, False, scale), 1.5),
                ("sdpa_fwd", lambda: F.scaled_dot_product_attention(
                    ql, kl, vl, scale=scale), 1)):
            ms = cs.cuda_ms(fn, 20)
            times[name, s] = ms
            print(f"d {d} b {b} s {s} h {HEADS}: {name:14s} {ms:.5f} ms "
                  f"{mult * flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        del qkv, q, k, v, do, o, lse, di
    (_, s0), (_, s1) = LENGTHS
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "sdpa_fwd"):
        t0, t1 = times[name, s0], times[name, s1]
        per_128 = (t1 - t0) / (s1 / 128 - s0 / 128)
        fixed = t0 - per_128 * s0 / 128
        print(f"d {d} {name:14s} fixed {fixed:.5f} ms + {per_128:.6f} ms "
              f"per 128 rows: fixed share at s {s0} {fixed / t0:.2f}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sweep: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    print(cs.card(), flush=True)
    for d in fa.HEAD_DIMS:
        sweep(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
