#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. Device: requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. Build: compiles ``horovod_tpu_torch/csrc/*.cu`` with ``nvcc`` for sm_90a,
   one ``nvcc`` per source, all started together (from the checkout's
   sources, into ``horovod_tpu_torch/_build/``); prints ptxas' register and
   spill lines, and per kernel instance the ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions ``cuobjdump -sass`` finds: every
   instance of the three flash kernels and of ``matmul_bn_stats`` must hold
   both.
3. ResNet kernels: ``matmul_bn_stats`` at every distinct ResNet-50 shape of
   the main path (batch 128, 224x224) and two ragged shapes, against its
   plain PyTorch version on the same bf16 inputs, with the same bits on a
   second launch; times the kernel, the plain version and one library
   yardstick; computes each shape's bound.
4. ResNet reference: a fused ResNet at ResNet-50's four stage widths in bf16
   on the card (kernel) against the same weights in fp32 on the CPU (plain
   version), on a small input.
5. ResNet main path: ``hvd.init()`` on ``cuda:0``, full-width ResNet-50
   (``fuse_conv1x1_bn=True``, bf16 compute), ``hvd.DistributedOptimizer``
   over SGD-momentum, 2 warm-up and 5 timed steps on seeded synthetic data.
   Asserts a finite loss, 36 kernel launches per step, and every gradient
   reduced by the runtime's ``CudaAllreduce`` each step.
6. Flash-attention kernels: forward, dK/dV and dQ at BERT-large's shape
   (8, 512, 16, 64), GPT-small's (4, 1024, 12, 64, causal), head_dim 128
   (2, 1024, 8, 128) and two ragged lengths (200 causal, 1000), each
   against its plain version on the same bf16 inputs; the three timed
   shapes also time the plain version and the library yardstick
   (``scaled_dot_product_attention`` and its backward, never called by the
   port) and compute the bound.
7. Transformer reference: 2 layers at BERT-large width (s 256, b 2), causal
   and not, bf16 on the card (kernels) against the same weights in fp32 on
   the CPU (plain versions): logits and every parameter's gradient.
8. BERT main path: ``hvd.init()`` on ``cuda:0``, full BERT-large
   (24 layers, s 512, bf16 compute), batch 8, ``hvd.DistributedOptimizer``
   over AdamW, 2 warm-up and 5 timed steps on seeded synthetic tokens
   (the tokens are the labels, as in ``benchmarks/bert_bench.py``).
   Asserts a finite loss, 24 launches of each flash kernel per step, and
   292 gradients reduced by ``CudaAllreduce`` each step.

The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.backend import cuda as cuda_backend
from horovod_tpu_torch.kernels import build, conv_bn_stats
from horovod_tpu_torch.kernels import flash_attention as fa
from horovod_tpu_torch.models import resnet, transformer
from horovod_tpu_torch.models.training import cross_entropy_loss, train_step

BATCH = 128
IMAGE = 224
WARMUP_STEPS = 2
TIMED_STEPS = 5
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# Clock cycles the device spins before a timed run: about 50 ms at the
# H100's 1.98 GHz boost clock, longer than the host takes to queue it.
HOLD_CYCLES = 100_000_000
LAUNCHES_PER_STEP = 36
# The library flash attention that horovod_tpu/models/transformer.py:128-135
# reaches (jax 0.9.0); its three pallas_call kernels are ported.
FA_LIBRARY = "jax/experimental/pallas/ops/tpu/flash_attention.py"

# (M, K, N) -> launches per forward on the main path, ResNet-50 at
# batch 128, 224x224; M = batch * H * W of the layer's output.
_S1, _S2, _S3, _S4 = (BATCH * s * s for s in (56, 28, 14, 7))
MAIN_PATH_SHAPES = {
    (_S1, 64, 64): 1, (_S1, 64, 256): 4, (_S1, 256, 64): 2,
    (_S1, 256, 128): 1, (_S2, 128, 512): 4, (_S2, 256, 512): 1,
    (_S2, 512, 128): 3,
    (_S2, 512, 256): 1, (_S3, 256, 1024): 6, (_S3, 512, 1024): 1,
    (_S3, 1024, 256): 5,
    (_S3, 1024, 512): 1, (_S4, 512, 2048): 3, (_S4, 1024, 2048): 1,
    (_S4, 2048, 512): 2,
}
# Ragged: M not a multiple of the 128-row tile, K = 64; N = 200 is not a
# multiple of the 128-column tile either.
RAGGED_SHAPES = [(12289, 64, 64), (1000, 64, 200)]

# Tolerances of the kernel against its plain version (same bf16 inputs):
# y within 2 bf16 ulps, the ulp taken at max(|y_ref|, 2^-8 max|y_ref|) so
# that the fp32 summation-order noise of values near zero is not counted
# as ulps; s1 within 1e-3 of sum|y_ref| per column (the scale of its
# rounding: s1 itself may cancel to ~0), s2 within 1e-3 relative.
Y_ULPS = 2
S_REL = 1e-3
# Whole-model reference on a small input: relative RMS error of the
# logits, bf16 on the card against fp32 on the CPU.  bf16 rounding through
# 14 layers with batch-statistics BatchNorm gives about 0.04 with the plain
# version on the CPU alone; a wrong kernel or layout gives O(1).
LOGITS_REL_RMS = 0.1

# BERT-large main path (benchmarks/bert_bench.py:48-54 on a TPU).
BERT_BATCH = 8
BERT_SEQ = 512
BERT_LAYERS = 24
BERT_PARAMS = 292
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# The kernels built on Hopper's wgmma and TMA, by library, with the template
# argument of each instance (head_dim; B8's columns per tile): every
# instance must hold both instructions in its SASS.
HOPPER_KERNELS = {
    "flash_attention": {name: fa.HEAD_DIMS for name in (
        "flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")},
    "matmul_bn_stats": {"matmul_bn_stats_kernel": (64, 128)},
}
HOPPER_SASS = ("HGMMA", "UTMALDG")
# (name, b, s, h, d, causal, timed).  The first is the main path's shape,
# launched once per layer per step by each kernel.
FLASH_SHAPES = [
    ("bert_large", BERT_BATCH, BERT_SEQ, 16, 64, False, True),
    ("gpt_small", 4, 1024, 12, 64, True, True),
    ("head_dim_128", 2, 1024, 8, 128, False, True),
    ("ragged_causal", 2, 200, 4, 64, True, False),
    ("ragged", 2, 1000, 4, 64, False, False),
]
# Tolerances of the flash kernels against their plain versions (same bf16
# inputs).  Both round the probabilities to bf16, the kernel before
# normalising (online softmax), the plain version after, so each output
# element carries a rounding noise of about 2^-9 of its row's terms
# sum(|p_j v_j|), not of its own (possibly cancelled) value: o is held
# within O_ULPS bf16 ulps of the largest |o_ref| and within O_REL_RMS
# relative RMS.  lse within LSE_REL of max(|lse_ref|, 1): fp32 sums in
# another order.  dq, dk, dv within GRAD_REL_RMS relative RMS of the fp32
# plain backward: the kernels round P and dS to bf16 for the tensor cores.
O_ULPS = 2
O_REL_RMS = 1e-2
LSE_REL = 1e-5
GRAD_REL_RMS = 1e-2
# Transformer reference: 2 layers at BERT-large width, bf16 on the card
# against fp32 on the CPU, relative RMS of the logits and of each
# parameter's gradient.  The plain versions in bf16 on the CPU give 0.008
# (logits) and 0.0097 (worst gradient) against the same fp32 run: the
# limits are twice that; a wrong kernel, mask or layout gives O(1).
TF_LOGITS_REL_RMS = 0.02
TF_GRAD_REL_RMS = 0.02


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sass_counts(name: str) -> dict:
    """``{kernel<head_dim>: {instruction: count}}`` of ``HOPPER_SASS`` in
    the SASS of the built library ``name`` (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"([a-z_]+_kernel)ILi(\d+)E", line)
            kernel = (f"{found[1]}<{found[2]}>" if found
                      else line.split("Function :")[1].strip())
            counts[kernel] = dict.fromkeys(HOPPER_SASS, 0)
        elif kernel is not None:
            for op in HOPPER_SASS:
                counts[kernel][op] += op in line
    return counts


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one ``fn()``, by CUDA events around ``iters`` calls.
    A spin kernel holds the device while the host queues every call, so
    the events time the device's work and not the host's launch rate
    (which exceeds a short kernel's time on a loaded host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(m: int, k: int, n: int, block_m: int):
    """Least time (ms) and what bounds it: every input read once, every
    output (y, and the two fp32 partial-sum rows per row block) written
    once, against the dense bf16 rate."""
    ops_s = 2.0 * m * k * n / PEAK_BF16_FLOPS
    nbytes = 2 * (m * k + k * n + m * n) + 8 * math.ceil(m / block_m) * n
    bytes_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s > bytes_s
                                       else "bytes"), 1e3 * ops_s, 1e3 * bytes_s


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    _, exp = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), exp - 8)


def library_call(x: torch.Tensor, w: torch.Tensor):
    """Yardstick only (never called by the port): cuBLAS matmul, then the
    statistics from the stored bf16 output."""
    y = torch.matmul(x, w)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def check_kernel_shape(m: int, k: int, n: int, gen: torch.Generator,
                       block_m: int, timed: bool) -> dict:
    dev = torch.device("cuda", 0)
    x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn(k, n, device=dev, generator=gen)
         / math.sqrt(k)).to(torch.bfloat16)
    y, s1, s2 = conv_bn_stats.matmul_bn_stats(x, w)
    # No atomics: a second launch on the same inputs gives the same bits.
    again = conv_bn_stats.matmul_bn_stats(x, w)
    torch.cuda.synchronize()
    repeatable = all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
    del again
    _, s1r, s2r = conv_bn_stats.matmul_bn_stats_reference(x, w)
    yr = x.float() @ w.float()   # the plain version's fp32 y, unrounded
    err = (y.float() - yr).abs()
    floor = yr.abs().max() * 2.0 ** -8
    tol = Y_ULPS * bf16_ulp(torch.maximum(yr.abs(), floor))
    y_ok = bool((err <= tol).all())
    s1_rel = ((s1 - s1r).abs() / yr.abs().sum(0)).max().item()
    s2_rel = ((s2 - s2r).abs() / s2r).max().item()
    row = {"m": m, "k": k, "n": n, "max_abs_err": err.max().item(),
           "y_ulp_ok": y_ok, "s1_rel_err": s1_rel, "s2_rel_err": s2_rel,
           "bitwise_repeatable": repeatable}
    if not (repeatable and y_ok and s1_rel <= S_REL and s2_rel <= S_REL):
        raise AssertionError(f"matmul_bn_stats disagrees with its plain "
                             f"version at {(m, k, n)}: {row}")
    del yr, s1r, s2r, err, tol
    if timed:
        bound_ms, bound_by, ops_ms, bytes_ms = bound(m, k, n, block_m)
        row.update(
            ms=cuda_ms(lambda: conv_bn_stats.matmul_bn_stats(x, w), 20),
            plain_ms=cuda_ms(
                lambda: conv_bn_stats.matmul_bn_stats_reference(x, w), 5),
            library_ms=cuda_ms(lambda: library_call(x, w), 20),
            bound_ms=bound_ms, bound_by=bound_by, ops_ms=ops_ms,
            bytes_ms=bytes_ms)
    return row


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, block_m, _ = conv_bn_stats._kernel()
    rows = []
    for (m, k, n), per_step in MAIN_PATH_SHAPES.items():
        row = check_kernel_shape(m, k, n, gen, block_m, timed=True)
        row["launches_per_step"] = per_step
        rows.append(row)
        print("kernel", json.dumps(row), flush=True)
    for m, k, n in RAGGED_SHAPES:
        row = check_kernel_shape(m, k, n, gen, block_m, timed=False)
        rows.append(row)
        print("kernel", json.dumps(row), flush=True)
    assert sum(MAIN_PATH_SHAPES.values()) == LAUNCHES_PER_STEP
    return rows


def phase_reference() -> float:
    """A fused ResNet with one bottleneck block at each of ResNet-50's four
    stage widths, in bf16 on the card (kernel) against the same weights in
    fp32 on the CPU (plain version): train-mode forward on a small input.
    BatchNorm scales are randomized so that every residual branch
    contributes (flax zero-inits the last one of each block)."""
    gen = torch.Generator().manual_seed(1)

    def build(dtype):
        return resnet.ResNet(stage_sizes=[1, 1, 1, 1],
                             block_cls=resnet.BottleneckBlock,
                             num_classes=1000, dtype=dtype,
                             fuse_conv1x1_bn=True, generator=gen)

    ref = build(torch.float32)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if name.endswith(".scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=gen))
    model = build(torch.bfloat16)
    model.load_state_dict(ref.state_dict())
    model.to("cuda")
    launches = sum(isinstance(m, conv_bn_stats.FusedConv1x1BN)
                   for m in model.modules())
    x = torch.rand(8, 64, 64, 3, generator=gen)
    before = conv_bn_stats.LAUNCHES
    with torch.no_grad():
        out = model.train()(x.cuda()).float().cpu()
        expected = ref.train()(x)
    assert conv_bn_stats.LAUNCHES - before == launches == 12
    assert out.shape == (8, 1000) and bool(torch.isfinite(out).all())
    rel = ((out - expected).norm() / expected.norm()).item()
    if rel > LOGITS_REL_RMS:
        raise AssertionError(f"bf16 logits on the card vs fp32 on the CPU: "
                             f"relative RMS error {rel:.4g} > "
                             f"{LOGITS_REL_RMS}")
    return rel


def phase_main_path() -> dict:
    hvd.init()
    dev = hvd.device()
    assert dev == torch.device("cuda", 0), dev
    model = resnet.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
        generator=torch.Generator().manual_seed(0)).to(dev)
    params = list(model.named_parameters())
    assert all(p.device.type == "cuda" for _, p in params)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=params)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"x": torch.randn(BATCH, IMAGE, IMAGE, 3, device=dev,
                              generator=gen),
             "y": torch.randint(0, 1000, (BATCH,), device=dev, generator=gen)}
    losses = []
    for _ in range(WARMUP_STEPS):
        losses.append(train_step(model, opt, batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        losses.append(train_step(model, opt, batch))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    hvd.shutdown()
    losses = [float(v) for v in losses]
    assert all(math.isfinite(v) for v in losses), losses
    steps = WARMUP_STEPS + TIMED_STEPS
    return {"losses": losses, "steps": steps,
            "images_per_s": TIMED_STEPS * BATCH / seconds,
            "step_ms": 1e3 * seconds / TIMED_STEPS, "n_params": len(params),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def rel_rms(x: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return ((x.float() - ref).norm() / ref.norm()).item()


def flash_bound(kernel: str, b: int, s: int, h: int, d: int, causal: bool):
    """Least time (ms) and what bounds it.  Operations: 4 (forward),
    8 (dK/dV) or 6 (dQ) ·d per (query, key) pair this run needs (s(s+1)/2
    per head when causal); bytes: each input read once, each output written
    once (bf16 [b,s,h,d] tensors, fp32 [b,h,s] lse and di)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    bhsd, bhs = b * h * s * d, b * h * s
    ops, nbytes = {
        "flash_fwd": (4 * pairs * d, 2 * 4 * bhsd + 4 * bhs),
        "flash_bwd_dkv": (8 * pairs * d, 2 * 6 * bhsd + 8 * bhs),
        "flash_bwd_dq": (6 * pairs * d, 2 * 5 * bhsd + 8 * bhs),
    }[kernel]
    ops_s, bytes_s = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s > bytes_s
                                       else "bytes")


def check_flash_shape(name: str, b: int, s: int, h: int, d: int,
                      causal: bool, timed: bool,
                      gen: torch.Generator) -> dict:
    """The three kernels against their plain versions on one shape.  q, k,
    v are the strided views of a fused qkv tensor, as on the main path."""
    dev = torch.device("cuda", 0)
    scale = d ** -0.5
    qkv = torch.randn(b, s, 3 * h, d, device=dev,
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(h, dim=2)
    do = torch.randn(b, s, h, d, device=dev, generator=gen).to(torch.bfloat16)
    args = (causal, scale)
    o, lse = fa.flash_fwd(q, k, v, *args)
    di = fa.row_dot(o, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, lse, do, di, *args)
    dq = fa.flash_bwd_dq(q, k, v, lse, do, di, *args)
    # No atomics: a second launch on the same inputs gives the same bits.
    again = (*fa.flash_fwd(q, k, v, *args),
             *fa.flash_bwd_dkv(q, k, v, lse, do, di, *args),
             fa.flash_bwd_dq(q, k, v, lse, do, di, *args))
    torch.cuda.synchronize()
    repeatable = all(torch.equal(a, b)
                     for a, b in zip((o, lse, dk, dv, dq), again))
    del again
    o_r, lse_r = fa.attention_reference(q, k, v, *args)
    di_r = fa.row_dot(o_r, do)
    dk_r, dv_r = fa.attention_bwd_dkv_reference(q, k, v, lse_r, do, di_r,
                                                *args)
    dq_r = fa.attention_bwd_dq_reference(q, k, v, lse_r, do, di_r, *args)
    ref = o_r.float()
    err = (o.float() - ref).abs()
    ulp = bf16_ulp(ref.abs().max())
    lse_err = ((lse - lse_r).abs() / lse_r.abs().clamp(min=1.0)).max().item()
    row = {"shape": name, "b": b, "s": s, "h": h, "d": d, "causal": causal,
           "o_max_abs_err": err.max().item(),
           "o_max_ulps": (err.max() / ulp).item(),   # of the largest |o|
           "o_rel_rms": rel_rms(o, ref),
           "lse_rel_err": lse_err,
           "dq_rel_rms": rel_rms(dq, dq_r), "dk_rel_rms": rel_rms(dk, dk_r),
           "dv_rel_rms": rel_rms(dv, dv_r),
           "dq_max_abs_err": (dq.float() - dq_r).abs().max().item(),
           "dkv_max_abs_err": max((dk.float() - dk_r).abs().max().item(),
                                  (dv.float() - dv_r).abs().max().item()),
           "bitwise_repeatable": repeatable}
    finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, dq, dk, dv))
    if not (finite and repeatable and row["o_max_ulps"] <= O_ULPS
            and row["o_rel_rms"] <= O_REL_RMS and lse_err <= LSE_REL
            and max(row["dq_rel_rms"], row["dk_rel_rms"],
                    row["dv_rel_rms"]) <= GRAD_REL_RMS):
        raise AssertionError(f"flash attention disagrees with its plain "
                             f"version at {name}: finite={finite} {row}")
    del o_r, lse_r, dk_r, dv_r, dq_r, ref, err, ulp
    if not timed:
        return row
    # Library yardstick: SDPA on [b, h, s, d] views, and its backward
    # through autograd for (dk, dv) and for dq.
    ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    do_l = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                              scale=scale)
    o_l = sdpa()
    times = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *args),
                      lambda: fa.attention_reference(q, k, v, *args),
                      lambda: sdpa()),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, lse, do, di, *args),
            lambda: fa.attention_bwd_dkv_reference(q, k, v, lse, do, di,
                                                   *args),
            lambda: torch.autograd.grad(o_l, (kl, vl), do_l,
                                        retain_graph=True)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, lse, do, di, *args),
            lambda: fa.attention_bwd_dq_reference(q, k, v, lse, do, di,
                                                  *args),
            lambda: torch.autograd.grad(o_l, ql, do_l, retain_graph=True)),
    }
    for kernel, (fn, plain, library) in times.items():
        bound_ms, bound_by = flash_bound(kernel, b, s, h, d, causal)
        row[kernel] = {"ms": cuda_ms(fn, 20), "plain_ms": cuda_ms(plain, 3),
                       "library_ms": cuda_ms(library, 20),
                       "bound_ms": bound_ms, "bound_by": bound_by}
    return row


def phase_flash_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for shape in FLASH_SHAPES:
        row = check_flash_shape(*shape, gen=gen)
        rows.append(row)
        print("flash", json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return rows


def phase_transformer_reference() -> None:
    """2 layers at BERT-large width, bf16 on the card (the kernels) against
    the same weights in fp32 on the CPU (the plain versions): logits and
    every parameter's gradient of the token-identity loss.  The same bf16
    model on the CPU (the plain versions) is printed beside it: the error
    bf16 rounding alone gives."""
    for causal in (False, True):
        gen = torch.Generator().manual_seed(3)
        cfg = transformer.bert_large_config(num_layers=2, max_len=256,
                                            causal=causal)
        ref = transformer.Transformer(
            dataclasses.replace(cfg, dtype=torch.float32), generator=gen)
        model = transformer.Transformer(cfg)
        model.load_state_dict(ref.state_dict())
        model.cuda()
        tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        logits = model(tokens.cuda())
        cross_entropy_loss(logits, tokens.cuda()).backward()
        torch.cuda.synchronize()
        assert all(n == cfg.num_layers for n in fa.LAUNCHES.values()), \
            fa.LAUNCHES
        expected = ref(tokens)
        cross_entropy_loss(expected, tokens).backward()
        plain = transformer.Transformer(cfg)
        plain.load_state_dict(ref.state_dict())
        plain_logits = plain(tokens)
        cross_entropy_loss(plain_logits, tokens).backward()

        def grad_errors(m):
            return {name: rel_rms(p.grad.cpu(), ref_p.grad)
                    for (name, p), ref_p in zip(m.named_parameters(),
                                                ref.parameters())}
        grads, plain_grads = grad_errors(model), grad_errors(plain)
        logits_rel = rel_rms(logits.cpu(), expected.detach())
        worst = max(grads, key=grads.get)
        result = {"causal": causal, "logits_rel_rms": logits_rel,
                  "worst_grad": worst, "worst_grad_rel_rms": grads[worst],
                  "median_grad_rel_rms": sorted(grads.values())[
                      len(grads) // 2],
                  "bf16_cpu_logits_rel_rms": rel_rms(plain_logits,
                                                     expected.detach()),
                  "bf16_cpu_worst_grad_rel_rms": max(plain_grads.values())}
        print("transformer reference", json.dumps(result), flush=True)
        if logits_rel > TF_LOGITS_REL_RMS or grads[worst] > TF_GRAD_REL_RMS:
            raise AssertionError(
                f"2-layer BERT-large-width transformer, bf16 on the card vs "
                f"fp32 on the CPU: {result} (limits {TF_LOGITS_REL_RMS}, "
                f"{TF_GRAD_REL_RMS})")
        del model, ref, plain, logits, expected
        torch.cuda.empty_cache()


def phase_bert_main_path() -> dict:
    hvd.init()
    dev = hvd.device()
    assert dev == torch.device("cuda", 0), dev
    cfg = transformer.bert_large_config(max_len=BERT_SEQ, causal=False)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    params = list(model.named_parameters())
    assert all(p.device.type == "cuda" for _, p in params)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=params)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           device=dev, generator=gen)
    batch = {"x": tokens, "y": tokens}
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for _ in range(WARMUP_STEPS):
        losses.append(train_step(model, opt, batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        losses.append(train_step(model, opt, batch))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    hvd.shutdown()
    losses = [float(v) for v in losses]
    assert all(math.isfinite(v) for v in losses), losses
    return {"losses": losses, "steps": WARMUP_STEPS + TIMED_STEPS,
            "tokens_per_s": TIMED_STEPS * BERT_BATCH * BERT_SEQ / seconds,
            "step_ms": 1e3 * seconds / TIMED_STEPS, "n_params": len(params),
            "n_weights": sum(p.numel() for _, p in params),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def reset_counts() -> None:
    conv_bn_stats.LAUNCHES = 0
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    for key in cuda_backend.stats:
        cuda_backend.stats[key] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    card_line = card()
    print(card_line, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    # fp32 comparisons on the card: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.compile_all(["matmul_bn_stats", "flash_attention"])
    conv_bn_stats._kernel()
    fa._kernels()
    print(f"build: {time.perf_counter() - t0:.2f}s total, nvcc "
          f"{build.build_seconds}", flush=True)
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}:", line.strip(), flush=True)
    for library, kernels in HOPPER_KERNELS.items():
        sass = sass_counts(library)
        for kernel, counts in sorted(sass.items()):
            print(f"sass {library}: {kernel} {json.dumps(counts)}", flush=True)
        for want, args in kernels.items():
            found = {k: c for k, c in sass.items() if k.startswith(want + "<")}
            if set(found) != {f"{want}<{a}>" for a in args} or not all(
                    all(c.values()) for c in found.values()):
                raise AssertionError(
                    f"{want}: every instance ({args}) must hold {HOPPER_SASS}; "
                    f"cuobjdump found {found}")

    rows = phase_kernels()
    rel = phase_reference()
    print(f"reference: ResNet[1,1,1,1] logits bf16 (card) vs fp32 (CPU), "
          f"relative RMS error {rel:.4g}", flush=True)

    reset_counts()
    main = phase_main_path()
    launches = conv_bn_stats.LAUNCHES
    reduced = cuda_backend.stats["allreduce_tensors"]
    responses = cuda_backend.stats["allreduce_responses"]
    assert launches == LAUNCHES_PER_STEP * main["steps"], launches
    assert not any(fa.LAUNCHES.values()), fa.LAUNCHES
    assert reduced == main["n_params"] * main["steps"], reduced
    print(f"main path: ResNet-50 batch {BATCH} {IMAGE}x{IMAGE} bf16, "
          f"{main['images_per_s']:.1f} images/s, {main['step_ms']:.1f} ms/"
          f"step, peak {main['peak_mem_gb']:.1f} GB, losses "
          f"{[round(v, 4) for v in main['losses']]}, kernel launches "
          f"{launches}, allreduced tensors {reduced} "
          f"({main['n_params']} params x {main['steps']} steps) in "
          f"{responses} fused responses "
          f"[{card_line}]", flush=True)

    torch.cuda.empty_cache()

    flash_rows = phase_flash_kernels()
    phase_transformer_reference()

    reset_counts()
    bert = phase_bert_main_path()
    flash_launches = dict(fa.LAUNCHES)
    bert_reduced = cuda_backend.stats["allreduce_tensors"]
    assert conv_bn_stats.LAUNCHES == 0, conv_bn_stats.LAUNCHES
    for kernel in FLASH_KERNELS:
        assert flash_launches[kernel] == BERT_LAYERS * bert["steps"], \
            flash_launches
    assert bert["n_params"] == BERT_PARAMS, bert["n_params"]
    assert bert_reduced == BERT_PARAMS * bert["steps"], bert_reduced
    print(f"main path: BERT-large ({bert['n_weights']} weights) batch "
          f"{BERT_BATCH} x {BERT_SEQ} tokens bf16, AdamW, "
          f"{bert['tokens_per_s']:.1f} tokens/s, {bert['step_ms']:.1f} ms/"
          f"step, peak {bert['peak_mem_gb']:.1f} GB, losses "
          f"{[round(v, 4) for v in bert['losses']]}, flash launches "
          f"{flash_launches}, allreduced tensors {bert_reduced} "
          f"({bert['n_params']} params x {bert['steps']} steps) in "
          f"{cuda_backend.stats['allreduce_responses']} fused responses "
          f"[{card_line}]", flush=True)

    timed = [r for r in rows if "ms" in r]

    def per_step(key):
        return sum(r[key] * r["launches_per_step"] for r in timed)

    ops_ms, bytes_ms = per_step("ops_ms"), per_step("bytes_ms")
    summary = {"kernels": [{
        "name": "matmul_bn_stats",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/matmul_bn_stats.cu",
        "replaces": "horovod_tpu/kernels/conv_bn_stats.py:90",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # Per training step: each shape's time times its launches per step.
        "ms": per_step("ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        "library_ms": per_step("library_ms"),
    }]}
    # Per training step: the main path's shape, once per layer.
    main_shape = next(r for r in flash_rows if r["shape"] == "bert_large")
    for kernel, line, err_key in (
            ("flash_fwd", 589, "o_max_abs_err"),
            ("flash_bwd_dkv", 941, "dkv_max_abs_err"),
            ("flash_bwd_dq", 1287, "dq_max_abs_err")):
        t = main_shape[kernel]
        summary["kernels"].append({
            "name": kernel, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"{FA_LIBRARY}:{line}",
            "launches": flash_launches[kernel],
            "max_abs_err": max(r[err_key] for r in flash_rows),
            "ms": BERT_LAYERS * t["ms"],
            "plain_ms": BERT_LAYERS * t["plain_ms"],
            "bound_ms": BERT_LAYERS * t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": BERT_LAYERS * t["library_ms"],
        })
    print(card_line, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
