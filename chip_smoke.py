#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. Device: requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. Build: compiles ``horovod_tpu_torch/csrc/*.cu`` with ``nvcc`` for sm_90a
   (from the checkout's sources, into ``horovod_tpu_torch/_build/``).
3. Kernels: ``matmul_bn_stats`` at every distinct ResNet-50 shape of the
   main path (batch 128, 224x224) and two ragged shapes, against its plain
   PyTorch version on the same bf16 inputs; times the kernel, the plain
   version and one library yardstick; computes each shape's bound.
4. Reference: a fused ResNet at ResNet-50's four stage widths in bf16 on
   the card (kernel) against the same weights in fp32 on the CPU (plain
   version), on a small input.
5. Main path: ``hvd.init()`` on ``cuda:0``, full-width ResNet-50
   (``fuse_conv1x1_bn=True``, bf16 compute), ``hvd.DistributedOptimizer``
   over SGD-momentum, 2 warm-up and 5 timed steps on seeded synthetic data.
   Asserts a finite loss, 36 kernel launches per step, and every gradient
   reduced by the runtime's ``CudaAllreduce`` each step.

The last two lines are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.backend import cuda as cuda_backend
from horovod_tpu_torch.kernels import build, conv_bn_stats
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.training import train_step

BATCH = 128
IMAGE = 224
WARMUP_STEPS = 2
TIMED_STEPS = 5
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
LAUNCHES_PER_STEP = 36

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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    torch.cuda.synchronize()
    _, s1r, s2r = conv_bn_stats.matmul_bn_stats_reference(x, w)
    yr = x.float() @ w.float()   # the plain version's fp32 y, unrounded
    err = (y.float() - yr).abs()
    floor = yr.abs().max() * 2.0 ** -8
    tol = Y_ULPS * bf16_ulp(torch.maximum(yr.abs(), floor))
    y_ok = bool((err <= tol).all())
    s1_rel = ((s1 - s1r).abs() / yr.abs().sum(0)).max().item()
    s2_rel = ((s2 - s2r).abs() / s2r).max().item()
    row = {"m": m, "k": k, "n": n, "max_abs_err": err.max().item(),
           "y_ulp_ok": y_ok, "s1_rel_err": s1_rel, "s2_rel_err": s2_rel}
    if not (y_ok and s1_rel <= S_REL and s2_rel <= S_REL):
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
    conv_bn_stats._kernel()
    print(f"build: {time.perf_counter() - t0:.2f}s total, nvcc "
          f"{build.build_seconds}", flush=True)
    for line in build.build_log.get("matmul_bn_stats", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    rows = phase_kernels()
    rel = phase_reference()
    print(f"reference: ResNet[1,1,1,1] logits bf16 (card) vs fp32 (CPU), "
          f"relative RMS error {rel:.4g}", flush=True)

    conv_bn_stats.LAUNCHES = 0
    for key in cuda_backend.stats:
        cuda_backend.stats[key] = 0
    main = phase_main_path()
    launches = conv_bn_stats.LAUNCHES
    reduced = cuda_backend.stats["allreduce_tensors"]
    responses = cuda_backend.stats["allreduce_responses"]
    assert launches == LAUNCHES_PER_STEP * main["steps"], launches
    assert reduced == main["n_params"] * main["steps"], reduced
    print(f"main path: ResNet-50 batch {BATCH} {IMAGE}x{IMAGE} bf16, "
          f"{main['images_per_s']:.1f} images/s, {main['step_ms']:.1f} ms/"
          f"step, peak {main['peak_mem_gb']:.1f} GB, losses "
          f"{[round(v, 4) for v in main['losses']]}, kernel launches "
          f"{launches}, allreduced tensors {reduced} "
          f"({main['n_params']} params x {main['steps']} steps) in "
          f"{responses} fused responses "
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
    print(card_line, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
