#!/usr/bin/env python3
"""Where a training step's time goes on the card.

    python3 profile_step.py [--model resnet|bert]

Runs one of the port's main paths as ``chip_smoke.py`` does, through
``hvd.init()`` and ``hvd.DistributedOptimizer``: ResNet-50 at batch 128,
224x224, bf16, ``fuse_conv1x1_bn=True``, over SGD-momentum (``resnet``, the
default), or BERT-large at batch 8 x 512 tokens, bf16, over AdamW
(``bert``).  Traces 3 steps (after 2 warm-up steps) with ``torch.profiler``.
Prints the card, the step time, the device busy share (the union of GPU
kernel intervals over the traced window) and the GPU kernel time grouped by
category, then the top kernels.  Needs one CUDA device; imports neither JAX
nor ``horovod_tpu``.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet, transformer
from horovod_tpu_torch.models.training import train_step

BATCH = 128
IMAGE = 224
BERT_BATCH = 8
BERT_SEQ = 512
WARMUP_STEPS = 2
TRACED_STEPS = 3

# Kernel-name patterns, first match wins.
CATEGORIES = [
    ("matmul_bn_stats (port's CUDA kernel)", r"matmul_bn_stats"),
    ("flash_attention (port's CUDA kernels)",
     r"flash_(fwd|bwd_dkv|bwd_dq)_kernel"),
    ("convolution (cuDNN)", r"conv|cudnn|fprop|dgrad|wgrad|implicit"),
    ("matmul (cuBLAS)", r"gemm|cutlass|nvjet"),
    ("optimizer (foreach)", r"multi_tensor|foreach"),
    ("reduction", r"reduce"),
    ("pooling", r"pool"),
    ("copy / fill / cat", r"copy|memcpy|memset|fill|cat"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def category(name: str) -> str:
    for label, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return label
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def resnet_setup(dev):
    model = resnet.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
        generator=torch.Generator().manual_seed(0)).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"x": torch.randn(BATCH, IMAGE, IMAGE, 3, device=dev,
                              generator=gen),
             "y": torch.randint(0, 1000, (BATCH,), device=dev, generator=gen)}
    return model, opt, batch, f"ResNet-50 batch {BATCH} {IMAGE}x{IMAGE} bf16"


def bert_setup(dev):
    cfg = transformer.bert_large_config(max_len=BERT_SEQ, causal=False)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           device=dev, generator=gen)
    return (model, opt, {"x": tokens, "y": tokens},
            f"BERT-large batch {BERT_BATCH} x {BERT_SEQ} tokens bf16")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("resnet", "bert"),
                        default="resnet")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_step: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    hvd.init()
    dev = hvd.device()
    setup = bert_setup if args.model == "bert" else resnet_setup
    model, opt, batch, what = setup(dev)
    for _ in range(WARMUP_STEPS):
        train_step(model, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            train_step(model, opt, batch)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    hvd.shutdown()

    # GPU kernels only: a record_function range (``Optimizer.step#...``)
    # also appears on the device timeline, as a user annotation.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = union_us((e.time_range.start, e.time_range.end)
                       for e in kernels)
    by_cat = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    kernel_us = sum(by_cat.values())
    step_ms = window_us / 1e3 / TRACED_STEPS
    print(card)
    print(f"{what}, traced "
          f"{TRACED_STEPS} steps: {step_ms:.1f} ms/step (profiler on), "
          f"{len(kernels) / TRACED_STEPS:.0f} GPU kernels/step, device busy "
          f"{busy_us / window_us:.1%} of the window [{card}]")
    if not kernels:
        print("the profiler recorded no GPU kernels: device time not visible")
        return 1
    print(f"{'category':40s} {'ms/step':>9s} {'share':>7s}")
    for label, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"{label:40s} {us / 1e3 / TRACED_STEPS:9.2f} "
              f"{us / kernel_us:7.1%}")
    print(f"{'all kernels':40s} {kernel_us / 1e3 / TRACED_STEPS:9.2f}")
    print("top kernels (ms/step, launches/step, name):")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, count) in top:
        print(f"  {us / 1e3 / TRACED_STEPS:8.2f} {count / TRACED_STEPS:6.0f}"
              f"  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
