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
   the np=1 main path (batch 128, 224x224), of the np=2 path (64 images
   per rank) and at four ragged shapes, against its plain PyTorch version
   on the same bf16 inputs, with the same bits on a second launch; at the
   np=1 shapes, times the kernel, the plain version and one library
   yardstick, and computes each shape's bound.
4. ResNet reference: a fused ResNet at ResNet-50's four stage widths in bf16
   on the card (kernel) against the same weights in fp32 on the CPU (plain
   version), on a small input.
5. ResNet main path: ``hvd.init()`` on ``cuda:0``, full-width ResNet-50
   (``fuse_conv1x1_bn=True``, bf16 compute), ``hvd.DistributedOptimizer``
   over SGD-momentum, 2 warm-up and 5 timed steps on seeded synthetic data.
   Asserts a finite loss, 36 kernel launches per step, and every gradient
   reduced by the runtime's size-1 ``Allreduce`` each step.
6. Flash-attention kernels: forward, dK/dV and dQ at BERT-large's shape
   (8, 512, 16, 64) and the np=2 path's (4, 512, 16, 64), GPT-small's
   (4, 1024, 12, 64, causal), head_dim 128 (2, 1024, 8, 128) and two
   ragged lengths (200 causal, 1000), each
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
   292 gradients reduced by the size-1 ``Allreduce`` each step.
9. Adasum kernels: ``triplets`` and ``combine`` (``csrc/adasum.cu``) on
   BERT-large's 292-entry fp32 layout whole (334,090,240 elements) and on
   the np=2 VHDD half-window of it (which cuts one entry), ResNet-50's
   161-entry layout and ragged layouts (1-element entries, a zero entry,
   a == b, an odd total), against their plain versions on the same
   inputs: triplets within ``ADASUM_TRIPLET_REL``, the combine within
   ``ADASUM_COMBINE_REL_RMS`` per entry, the same bits on a second launch;
   the whole BERT layout, as one call (a shape the main path does not
   run: it reduces ~20 fused responses a step), times the kernels and the
   plain version and computes the bound (20 bytes per element).
10. NCCL plane, one rank: a one-rank NCCL group in this process drives
   ``Allreduce.execute`` and ``Adasum.execute`` built for the device plane
   (the ops the size > 1 chain registers for ``HOROVOD_DATA_PLANE=nccl``)
   on fused bf16, fp16, fp32 and (allreduce only) int32 responses with
   prescale 0.5 and postscale 2.0, against the plain arithmetic: the same
   bits (Adasum has no round at one rank); and ``Broadcast``, ``Allgather``
   (two tensors in one fused response) and ``Alltoall`` on the same plane
   and dtypes,
   each output the bits of its input.  Then ``HOROVOD_DATA_PLANE=nccl`` at
   np=2 on this one card must fail with the runtime's own message.
11. ResNet-50 at np=2: ``python -m horovod_tpu_torch.runner.launch -np 2``
    on this one card (both ranks ``device="cuda:0"``, the host plane),
    ResNet-50 (bf16, ``fuse_conv1x1_bn=True``, 224x224) at 64 images per
    rank (the np=1 path's global 128), 3 steps through
    ``hvd.DistributedOptimizer``, each rank on its shard of one seeded
    batch.  Asserts on each rank and step: 36 kernel launches, 161
    allreduced gradients, a finite loss; the parameters' hash the same on
    both ranks; for three parameters (the stem conv, the first fused 1x1
    conv, the fc layer) the applied gradient equal on both ranks and
    within ``NP2_GRAD_REL_RMS`` of the mean of both ranks' local gradients
    (a plain backward on the same shard), while the same mean summed in
    bf16 (a narrow plane, the control) lies outside it.  A worker that
    fails fails the run.  The response cache is on (the default): each
    worker reports per step its serialized requests, cache hits and
    misses, mask-only frames sent, fast cycles, cache assignments and
    evictions received, and the wall ms spent in
    ``compute_response_list``; from step 2 on rank 1 must send no
    serialized request and hit the cache 161 times.  The phase runs again
    with ``--cache-capacity 0`` and must end with the same parameter hash,
    bit for bit, after every step (at two ranks the sum ``a + b`` does not
    depend on how the responses are bucketed).  Each rank then sums one
    seeded bf16 and one fp16 tensor of ``NARROW_ELEMENTS`` on the host
    plane (fault C7): the result must be the bits of the fp32 sum rounded
    once, and the bytes the rank handed to the group 2 per element.
12. BERT-large at np=2 (``--worker np2-bert``), the repo's example script's
    start-up: full BERT-large on each rank from its own seed
    (``1234 + rank``), local AdamW steps on its own batch (one on rank 0,
    two on rank 1, so that every state tensor differs, ``step`` included;
    rank 0 then doubles its learning rate), ``hvd.broadcast_object``,
    ``hvd.broadcast_parameters`` and ``hvd.broadcast_optimizer_state`` from
    rank 0 (timed), then 4 sequences x 512 tokens per rank through
    ``hvd.DistributedOptimizer`` on the host plane: rank 0 takes 3 steps,
    rank 1 2, each then calls ``hvd.join()``; an Average allreduce of the
    mean loss, a ragged allgather of the losses, ``hvd.allgather_object``,
    an int32 ``hvd.alltoall`` on the card with splits [1, 2] and [3, 1],
    and ``hvd.barrier()`` close the job.  Asserts: every parameter's and
    optimizer-state tensor's SHA-256, ``param_groups`` and the resume value
    on both ranks equal rank 0's from before the broadcasts (every one of
    those hashes differed across ranks before them, the control); the parameters' hash equal across ranks after steps 1
    and 2; on rank 0's third step, where rank 1 contributes zeros, the
    applied gradient of three parameters within ``NP2_GRAD_REL_RMS`` of
    half its local gradient while the unhalved one lies outside; 24
    launches of each flash kernel and 292 allreduced gradients per step;
    finite losses, 5 allgathered losses equal on both ranks, the
    alltoall's rows and the gathered objects as the arithmetic gives them.
    The response cache is on: the start-up broadcasts fill it past its
    1024 entries, so the gradients' first step evicts (their count is
    printed), and rank 1's second step must send no serialized request.
    The job runs with the launcher's ``--timeline-filename``: both ranks'
    traces are merged and ``critical_path`` splits each step of each rank
    into fusion (``LC_FUSE``/``LC_UNFUSE``: the fused buffer, its copies
    to and from the host and the copy's wait for the gradients), reduce
    (gloo's sum), dispatch and negotiation wait, printed in ms per step
    beside the workers' ``phase_stats`` (fuse, collective, unfuse, wait,
    negotiate) and the host plane's op time.
13. BERT-large at np=2 with Adasum (``--worker np2-bert-adasum``,
    BASELINE config 4): per-rank seeds, ``hvd.broadcast_parameters`` and
    ``hvd.broadcast_optimizer_state``, then
    ``hvd.DistributedOptimizer(AdamW, op=hvd.Adasum)`` for 2 steps of 4 x
    512 tokens per rank on the host plane.  Asserts on each rank and step:
    24 launches of each flash kernel, 292 tensors through the Adasum op and
    none through the allreduce, Adasum kernel launches, the weights written
    as the old ones plus the reduced delta, a finite loss; the parameters'
    hash equal across ranks; in step 1 the applied update of three
    parameters within ``NP2_ADASUM_REL_RMS`` of the fp64 closed form of
    the two ranks' local AdamW steps (taken on clones), which the plain
    mean of the two (the control) must miss over the three together.
    Prints ms per step and in
    the Adasum op beside phase 12's Average numbers.  Each rank records the
    window (entry sizes, lo, hi) of every kernel call: one window per
    triplets and per combine launch.  Then, in this process, the kernels
    are held against their plain versions on every window so recorded, as
    in phase 9, and timed there: per step and rank, the sum over its
    windows.
14. Stall at np=2 (``--worker np2-stall``), both ranks on the card, with
    ``--stall-check-warning-time-seconds 1`` and
    ``--stall-check-shutdown-time-seconds 3``: five steps of two named
    allreduces on the card warm the cache, then rank 0 submits ``stuck``,
    which rank 1 never submits.  Rank 0's handle must raise
    ``HorovodInternalError`` naming ``stuck`` and missing ranks ``[1]``
    within ``STALL_ABORT_S``, rank 1's next enqueue the same text, both
    flight-recorder dumps must name it, and the job must end.

15, 16. The whole step as one CUDA graph: ResNet-50 (b128, SGD-momentum)
    and BERT-large (b8 x 512, ``AdamW(capturable=True)``), each first
    through the eager hook path (``hvd.DistributedOptimizer``) for
    ``GRAPH_STEPS`` steps, then from the same seed on the same batches
    through ``hvd.make_overlapped_train_step`` (one eager step, the
    capture, replays), cuDNN deterministic on both.  Asserts finite
    losses; the parameters after ``GRAPH_STEPS`` steps the same bits as
    the eager path's, or within ``GRAPH_REL_RMS`` (the differing tensors
    printed); 36 B8 launches (ResNet) or 24 of each flash kernel (BERT)
    captured per step; no runtime response during the graph path.  Then
    ``GRAPH_TIMED_STEPS`` more steps of each path are timed in this one
    process and their ratio printed.
17. ``hvd.distributed_value_and_grad`` at 2 layers of BERT-large width
    against the hook path's gradients on the same tokens, within
    ``VALUE_AND_GRAD_REL_RMS``; the flash kernels launched.
18. BERT-large at np=2 with ``DistributedOptimizer(overlap=True)``
    (``--worker np2-overlap``): per-rank seeds, rank 0's weights
    broadcast, ``OVERLAP_STEPS`` steps of ``OVERLAP_PASSES`` microbatches
    of ``OVERLAP_BATCH`` x 512 per rank on the host plane, then the same
    with ``overlap=False``.  Asserts the weights equal across ranks in
    each mode, each mode within ``OVERLAP_REL_RMS`` of the other, one
    fused tensor and one response per microbatch with overlap (292
    tensors per step without), finite losses, and that
    ``make_overlapped_train_step`` on the host plane at np=2 raises the
    text that names ``HOROVOD_DATA_PLANE=nccl`` and
    ``DistributedOptimizer(overlap=True)``.
19. The timeline at np=1: ResNet-50 (b128) and BERT-large (b8 x 512)
    through the eager hook path in one process, ``TIMELINE_STEPS`` steps
    with the timeline off, then ``hvd.start_timeline`` and as many on, then
    ``hvd.stop_timeline``; prints both ms/step and their ratio (no gate on
    it).  Asserts the trace loads as JSON, has one lane per gradient (161,
    292), every ``LC_SUBMITTED`` and ``LC_CALLBACK`` begin has its end,
    every op span carries a cycle, and ``critical_path`` gives one step per
    tagged cycle, every op's cycle among them.
20. ``examples/torch_port/pytorch_synthetic_benchmark.py`` at np=2 on the
    one card (ResNet-50, 32 images per rank, 2 warm-up and 2 timed
    iterations, the host plane) through the launcher's
    ``--timeline-filename``, ``--output-filename`` and ``-v``
    (``--worker example``).  Asserts both rank traces and ``rank.0/``,
    ``rank.1/`` exist, the merged trace holds both pids, every tensor's op
    spans carry the same cycle ids on both ranks, and rank 0 printed the
    example's ``Total img/sec`` line (echoed with its prefix and in its
    file); prints ``critical_path``'s per-rank attribution over the
    gradients' cycles and each rank's ``phase_stats``, in ms per step.
21. ResNet-50 at np=2 with every BatchNorm over both ranks' batch
    (``--worker np2-syncbn``; ``ResNet(sync_bn=True)``: B8's statistics
    summed across the ranks, ``synced_matmul_bn_stats``), on the one card,
    the host plane, bf16, 224x224, SGD-momentum.  One seeded global batch
    of 128 whose second half is ``2x + 1``; this process first takes one
    np=1 step on all of it (the reference) and the same step with the
    halves swapped (the bf16 noise floor, printed).  Each rank then takes
    ``SYNC_STEPS`` steps on its 64 images, and, from the same weights, one
    step with ``sync_bn=False`` (the control).  Asserts on each rank and
    step: 36 B8 launches; 161 allreduced gradients plus 53 forward and 53
    backward statistics allreduces (none in the control); a finite loss;
    the parameters' hash equal on both ranks.  After step 1: the applied
    gradient of ``SYNC_WATCHED`` equal on both ranks and within
    ``SYNC_GRAD_REL_RMS`` of the np=1 step's, the running-statistics update
    of ``SYNC_STATS_WATCHED`` equal on both ranks and within
    ``SYNC_STATS_REL_RMS`` of np=1's; the control outside both limits.
    From step 2 on rank 1 sends no serialized request (each layer's
    allreduces are named after it, so they hit the cache).  Prints ms per
    step beside the control's and phase 11's, the ms in the statistics
    allreduces and the cache counters.
22. The checkpoint (``horovod_tpu_torch.checkpoint``).  In phase 21's
    worker, after the synced steps: rank 0 saves the model and optimizer
    with ``save_rotating``, both ranks ``restore_latest`` onto the card
    (``like=``) and must hold the live state's hash, and a missing path
    must raise ``CheckpointNotFoundError`` on both.  Then in this process
    at np=1: ResNet-50 and its SGD-momentum state (~205 MB) saved with
    ``save_rotating(keep=CKPT_KEEP)`` after steps 1, 2 and 3; one byte of
    the newest payload flipped; ``restore_latest`` must log the skip with
    its reason and return step 2's snapshot, from which step 3
    (deterministic cuDNN) must give the live step 3's bits; ``restore``
    of a missing path raises ``CheckpointNotFoundError``.  Prints the save
    and restore seconds and MB/s.
23. Elastic ResNet-50 at np=2 on the one card (``--worker elastic DIR``)
    through ``--min-np 1 --max-np 2 --host-discovery-script``: sizes 2, 1,
    2, 1 (a host dropped, added back, a rank SIGKILLed), 36 B8 launches per
    step, equal state hashes after every sync, the first size-1 step the
    bits of a step without the runtime, the survivor back at its last
    commit; prints each change's recovery split.
24. The same job through a supervised rendezvous server (``--worker
    outage DIR``): ``python -m horovod_tpu_torch.runner.rendezvous`` with a
    journal under ``_runs/`` and its own trace, the launcher attached with
    ``HOROVOD_RENDEZVOUS_EXTERNAL``, the timelines and the control-plane
    spans on, renewals every ``OUTAGE_RENEW_SECS``.  Once both ranks have
    taken ``OUTAGE_PRE_STEPS`` steps the phase SIGKILLs the server, keeps
    it down ``OUTAGE_SECS`` while the ranks train, starts it again on its
    port over its journal, and, after two more renewal periods, drops
    ``127.0.0.1`` from the hosts file (a shrink); ``OUTAGE_SIZE1_STEPS``
    steps at size 1 end the job.  Gates: exit 0; one process per host (no
    worker shed); every step before the shrink at size 2 in epoch 0 (no
    epoch for the outage); the restarted server's replayed epoch 0 and the
    shrink at epoch 1; failed renewals on both ranks during the outage;
    36 B8 launches per step and the same parameters on both ranks; one
    ``CHURN_EVENT`` in the driver's trace, whose ``control_path`` phases
    sum to its coverage within 1%.  Prints the outage's seconds, the
    replay's ms, ms per step before, during and after the outage, the
    shrink's split, the journal's bytes and durable writes per second.

The last two lines are the kernels' JSON summary (B8, whose launches are
phase 5's, phase 21's synced steps' on both ranks and phases 23's and
24's steps' on every process, the three flash
kernels and the Adasum kernels, whose launches are phase 13's and whose
times are the sums over phase 13's windows per step and rank, averaged
over its ranks and steps) and
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --worker np2-resnet DIR``, ``--worker np2-bert DIR``,
``--worker np2-bert-adasum DIR``, ``--worker np2-stall DIR``, ``--worker
np2-overlap DIR``, ``--worker nccl-np2``, ``--worker example SCRIPT
ARGS...``, ``--worker np2-syncbn DIR``, ``--worker elastic DIR`` and
``--worker outage DIR`` are the launched workers of phases 11, 12, 13, 14,
18, 10, 20, 21, 23 and 24.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import runpy
import secrets
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch import ops as hvd_ops
from horovod_tpu_torch.backend import adasum as adasum_backend
from horovod_tpu_torch.backend import cuda as cuda_backend
from horovod_tpu_torch.common.env import PLANE_HOST, PLANE_NCCL
from horovod_tpu_torch.common.exceptions import (
    CheckpointNotFoundError,
    HorovodInternalError,
)
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core import controller as controller_mod
from horovod_tpu_torch.core.messages import DataType, Response, ResponseType
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.core.tensor_queue import TensorTableEntry
from horovod_tpu_torch.core.timeline import phase_stats
from horovod_tpu_torch.kernels import adasum as adasum_kernels
from horovod_tpu_torch.kernels import build, conv_bn_stats
from horovod_tpu_torch.kernels import flash_attention as fa
from horovod_tpu_torch.models import resnet, transformer
from horovod_tpu_torch.models.training import cross_entropy_loss, train_step
from horovod_tpu_torch.tools import control_path, critical_path, trace_merge
from horovod_tpu_torch.transport.store import HTTPStoreClient

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



def resnet50_shapes(batch: int) -> dict:
    """(M, K, N) -> launches per forward of ResNet-50 at ``batch`` images
    of 224x224; M = batch * H * W of the layer's output."""
    s1, s2, s3, s4 = (batch * s * s for s in (56, 28, 14, 7))
    return {
        (s1, 64, 64): 1, (s1, 64, 256): 4, (s1, 256, 64): 2,
        (s1, 256, 128): 1, (s2, 128, 512): 4, (s2, 256, 512): 1,
        (s2, 512, 128): 3,
        (s2, 512, 256): 1, (s3, 256, 1024): 6, (s3, 512, 1024): 1,
        (s3, 1024, 256): 5,
        (s3, 1024, 512): 1, (s4, 512, 2048): 3, (s4, 1024, 2048): 1,
        (s4, 2048, 512): 2,
    }


MAIN_PATH_SHAPES = resnet50_shapes(BATCH)
# Ragged: M not a multiple of the 128-row tile, K = 64; N = 200 is not a
# multiple of the 128-column tile either.  The last two have K or N not a
# multiple of 8: the wrapper zero-pads them and slices the outputs back.
RAGGED_SHAPES = [(12289, 64, 64), (1000, 64, 200), (1000, 60, 200),
                 (37, 64, 12)]

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
# BERT-large at np=2: sequences per rank, the np=1 path's global batch of 8.
NP2_BERT_BATCH = 4
# (name, b, s, h, d, causal, timed).  The first is the np=1 main path's
# shape and the second the np=2 path's, each launched once per layer per
# step by each kernel.
FLASH_SHAPES = [
    ("bert_large", BERT_BATCH, BERT_SEQ, 16, 64, False, True),
    ("bert_large_np2", NP2_BERT_BATCH, BERT_SEQ, 16, 64, False, False),
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

# ResNet-50 at np=2 on the one card, through the launcher and the host plane.
NP2_BATCH = 64          # per rank: the np=1 path's global batch of 128
# Each rank's B8 shapes; at 7x7, M = 3136 leaves a half-full last row tile.
NP2_SHAPES = resnet50_shapes(NP2_BATCH)
NP2_STEPS = 3
NP2_PARAMS = 161
NP2_WATCHED = ("conv_init.kernel", "BottleneckBlock_0.FusedConv1x1BN_0.kernel",
               "Dense_0.kernel")
# Applied gradient against the mean of both ranks' local gradients, taken by
# a second forward and backward on the same shard (cuDNN deterministic, so
# both backwards give the same bits): relative RMS.  The local gradients
# are bf16 values held in fp32 (bf16 compute, fp32 parameters), so the
# plane's fp32 sum of two of them is exact unless their exponents are more
# than 16 apart, and the halving is exact: the widened plane reads 0, or
# at most ~2^-24.  A plane that carried or summed them in bf16 reads about
# 2^-9 (the control in ``phase_np2_resnet``), so the limit lies between.
NP2_GRAD_REL_RMS = 1e-6
# BERT-large at np=2 on the one card: per-rank seeds, the start-up
# broadcasts, rank 1 joining while rank 0 takes a third step.
NP2_BERT_STEPS = (3, 2)  # steps of rank 0 and rank 1
NP2_BERT_LOCAL_STEPS = (1, 2)  # their local AdamW steps before the broadcast
NP2_BERT_WATCHED = ("layer_0.attn.qkv.kernel", "layer_23.ffn_out.kernel",
                    "ln_f.scale")
# Rows each rank sends to rank 0 and rank 1 in the closing alltoall.
NP2_BERT_SPLITS = ([1, 2], [3, 1])
# The Adasum kernels against their plain versions (same fp32 inputs): the
# fp64 triplets within ADASUM_TRIPLET_REL of each value, the dot product's
# taken relative to sqrt(|a|^2 |b|^2) (its Cauchy-Schwarz bound: a dot of
# nearly orthogonal entries cancels); the combine within
# ADASUM_COMBINE_REL_RMS per entry (both round the same fp32 products, but
# a coefficient may round the other way when the triplets differ in their
# last bits); the same bits on a second launch.
ADASUM_TRIPLET_REL = 1e-12
ADASUM_COMBINE_REL_RMS = 1e-6
# Least bytes per fp32 element: a and b read by the triplets pass (8), a
# and b read and the output written by the combine (12).
ADASUM_BYTES_PER_ELEMENT = 20
PEAK_FP64_FLOPS = 34e12    # H100 SXM fp64 outside the tensor cores
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
# Ragged layout: 1-element entries, a 1000-element entry that is zero in a
# (adasum(0, b) == b), one zero in both, an odd total of 66,557.
ADASUM_RAGGED = [1, 1, 7, 1000, 3, 1, 65537, 2, 5]
# BERT-large at np=2 with Adasum (BASELINE config 4): the applied update of
# the watched tensors in step 1 against the fp64 closed form of the two
# ranks' local AdamW steps, relative RMS.  The port's fp64 triplets and
# fp32 combine put it at ~1e-7; the plain mean of the two steps (the
# control) must miss the three tensors' closed forms together by more.
NP2_ADASUM_STEPS = 2
NP2_ADASUM_REL_RMS = 1e-5
# The stall phase: shutdown time, and the limit on the abort's arrival.
STALL_SHUTDOWN_S = 3
STALL_ABORT_S = 15
STALL_TIMEOUT = 120
# The controller's counters each np=2 worker reports per step.
NEGOTIATION_COUNTERS = ("serialized_request_count", "cache_hit_count",
                        "cache_miss_count", "mask_only_sent_count",
                        "fast_cycle_count", "idle_fast_cycle_count")
LAUNCH_TIMEOUT = 300
REPO = Path(__file__).resolve().parent
# Fault C7: the elements of the bf16 and fp16 host-plane Sums in the np=2
# ResNet worker.
NARROW_ELEMENTS = 16 * 2 ** 20
# The whole step as one CUDA graph against the eager hook path, from the
# same seed on the same batches: the parameters after GRAPH_STEPS steps the
# same bits, or within GRAPH_REL_RMS relative RMS where an op's order
# differs between the two; then GRAPH_TIMED_STEPS more steps of each timed.
GRAPH_STEPS = 3
GRAPH_TIMED_STEPS = 5
GRAPH_REL_RMS = 1e-6
# distributed_value_and_grad against the hook path, 2 layers at BERT-large
# width: the gradients' relative RMS.
VALUE_AND_GRAD_REL_RMS = 1e-6
# BERT-large at np=2 with DistributedOptimizer(overlap=True): microbatches
# of 2 x 512 per rank, 2 per step, 2 steps; the weights against the same
# job with overlap=False, relative RMS.
OVERLAP_BATCH = 2
OVERLAP_PASSES = 2
OVERLAP_STEPS = 2
OVERLAP_REL_RMS = 1e-6
# The timeline at np=1: steps timed with it off, then on, in one process.
TIMELINE_STEPS = 5
# The np=2 example through the launcher's new flags: ResNet-50, 32 images
# per rank, 2 warm-up and 2 timed iterations of 3 batches, both ranks on
# the one card.
EXAMPLE = REPO / "examples" / "torch_port" / "pytorch_synthetic_benchmark.py"
EXAMPLE_ARGS = ("--device", "cuda:0", "--batch-size", "32",
                "--num-warmup-batches", "2", "--num-iters", "2")
EXAMPLE_STEPS = 2 + 2 * 3
# Phase 21: ResNet-50 at np=2 with every BatchNorm synced across the ranks,
# against one np=1 step on the whole batch.  One seeded global batch of
# 128 (each rank its 64), its second half 2x + 1: the ranks' local
# statistics then differ by O(1).  SYNC_STEPS synced steps, then one
# unsynced (the control).
SYNC_STEPS = 2
# The layers whose statistics each step allreduces, forward and backward:
# the stem, the 16 3x3 BatchNorms and the 36 fused 1x1 layers.
SYNC_LAYERS = 53
# Parameters whose applied gradient is held against np=1's: the stem conv,
# the first fused 1x1 conv with a gradient in step 1 (the first block's
# projection: flax zero-inits each block's last BatchNorm scale, so the
# block's FusedConv1x1BN_0 gets none) and the fc layer.
SYNC_WATCHED = ("conv_init.kernel", "BottleneckBlock_0.fused_proj.kernel",
                "Dense_0.kernel")
# Layers whose running statistics are held against np=1's: the stem's
# BatchNorm, the first fused 1x1 layer and a fused 1x1 layer at 7x7 (whose
# M = 64 * 49 per rank leaves a half-full last row tile).
SYNC_STATS_WATCHED = ("bn_init", "BottleneckBlock_0.FusedConv1x1BN_0",
                      "BottleneckBlock_13.FusedConv1x1BN_1")
# Relative RMS against the np=1 step: the applied gradient of SYNC_WATCHED,
# and each watched layer's running-statistics update (running minus its
# initial value).  The np=1 step itself, with the batch's halves swapped
# (only the order of its sums changes), lies 0.025 from the unswapped one
# on conv_init's gradient, 0.022 on the projection's and 0.0014 on fc's:
# the BatchNorm backward's cancellation leaves bf16 noise of that size in
# the gradients below it (an H100 80GB HBM3 at 700 W; the phase prints
# this floor each time).  The gradient limit is twice that floor; the
# statistics, fp32 sums, sit at 1e-4 of it.  The unsynced control
# (0.43-1.16 and 0.056-1.0 there) must exceed each limit on its watched
# set.
SYNC_GRAD_REL_RMS = 0.05
SYNC_STATS_REL_RMS = 0.02
# Phase 22: the rotating snapshots kept.
CKPT_KEEP = 2

# Phase 23: elastic ResNet-50 at np=2 on the one card.  The batches at
# which the job pauses for a change of its hosts, with the size it runs at
# then and the hosts file the phase writes (``ELASTIC_KILL``: the rank on
# 127.0.0.1 SIGKILLs itself during that batch's backward), and the batches
# in all.  Sizes 2 (batches 0-2), 1 (3-4), 2 (5-6), 1 (7-8).
ELASTIC_BOTH = "localhost:1\n127.0.0.1:1\n"
ELASTIC_PLAN = {3: (2, "localhost:1\n"), 5: (1, ELASTIC_BOTH)}
ELASTIC_KILL = 7
ELASTIC_BATCHES = 9
ELASTIC_SIZES = [2, 2, 2, 1, 1, 2, 2, 1, 1]
# How long a paused worker waits for the driver's ping.
ELASTIC_PAUSE_SECS = 120

# Phase 24: phase 23's job through a supervised rendezvous server.  The
# lease renewals' period (HOROVOD_METRICS_PUSH_SECS); the steps each rank
# takes before the server is SIGKILLed; how long it stays down (at least
# two renewal periods, under the 15 s lease timeout); the steps at size 1
# after the shrink.
OUTAGE_RENEW_SECS = 1.0
OUTAGE_PRE_STEPS = 3
OUTAGE_SECS = 3 * OUTAGE_RENEW_SECS
OUTAGE_SIZE1_STEPS = 2

# The op spans of the trace, and critical_path's phases chip_smoke prints.
OP_SPANS = ("ALLREDUCE", "ADASUM", "BROADCAST", "ALLGATHER", "ALLTOALL")
TRACE_PHASES = ("fusion", "reduce", "dispatch", "negotiation_wait")


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
    # The np=2 path's shapes, checked but not timed.
    for m, k, n in [*NP2_SHAPES, *RAGGED_SHAPES]:
        row = check_kernel_shape(m, k, n, gen, block_m, timed=False)
        rows.append(row)
        print("kernel", json.dumps(row), flush=True)
    assert sum(MAIN_PATH_SHAPES.values()) == LAUNCHES_PER_STEP
    assert sum(NP2_SHAPES.values()) == LAUNCHES_PER_STEP
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
            "sizes": [p.numel() for _, p in params],
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
            "sizes": [p.numel() for _, p in params],
            "n_weights": sum(p.numel() for _, p in params),
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def adasum_bound(n: int, entries: int):
    """Least time (ms) of the triplets and the combine over ``n`` fp32
    elements and what bounds it: ``ADASUM_BYTES_PER_ELEMENT`` per element
    and the triplets written and read (48 bytes per entry) over the HBM
    rate, against 6 fp64 operations (three multiply-adds) and 3 fp32 ones
    per element over their rates."""
    bytes_s = (ADASUM_BYTES_PER_ELEMENT * n + 48 * entries) / PEAK_BYTES
    ops_s = 6.0 * n / PEAK_FP64_FLOPS + 3.0 * n / PEAK_FP32_FLOPS
    return 1e3 * max(ops_s, bytes_s), \
        "operations" if ops_s > bytes_s else "bytes"


def adasum_layouts(bert_sizes: list, resnet_sizes: list) -> list:
    """(name, entry sizes, window lo, window hi, a == b, timed): BERT-large's
    292 entries whole (timed as one call) and the np=2 VHDD half-window of
    them (the lower half, had the whole layout been one response),
    ResNet-50's 161 entries, and ragged ones (``ADASUM_RAGGED``; the
    second window cuts entries and has a == b)."""
    total = sum(bert_sizes)
    return [
        ("bert_large", bert_sizes, 0, total, False, True),
        ("bert_large_np2_half", bert_sizes, 0, total // 2, False, False),
        ("resnet50", resnet_sizes, 0, sum(resnet_sizes), False, False),
        ("ragged", ADASUM_RAGGED, 0, sum(ADASUM_RAGGED), False, False),
        ("ragged_identical", ADASUM_RAGGED, 3, sum(ADASUM_RAGGED) - 2, True,
         False),
    ]


def check_adasum_layout(name: str, sizes: list, lo: int, hi: int,
                        identical: bool, timed: bool,
                        gen: torch.Generator) -> dict:
    dev = torch.device("cuda", 0)
    n, entries = hi - lo, len(sizes)
    segs = adasum_backend._segment_bounds(sizes, lo, hi)
    a = torch.randn(n, device=dev, generator=gen)
    b = a.clone() if identical else \
        torch.randn(n, device=dev, generator=gen) + 0.5 * a
    if name == "ragged":
        for idx, s_lo, s_hi in segs:
            if idx in (3, 5):
                a[s_lo:s_hi] = 0
            if idx == 5:
                b[s_lo:s_hi] = 0
    trip = adasum_kernels.triplets(a, b, segs, entries)
    out = adasum_kernels.combine(a, b, segs, trip)
    # No atomics: a second launch on the same inputs gives the same bits.
    trip2 = adasum_kernels.triplets(a, b, segs, entries)
    out2 = adasum_kernels.combine(a, b, segs, trip2)
    torch.cuda.synchronize()
    repeatable = torch.equal(trip, trip2) and torch.equal(out, out2)
    del trip2, out2
    trip_ref = adasum_kernels.triplets_reference(a, b, segs, entries)
    out_ref = adasum_kernels.combine_reference(a, b, segs, trip_ref)
    scale = trip_ref.abs()
    scale[:, 0] = torch.maximum(scale[:, 0],
                                (trip_ref[:, 1] * trip_ref[:, 2]).sqrt())
    diff = (trip - trip_ref).abs()
    if bool((diff[scale == 0] != 0).any()):
        raise AssertionError(f"adasum {name}: a zero triplet is not zero")
    trip_rel = (diff / scale.clamp_min(1e-300)).max().item()
    worst, cut = 0.0, 0
    for idx, s_lo, s_hi in segs:
        cut += s_hi - s_lo < sizes[idx]
        ref = out_ref[s_lo:s_hi]
        if ref.norm() == 0:
            if bool(out[s_lo:s_hi].any()):
                raise AssertionError(f"adasum {name}: entry {idx} is not 0")
            continue
        worst = max(worst, rel_rms(out[s_lo:s_hi], ref))
    row = {"layout": name, "entries": entries, "segments": len(segs),
           "cut_entries": cut, "elements": n,
           "max_abs_err": (out - out_ref).abs().max().item(),
           "triplet_rel_err": trip_rel, "combine_rel_rms": worst,
           "bitwise_repeatable": repeatable}
    if not (repeatable and trip_rel <= ADASUM_TRIPLET_REL
            and worst <= ADASUM_COMBINE_REL_RMS):
        raise AssertionError(f"adasum kernels disagree with their plain "
                             f"versions on {name}: {row}")
    if name == "ragged":
        zero_in_a = next(s for s in segs if s[0] == 3)
        assert torch.equal(out[zero_in_a[1]:zero_in_a[2]],
                           b[zero_in_a[1]:zero_in_a[2]]), "adasum(0, b) != b"
    del out_ref, trip_ref, diff, scale
    if timed:
        buf = torch.empty_like(a)
        row["triplets_ms"] = cuda_ms(
            lambda: adasum_kernels.triplets(a, b, segs, entries), 10)
        row["combine_ms"] = cuda_ms(
            lambda: adasum_kernels.combine(a, b, segs, trip, out=buf), 10)
        row["ms"] = row["triplets_ms"] + row["combine_ms"]
        row["plain_ms"] = cuda_ms(
            lambda: adasum_kernels.combine_reference(
                a, b, segs,
                adasum_kernels.triplets_reference(a, b, segs, entries)), 3,
            warmup=1)
        row["bound_ms"], row["bound_by"] = adasum_bound(n, entries)
        # No one PyTorch call computes a per-entry Adasum.
        row["library_ms"] = None
    return row


def phase_adasum_kernels(bert_sizes: list, resnet_sizes: list) -> list:
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for layout in adasum_layouts(bert_sizes, resnet_sizes):
        row = check_adasum_layout(*layout, gen=gen)
        rows.append(row)
        print("adasum kernel", json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    half = next(r for r in rows if r["layout"] == "bert_large_np2_half")
    assert half["cut_entries"] == 1, half
    return rows


def adasum64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The closed form of one entry's Adasum, in fp64."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    dot, aa, bb = a @ b, a @ a, b @ b
    eps = adasum_kernels.NORMSQ_EPS
    ca = 1.0 - dot / (2.0 * aa) if aa >= eps else 1.0
    cb = 1.0 - dot / (2.0 * bb) if bb >= eps else 1.0
    return ca * a + cb * b


def _ready_entry(name: str, tensor: torch.Tensor, stream,
                 **fields) -> TensorTableEntry:
    ready = torch.cuda.Event()
    ready.record(stream)
    return TensorTableEntry(name, tensor=tensor, device=0, ready_event=ready,
                            ready_stream=stream, **fields)


def phase_nccl_one_rank() -> dict:
    """The device plane's ops on a one-rank NCCL group: ``Allreduce`` and
    ``Adasum`` (the fused buffer, the widening, the scales and the unfuse
    on the card; Adasum has no round at one rank) against the plain
    arithmetic, and ``Broadcast``, ``Allgather`` (two
    tensors in one fused response) and ``Alltoall``, which move
    bits, against their inputs' bytes."""
    dev = torch.device("cuda", 0)
    # Built as the runtime builds its device plane's group.
    group = cuda_backend.nccl_group(dist.HashStore(), 0, 1, LAUNCH_TIMEOUT)
    try:
        # Driven directly: enabled() would ask for size > 1.
        topo = ProcessTopology()
        nccl = PLANE_NCCL
        op = cuda_backend.Allreduce(topo, dev, nccl, group)
        adasum = adasum_backend.Adasum(topo, dev, nccl, group)
        moves = {"broadcast": cuda_backend.Broadcast(topo, dev, nccl, group),
                 "allgather": cuda_backend.Allgather(topo, dev, nccl, group),
                 "alltoall": cuda_backend.Alltoall(topo, dev, nccl, group)}
        gen = torch.Generator(device=dev).manual_seed(3)
        stream = torch.cuda.current_stream(dev)
        checked = {}
        for dtype in (torch.bfloat16, torch.float16, torch.float32,
                      torch.int32):
            shapes = [(1000,), (37, 3), (4096, 64)]
            if dtype == torch.int32:
                tensors = [torch.randint(-2**20, 2**20, s, device=dev,
                                         generator=gen, dtype=dtype)
                           for s in shapes]
            else:
                tensors = [(torch.randn(s, device=dev, generator=gen) * 10)
                           .to(dtype) for s in shapes]
            entries = [_ready_entry(f"{dtype}.{i}", t, stream,
                                    prescale_factor=0.5, postscale_factor=2.0)
                       for i, t in enumerate(tensors)]
            response = Response(
                tensor_names=[e.tensor_name for e in entries],
                tensor_type=DataType.from_torch(dtype),
                tensor_sizes=[t.numel() for t in tensors], devices=[0],
                prescale_factor=0.5, postscale_factor=2.0)
            status = op.execute(response, entries)
            assert status.ok and status.pending, status
            entries[0].done_event.synchronize()
            for e in entries:
                plain = (cuda_backend.widened(e.tensor) * 0.5 * 2.0) \
                    .to(dtype)
                if not torch.equal(e.output, plain):
                    raise AssertionError(
                        f"nccl allreduce {dtype} {tuple(e.tensor.shape)}: "
                        f"max |err| "
                        f"{(e.output.double() - plain.double()).abs().max()}")
            checked[str(dtype)] = {"allreduce": len(entries)}
            if dtype != torch.int32:
                # Adasum over one rank: no round, the scales only.
                launches = sum(adasum_kernels.LAUNCHES.values())
                entries = [_ready_entry(f"adasum.{dtype}.{i}", t, stream,
                                        prescale_factor=0.5,
                                        postscale_factor=2.0)
                           for i, t in enumerate(tensors)]
                status = adasum.execute(dataclasses.replace(
                    response, response_type=ResponseType.ADASUM,
                    tensor_names=[e.tensor_name for e in entries]), entries)
                assert status.ok and status.pending, status
                entries[0].done_event.synchronize()
                for e in entries:
                    plain = (cuda_backend.widened(e.tensor) * 0.5 * 2.0) \
                        .to(dtype)
                    if not torch.equal(e.output, plain):
                        err = (e.output.double() - plain.double()).abs()
                        raise AssertionError(
                            f"nccl adasum {dtype} {tuple(e.tensor.shape)}: "
                            f"max |err| {err.max()}")
                assert sum(adasum_kernels.LAUNCHES.values()) == launches
                checked[str(dtype)]["adasum"] = len(entries)
            kind = DataType.from_torch(dtype)
            cases = {
                "broadcast": ([_ready_entry("b", tensors[2], stream,
                                            root_rank=0)],
                              Response(ResponseType.BROADCAST, ["b"], kind,
                                       [tensors[2].numel()], devices=[0])),
                "allgather": ([_ready_entry("g0", tensors[1], stream),
                               _ready_entry("g1", tensors[2], stream)],
                              Response(ResponseType.ALLGATHER, ["g0", "g1"],
                                       kind, [37, 4096], devices=[0])),
                "alltoall": ([_ready_entry("a", tensors[2], stream,
                                           splits=[4096])],
                             Response(ResponseType.ALLTOALL, ["a"], kind,
                                      [4096], devices=[0])),
            }
            for name, (move_entries, move_response) in cases.items():
                status = moves[name].execute(move_response, move_entries)
                assert status.ok and status.pending, (name, status)
                move_entries[0].done_event.synchronize()
                for e in move_entries:
                    if e.output.shape != e.tensor.shape or not torch.equal(
                            cuda_backend.as_bytes(e.output),
                            cuda_backend.as_bytes(e.tensor)):
                        raise AssertionError(
                            f"nccl {name} {dtype} {tuple(e.tensor.shape)}: "
                            f"output {tuple(e.output.shape)} is not the "
                            "input's bits")
                checked[str(dtype)][name] = len(move_entries)
        return checked
    finally:
        group.shutdown()


def launch_job(np_: int, worker: list, timeout: float,
               extra_env: dict = None, launcher_args: list = ()):
    """Runs this script's ``--worker`` mode through the port's launcher in
    a session of its own, killed whole if it outlasts ``timeout``."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           str(np_), *launcher_args, sys.executable,
           str(REPO / "chip_smoke.py"), "--worker", *worker]
    proc = subprocess.Popen(
        cmd, cwd=str(REPO), text=True,
        env={**os.environ, **(extra_env or {})}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"launch {worker} timed out after {timeout}s:"
                             f"\n{out}\n{err}")
    return proc.returncode, out, err


def phase_nccl_np2_refused() -> str:
    """``HOROVOD_DATA_PLANE=nccl`` at np=2 on one card: NCCL cannot hold two
    ranks of one communicator on one device, so the job must end with the
    runtime's message, neither hanging nor falling back to the host plane."""
    t0 = time.perf_counter()
    code, out, err = launch_job(2, ["nccl-np2"], LAUNCH_TIMEOUT,
                                {"HOROVOD_DATA_PLANE": "nccl"})
    want = "HOROVOD_DATA_PLANE=nccl needs one card per rank"
    if code == 0 or want not in err or "NCCL_PLANE_UP" in out:
        raise AssertionError(f"nccl at np=2 on one card: exit {code}, "
                             f"expected the runtime's refusal:\n{out}\n{err}")
    line = next(l for l in err.splitlines() if want in l)
    return f"exit {code} after {time.perf_counter() - t0:.1f}s: {line.strip()}"


def nccl_np2_worker() -> None:
    hvd.init(device="cuda:0")
    print("NCCL_PLANE_UP", hvd.rank(), flush=True)


def time_host_allreduce() -> list:
    """Wall time the background thread spends in the host plane's
    allreduce (its copies wait for the gradients' ready events, so
    backward overlaps), summed into the returned list's one item."""
    op_seconds = [0.0]
    execute = cuda_backend.Allreduce.execute

    def timed_execute(self, response, entries):
        if self.plane != PLANE_HOST:
            return execute(self, response, entries)
        t = time.perf_counter()
        try:
            return execute(self, response, entries)
        finally:
            op_seconds[0] += time.perf_counter() - t

    cuda_backend.Allreduce.execute = timed_execute
    return op_seconds


def negotiation_probe() -> dict:
    """Wraps the controller's round in this worker: the wall seconds spent
    in ``compute_response_list`` and the cache assignments and evictions in
    the ``ResponseList``s it returned (a mask-only cycle carries none),
    summed into the returned dict."""
    acc = {"seconds": 0.0, "assignments": 0, "evictions": 0}
    compute = controller_mod.Controller.compute_response_list

    def timed(self, requests, should_shutdown=False):
        t = time.perf_counter()
        try:
            rl = compute(self, requests, should_shutdown)
        finally:
            acc["seconds"] += time.perf_counter() - t
        acc["assignments"] += len(rl.cache_assignments)
        acc["evictions"] += len(rl.evicted_bits)
        return rl

    controller_mod.Controller.compute_response_list = timed
    return acc


def negotiation_snapshot(probe: dict) -> dict:
    """The controller's counters and the probe's sums, for a per-step
    difference."""
    ctl = global_state().controller
    return {**{k: getattr(ctl, k) for k in NEGOTIATION_COUNTERS},
            "negotiation_ms": 1e3 * probe["seconds"],
            "assignments": probe["assignments"],
            "evictions": probe["evictions"]}


def negotiation_delta(before: dict, probe: dict) -> dict:
    after = negotiation_snapshot(probe)
    return {k: after[k] - before[k] for k in after}


def np2_worker(out_dir: str) -> None:
    """One rank of the np=2 ResNet-50 job: 3 steps, with the counts, times,
    hashes and watched gradients of each written to ``out_dir``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The local gradients' second backward gives the applied one's bits.
    torch.backends.cudnn.deterministic = True
    hvd.init(device="cuda:0")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd.device()
    assert size == 2 and dev == torch.device("cuda", 0), (size, dev)
    model = resnet.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
        generator=torch.Generator().manual_seed(0)).to(dev)
    params = list(model.named_parameters())
    watched = [p for name, p in params if name in NP2_WATCHED]
    assert len(params) == NP2_PARAMS and len(watched) == len(NP2_WATCHED)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=params)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(size * NP2_BATCH, IMAGE, IMAGE, 3, device=dev,
                    generator=gen)
    y = torch.randint(0, 1000, (size * NP2_BATCH,), device=dev, generator=gen)
    shard = slice(rank * NP2_BATCH, (rank + 1) * NP2_BATCH)
    batch = {"x": x[shard].contiguous(), "y": y[shard].contiguous()}
    del x, y
    op_seconds = time_host_allreduce()
    probe = negotiation_probe()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for _ in range(NP2_STEPS):
        model.train()
        local = torch.autograd.grad(
            cross_entropy_loss(model(batch["x"]), batch["y"]), watched)
        local = [g.float().cpu() for g in local]
        torch.cuda.synchronize()
        launches = conv_bn_stats.LAUNCHES
        counts = dict(cuda_backend.stats)
        op_seconds[0] = 0.0
        negotiation = negotiation_snapshot(probe)
        t0 = time.perf_counter()
        loss = train_step(model, opt, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        steps.append({
            **negotiation_delta(negotiation, probe),
            "loss": float(loss), "ms": ms, "plane_ms": 1e3 * op_seconds[0],
            "launches": conv_bn_stats.LAUNCHES - launches,
            **{k: cuda_backend.stats[k] - counts[k] for k in counts},
            "hash": hashlib.sha256(b"".join(
                p.detach().float().cpu().numpy().tobytes()
                for _, p in params)).hexdigest(),
            "local": local,
            "applied": [p.grad.float().cpu() for p in watched]})
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    narrow = narrow_ring_probe(rank, dev)
    hvd.shutdown()
    torch.save({"steps": steps, "peak_mem_gb": peak, "narrow": narrow},
               os.path.join(out_dir, f"rank{rank}.pt"))
    print("NP2_DONE", rank, flush=True)


def narrow_ring_probe(rank: int, dev: torch.device) -> dict:
    """Fault C7 on the card: one host-plane Sum of a seeded bf16 tensor and
    one of fp16, each of ``NARROW_ELEMENTS``; per dtype, whether the result
    is the bits of the fp32 sum of both ranks' tensors rounded once, and
    the bytes this rank handed to the group."""
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        values = [torch.randn(NARROW_ELEMENTS, device=dev,
                              generator=torch.Generator(device=dev)
                              .manual_seed(300 + r)).to(dtype)
                  for r in range(2)]
        before = cuda_backend.stats["host_ring_bytes_sent"]
        t0 = time.perf_counter()
        got = hvd.allreduce(values[rank], op=hvd.Sum,
                            name=f"narrow.{dtype}")
        seconds = time.perf_counter() - t0
        once = (values[0].float() + values[1].float()).to(dtype)
        out[str(dtype)] = {
            "same_bits": torch.equal(got.view(torch.int16),
                                     once.view(torch.int16)),
            "sent": cuda_backend.stats["host_ring_bytes_sent"] - before,
            "ms": 1e3 * seconds}
    return out


def run_np2_resnet(launcher_args: list = ()) -> tuple:
    # Inside the checkout (``_runs/`` is gitignored), deleted afterwards.
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="np2_resnet.",
                                     dir=REPO / "_runs") as out_dir:
        t0 = time.perf_counter()
        code, out, err = launch_job(2, ["np2-resnet", out_dir],
                                    LAUNCH_TIMEOUT,
                                    launcher_args=launcher_args)
        seconds = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"np=2 ResNet-50 job {launcher_args} failed "
                                 f"with exit {code}:\n{out}\n{err}")
        return seconds, [torch.load(Path(out_dir) / f"rank{r}.pt")
                         for r in range(2)]


def phase_np2_resnet(card_line: str) -> dict:
    seconds, ranks = run_np2_resnet()
    # The control: the same mean summed in bf16, as a narrow plane would.
    worst, narrowest = 0.0, math.inf
    for step in range(NP2_STEPS):
        s0, s1 = (r["steps"][step] for r in ranks)
        for r, s in enumerate((s0, s1)):
            assert s["launches"] == LAUNCHES_PER_STEP, (r, step, s)
            assert s["allreduce_tensors"] == NP2_PARAMS, (r, step, s)
            assert math.isfinite(s["loss"]), (r, step, s["loss"])
        if s0["hash"] != s1["hash"]:
            raise AssertionError(f"step {step}: parameters differ across "
                                 f"ranks ({s0['hash']} vs {s1['hash']})")
        for name, a0, a1, l0, l1 in zip(NP2_WATCHED, s0["applied"],
                                        s1["applied"], s0["local"],
                                        s1["local"]):
            assert torch.equal(a0, a1), (step, name)
            mean = (l0.double() + l1.double()) / 2
            err = rel_rms(a0, mean)
            narrow = rel_rms((l0.bfloat16() + l1.bfloat16()) / 2, mean)
            worst, narrowest = max(worst, err), min(narrowest, narrow)
            if err > NP2_GRAD_REL_RMS or narrow <= NP2_GRAD_REL_RMS:
                raise AssertionError(
                    f"step {step} {name}: applied gradient vs the mean of "
                    f"the local ones, relative RMS {err!r} (limit "
                    f"{NP2_GRAD_REL_RMS}); the bf16 sum's {narrow!r} must "
                    f"exceed the limit")
    # The cache: from step 2 on, rank 1's gradients go up as bits only.
    for step, s in enumerate(ranks[1]["steps"][1:], start=1):
        if s["serialized_request_count"] != 0 or \
                s["cache_hit_count"] != NP2_PARAMS:
            raise AssertionError(
                f"step {step}: rank 1 sent {s['serialized_request_count']} "
                f"serialized requests and hit the cache "
                f"{s['cache_hit_count']} times (expected 0 and {NP2_PARAMS})")
    # Fault C7: bf16 and fp16 cross the host plane at their own width,
    # each hop rounding once (once in all at np=2).
    narrow_bytes = 2 * 2 * NARROW_ELEMENTS // 2     # 2·2·(P−1)/P per element
    for r, rank_out in enumerate(ranks):
        for dtype, got in rank_out["narrow"].items():
            if not got["same_bits"] or got["sent"] != narrow_bytes:
                raise AssertionError(
                    f"rank {r} {dtype}: host-plane Sum of {NARROW_ELEMENTS} "
                    f"elements {got}; expected the fp32 sum rounded once, "
                    f"and {narrow_bytes} bytes sent")
        print(f"np2 narrow ring: rank {r} {NARROW_ELEMENTS} elements, "
              f"{json.dumps(rank_out['narrow'])} (the fp32 sum rounded once; "
              f"{narrow_bytes} bytes sent, 2 per element) [{card_line}]",
              flush=True)
    # The same job with the cache off: the same parameters, bit for bit.
    off_seconds, off = run_np2_resnet(["--cache-capacity", "0"])
    for step in range(NP2_STEPS):
        for r in range(2):
            on_hash = ranks[r]["steps"][step]["hash"]
            off_hash = off[r]["steps"][step]["hash"]
            if on_hash != off_hash:
                raise AssertionError(
                    f"step {step} rank {r}: parameters with the cache on "
                    f"({on_hash}) and off ({off_hash}) differ")
        for r in range(2):
            s = off[r]["steps"][step]
            assert s["launches"] == LAUNCHES_PER_STEP, (r, step, s)
            assert s["allreduce_tensors"] == NP2_PARAMS, (r, step, s)
            assert s["cache_hit_count"] == 0, (r, step, s)
    keys = ("loss", "ms", "plane_ms", "launches", "allreduce_tensors",
            "allreduce_responses", "negotiation_ms", "assignments",
            "evictions") + NEGOTIATION_COUNTERS
    summary = {
        "seconds": seconds, "off_seconds": off_seconds,
        "worst_grad_rel_rms": worst, "narrow_control_rel_rms": narrowest,
        "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
        "per_rank": [{k: [s[k] for s in r["steps"]] for k in keys}
                     for r in ranks],
        "off_per_rank": [{k: [s[k] for s in r["steps"]] for k in keys}
                         for r in off]}
    for r, per in enumerate(summary["per_rank"]):
        print(f"np2 main path: rank {r} ResNet-50 batch {NP2_BATCH} "
              f"{IMAGE}x{IMAGE} bf16, host plane, ms/step "
              f"{[round(v, 1) for v in per['ms']]} (in the plane's op "
              f"{[round(v, 1) for v in per['plane_ms']]}), losses "
              f"{[round(v, 4) for v in per['loss']]}, kernel launches "
              f"{per['launches']}, allreduced tensors "
              f"{per['allreduce_tensors']} in "
              f"{per['allreduce_responses']} responses per step, peak "
              f"{summary['peak_mem_gb'][r]:.1f} GB [{card_line}]",
              flush=True)
    for label, runs in (("cache on", summary["per_rank"]),
                        ("cache off", summary["off_per_rank"])):
        for r, per in enumerate(runs):
            print(f"np2 negotiation ({label}): rank {r} ms in "
                  f"compute_response_list per step "
                  f"{[round(v, 1) for v in per['negotiation_ms']]}, "
                  f"serialized requests {per['serialized_request_count']}, "
                  f"cache hits {per['cache_hit_count']}, misses "
                  f"{per['cache_miss_count']}, mask-only frames sent "
                  f"{per['mask_only_sent_count']}, fast cycles "
                  f"{per['fast_cycle_count']} (idle "
                  f"{per['idle_fast_cycle_count']}), assignments "
                  f"{per['assignments']}, evictions {per['evictions']}, "
                  f"ms/step {[round(v, 1) for v in per['ms']]} "
                  f"[{card_line}]", flush=True)
    return summary


def _sha(t: torch.Tensor) -> str:
    return _sha_all([t])


def _sha_all(tensors) -> str:
    """SHA-256 of the tensors' bytes, one tensor on the host at a time."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def np2_bert_worker(out_dir: str) -> None:
    """One rank of the np=2 BERT-large job, as the repo's example script
    (``examples/pytorch/pytorch_synthetic_benchmark.py``) starts one:
    weights from a per-rank seed, local AdamW steps, then rank 0's
    weights, optimizer state and resume point broadcast to every rank.
    Rank 0 trains 3 steps and rank 1 2, then each joins; the job ends with
    an allreduce, an allgather, an object allgather, an alltoall and a
    barrier.  What the gates need goes to ``out_dir``."""
    t_start = time.perf_counter()
    hvd.init(device="cuda:0")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd.device()
    assert size == 2 and dev == torch.device("cuda", 0), (size, dev)
    cfg = transformer.bert_large_config(max_len=BERT_SEQ, causal=False)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(1234 + rank)).to(dev)
    params = list(model.named_parameters())
    watched = [p for name, p in params if name in NP2_BERT_WATCHED]
    assert len(params) == BERT_PARAMS and len(watched) == 3
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    # Local steps on the rank's own batch: the state of a checkpoint that
    # each rank restored differently, ``step`` included.
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    own = torch.randint(0, cfg.vocab_size, (NP2_BERT_BATCH, BERT_SEQ),
                        device=dev, generator=gen)
    for _ in range(NP2_BERT_LOCAL_STEPS[rank]):
        cross_entropy_loss(model(own), own).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    if rank == 0:
        for group in opt.param_groups:
            group["lr"] = 2e-4
    out = {"before": {"params": {name: _sha(p) for name, p in params}}}
    resume = hvd.broadcast_object(1000 + 7 * rank, 0)
    opt = hvd.DistributedOptimizer(opt, named_parameters=params)

    def opt_state():
        st = opt.state_dict()
        return ({f"{pid}.{k}": _sha(v) for pid, s in st["state"].items()
                 for k, v in s.items()}, st["param_groups"])

    out["before"]["opt"], out["before"]["groups"] = opt_state()
    nbytes = sum(t.numel() * t.element_size()
                 for t in model.state_dict().values())
    nbytes += sum(v.numel() * v.element_size()
                  for s in opt.state_dict()["state"].values()
                  for v in s.values() if isinstance(v, torch.Tensor))
    counts = dict(cuda_backend.stats)
    probe = negotiation_probe()
    torch.cuda.synchronize()
    negotiation = negotiation_snapshot(probe)
    t0 = time.perf_counter()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    torch.cuda.synchronize()
    out["broadcast_s"] = time.perf_counter() - t0
    out["broadcast_negotiation"] = negotiation_delta(negotiation, probe)
    out["broadcast_bytes"] = nbytes
    out["broadcast_responses"] = {k: cuda_backend.stats[k] - counts[k]
                                  for k in counts if cuda_backend.stats[k]
                                  != counts[k]}
    out["resume"] = resume
    out["after"] = {"params": {name: _sha(p) for name, p in params}}
    out["after"]["opt"], out["after"]["groups"] = opt_state()

    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (size * NP2_BERT_BATCH,
                                               BERT_SEQ),
                           device=dev, generator=gen)
    shard = tokens[rank * NP2_BERT_BATCH:(rank + 1) * NP2_BERT_BATCH]
    batch = {"x": shard.contiguous(), "y": shard.contiguous()}
    del tokens
    op_seconds = time_host_allreduce()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for step in range(NP2_BERT_STEPS[rank]):
        model.train()
        local = [g.float().cpu() for g in torch.autograd.grad(
            cross_entropy_loss(model(batch["x"]), batch["y"]), watched)]
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        counts = dict(cuda_backend.stats)
        op_seconds[0] = 0.0
        negotiation = negotiation_snapshot(probe)
        phases = phase_stats.snapshot()
        first_cycle = global_state().cycle_count
        t0 = time.perf_counter()
        loss = train_step(model, opt, batch)
        torch.cuda.synchronize()
        steps.append({
            **negotiation_delta(negotiation, probe),
            "loss": float(loss), "ms": 1e3 * (time.perf_counter() - t0),
            "plane_ms": 1e3 * op_seconds[0],
            # The trace's cycles of this step, (first, last], and the
            # runtime's phase times in it.
            "cycles": (first_cycle, global_state().cycle_count),
            "phases_ms": phase_delta(phases),
            **{k: fa.LAUNCHES[k] - launches[k] for k in FLASH_KERNELS},
            **{k: cuda_backend.stats[k] - counts[k] for k in counts},
            "hash": _sha_all(p for _, p in params),
            "local": local,
            "applied": [p.grad.float().cpu() for p in watched]})
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["join"] = hvd.join()
    losses = torch.tensor([s["loss"] for s in steps], device=dev)
    out["mean_loss"] = float(hvd.allreduce(losses.mean(), op=hvd.Average))
    out["losses"] = hvd.allgather(losses).cpu()
    out["objects"] = hvd.allgather_object({"rank": rank,
                                           "steps": len(steps)})
    splits = NP2_BERT_SPLITS[rank]
    rows = torch.arange(sum(splits), device=dev, dtype=torch.int32)
    sent = (100 * rank + rows)[:, None] * 10 + torch.arange(
        4, device=dev, dtype=torch.int32)
    out["alltoall"] = hvd.alltoall(sent, splits=splits).cpu()
    hvd.barrier()
    hvd.shutdown()
    out["steps"] = steps
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print("NP2_BERT_DONE", rank, flush=True)


def phase_np2_bert(card_line: str) -> dict:
    # Inside the checkout (``_runs/`` is gitignored), deleted afterwards.
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="np2_bert.",
                                     dir=REPO / "_runs") as out_dir:
        trace = Path(out_dir) / "tl.json"
        t0 = time.perf_counter()
        code, out, err = launch_job(
            2, ["np2-bert", out_dir], LAUNCH_TIMEOUT,
            launcher_args=["--timeline-filename", str(trace)])
        seconds = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"np=2 BERT-large job failed with exit "
                                 f"{code}:\n{out}\n{err}")
        ranks = [torch.load(Path(out_dir) / f"rank{r}.pt") for r in range(2)]
        traces = load_rank_traces(trace, 2)
    r0, r1 = ranks
    # The start-up broadcasts: rank 0's weights, state and hyperparameters
    # everywhere; every tensor differed across the ranks before (the
    # control).
    for what in ("params", "opt"):
        before0, before1 = r0["before"][what], r1["before"][what]
        assert before0.keys() == before1.keys(), what
        same = [k for k in before0 if before0[k] == before1[k]]
        if same:
            raise AssertionError(f"{what}: {len(same)} tensors were equal "
                                 f"across the ranks before the broadcast "
                                 f"(the control), first {same[0]}")
    for r, rk in enumerate(ranks):
        if rk["after"]["params"] != r0["before"]["params"]:
            raise AssertionError(f"rank {r}: parameters after the broadcast "
                                 "are not rank 0's")
        if rk["after"]["opt"] != r0["before"]["opt"]:
            raise AssertionError(f"rank {r}: optimizer state after the "
                                 "broadcast is not rank 0's")
        assert rk["after"]["groups"] == r0["before"]["groups"], r
        assert rk["resume"] == 1000, (r, rk["resume"])
        assert rk["join"] == 0, (r, rk["join"])
    keys = {k.split(".", 1)[1] for k in r0["before"]["opt"]}
    assert keys == {"exp_avg", "exp_avg_sq", "step"}, keys
    n_opt = len(r0["before"]["opt"])
    assert n_opt == 3 * BERT_PARAMS, n_opt
    assert r0["before"]["groups"][0]["lr"] == 2e-4, r0["before"]["groups"]
    # Training: 24 launches of each flash kernel and 292 allreduced
    # gradients per step; the weights equal across ranks after the steps
    # both took.
    for r, rk in enumerate(ranks):
        assert len(rk["steps"]) == NP2_BERT_STEPS[r], r
        for step, s in enumerate(rk["steps"]):
            for kernel in FLASH_KERNELS:
                assert s[kernel] == BERT_LAYERS, (r, step, kernel, s[kernel])
            assert s["allreduce_tensors"] == BERT_PARAMS, (r, step, s)
            assert math.isfinite(s["loss"]), (r, step, s["loss"])
    for step in range(min(NP2_BERT_STEPS)):
        h0, h1 = r0["steps"][step]["hash"], r1["steps"][step]["hash"]
        if h0 != h1:
            raise AssertionError(f"step {step}: parameters differ across "
                                 f"ranks ({h0} vs {h1})")
    # Rank 0's third step, with rank 1 joined: Average over 2 of its own
    # gradient and rank 1's zeros is half its gradient; the unhalved one
    # (the control) must fail the limit.
    last = r0["steps"][-1]
    worst, control = 0.0, math.inf
    for name, applied, local in zip(NP2_BERT_WATCHED, last["applied"],
                                    last["local"]):
        err = rel_rms(applied, local.double() / 2)
        unhalved = rel_rms(local, local.double() / 2)
        worst, control = max(worst, err), min(control, unhalved)
        if err > NP2_GRAD_REL_RMS or unhalved <= NP2_GRAD_REL_RMS:
            raise AssertionError(
                f"joined step {name}: applied gradient vs half the local "
                f"one, relative RMS {err!r} (limit {NP2_GRAD_REL_RMS}); the "
                f"unhalved control's {unhalved!r} must exceed it")
    # The closing collectives.
    losses = [s["loss"] for s in r0["steps"]] + [s["loss"]
                                                 for s in r1["steps"]]
    for r, rk in enumerate(ranks):
        got = rk["losses"]
        assert got.shape == (5,) and torch.isfinite(got).all(), (r, got)
        assert got.tolist() == torch.tensor(losses).tolist(), (r, got)
        assert math.isfinite(rk["mean_loss"]), (r, rk["mean_loss"])
        assert rk["objects"] == [{"rank": 0, "steps": 3},
                                 {"rank": 1, "steps": 2}], rk["objects"]
        expected = torch.cat([
            ((100 * src + torch.arange(sum(NP2_BERT_SPLITS[src]),
                                       dtype=torch.int32))[:, None] * 10
             + torch.arange(4, dtype=torch.int32))[
                sum(NP2_BERT_SPLITS[src][:r]):
                sum(NP2_BERT_SPLITS[src][:r + 1])]
            for src in range(2)])
        if not torch.equal(rk["alltoall"], expected):
            raise AssertionError(f"rank {r} alltoall: {rk['alltoall']} vs "
                                 f"{expected}")
    assert torch.equal(r0["losses"], r1["losses"])
    # The cache: the broadcasts' names overfill it, the gradients' first
    # step evicts, and rank 1's second step sends bits only.
    evictions = sum(s["evictions"] for s in r0["steps"]) + \
        r0["broadcast_negotiation"]["evictions"]
    if r1["steps"][1]["serialized_request_count"] != 0:
        raise AssertionError(
            f"rank 1's second step sent "
            f"{r1['steps'][1]['serialized_request_count']} serialized "
            f"requests (expected 0)")
    for r, rk in enumerate(ranks):
        b = rk["broadcast_negotiation"]
        print(f"np2 BERT negotiation: rank {r} start-up broadcasts: "
              f"serialized requests {b['serialized_request_count']}, "
              f"assignments {b['assignments']}, evictions {b['evictions']}, "
              f"{b['negotiation_ms']:.1f} ms in compute_response_list; "
              f"per step: serialized requests "
              f"{[s['serialized_request_count'] for s in rk['steps']]}, "
              f"cache hits {[s['cache_hit_count'] for s in rk['steps']]}, "
              f"misses {[s['cache_miss_count'] for s in rk['steps']]}, "
              f"fast cycles {[s['fast_cycle_count'] for s in rk['steps']]}, "
              f"assignments {[s['assignments'] for s in rk['steps']]}, "
              f"evictions {[s['evictions'] for s in rk['steps']]}, ms in "
              f"compute_response_list "
              f"{[round(s['negotiation_ms'], 1) for s in rk['steps']]} "
              f"[{card_line}]", flush=True)
    for r, rk in enumerate(ranks):
        per = rk["steps"]
        print(f"np2 BERT: rank {r} BERT-large batch {NP2_BERT_BATCH} x "
              f"{BERT_SEQ} bf16, AdamW, host plane, ms/step "
              f"{[round(s['ms'], 1) for s in per]} (in the plane's op "
              f"{[round(s['plane_ms'], 1) for s in per]}), losses "
              f"{[round(s['loss'], 4) for s in per]}, allreduce responses "
              f"per step {[s['allreduce_responses'] for s in per]}, "
              f"start-up broadcast {rk['broadcast_s']:.2f}s for "
              f"{rk['broadcast_bytes'] / 1e9:.3f} GB "
              f"({rk['broadcast_responses']}), peak "
              f"{rk['peak_mem_gb']:.1f} GB, worker {rk['seconds']:.1f}s "
              f"[{card_line}]", flush=True)
    split = trace_split(traces, [rk["steps"] for rk in ranks])
    for r, rk in enumerate(ranks):
        per = rk["steps"]
        op_ms = [round(s["plane_ms"], 1) for s in per]
        stats = {p: [round(s["phases_ms"].get(p, 0.0), 1) for s in per]
                 for p in ("fuse", "collective", "unfuse", "wait",
                           "negotiate")}
        print(f"np2 BERT trace: rank {r} ms per step from critical_path "
              f"(union of the LC_* spans per phase): "
              + ", ".join(f"{p} {split[r][p]}" for p in TRACE_PHASES)
              + f"; the host plane's op {op_ms}; phase_stats ms per step: "
              + ", ".join(f"{p} {v}" for p, v in stats.items())
              + "; fusion is LC_FUSE + LC_UNFUSE (the fused buffer, its "
              "copies to and from the host, and the copy's wait for the "
              "gradients), reduce is gloo's sum (one LC_WIRE_REDUCE_SCATTER"
              "); with the response cache on, negotiation_wait counts only "
              "the steps whose tensors went through rank 0's table "
              f"(mask-path rounds emit no table spans) [{card_line}]",
              flush=True)
    return {"seconds": seconds, "worst_grad_rel_rms": worst, "split": split,
            "control_rel_rms": control, "evictions": evictions,
            "ms": [[s["ms"] for s in rk["steps"]] for rk in ranks],
            "plane_ms": [[s["plane_ms"] for s in rk["steps"]]
                         for rk in ranks]}


def adasum_probe(record) -> tuple:
    """Wraps the Adasum op in this worker: the wall seconds the background
    thread spends in it, summed into the returned list's one item; the
    output tensor of each entry named in ``record`` (the reduced delta the
    optimizer adds to the old weights), into the returned dict; and the
    window ``(entry sizes, lo, hi)`` the host plane's VHDD hands the
    kernels in each round, into the returned list."""
    op_seconds, outputs, windows = [0.0], {}, []
    execute = adasum_backend.Adasum.execute
    segment_bounds = adasum_backend._segment_bounds

    def recorded(sizes, lo, hi):
        windows.append((list(sizes), lo, hi))
        return segment_bounds(sizes, lo, hi)

    def timed(self, response, entries):
        t = time.perf_counter()
        try:
            return execute(self, response, entries)
        finally:
            op_seconds[0] += time.perf_counter() - t
            outputs.update((e.tensor_name, e.output) for e in entries
                           if e.tensor_name in record)

    adasum_backend.Adasum.execute = timed
    adasum_backend._segment_bounds = recorded
    return op_seconds, outputs, windows


def local_adamw_steps(inner: torch.optim.Optimizer, watched: list,
                      grads: list) -> list:
    """What ``inner`` (AdamW) alone would add to each of ``watched`` given
    ``grads``: the same step on clones with the same hyperparameters and
    a copy of the state, as fp32 CPU tensors."""
    clones = []
    for p, g in zip(watched, grads):
        c = p.detach().clone().requires_grad_(True)
        c.grad = g.detach().clone()
        clones.append(c)
    group = inner.param_groups[0]
    local = torch.optim.AdamW(clones, lr=group["lr"], betas=group["betas"],
                              eps=group["eps"],
                              weight_decay=group["weight_decay"])
    for c, p in zip(clones, watched):
        if inner.state[p]:
            local.state[c] = {k: v.clone() for k, v in inner.state[p].items()}
    local.step()
    return [(c.detach() - p.detach()).float().cpu()
            for c, p in zip(clones, watched)]


def np2_bert_adasum_worker(out_dir: str) -> None:
    """One rank of the np=2 BERT-large job with Adasum (BASELINE config 4):
    weights from a per-rank seed, rank 0's weights and optimizer state
    broadcast, then ``hvd.DistributedOptimizer(AdamW, op=hvd.Adasum)`` for
    ``NP2_ADASUM_STEPS`` steps on the rank's shard.  Before each step the
    watched tensors' local AdamW steps are taken on clones, from a second
    forward and backward on the same shard."""
    t_start = time.perf_counter()
    hvd.init(device="cuda:0")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd.device()
    assert size == 2 and dev == torch.device("cuda", 0), (size, dev)
    cfg = transformer.bert_large_config(max_len=BERT_SEQ, causal=False)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(1234 + rank)).to(dev)
    params = list(model.named_parameters())
    watched = [dict(params)[name] for name in NP2_BERT_WATCHED]
    assert len(params) == BERT_PARAMS
    inner = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(inner, root_rank=0)
    opt = hvd.DistributedOptimizer(inner, named_parameters=params,
                                   op=hvd.Adasum)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (size * NP2_BERT_BATCH,
                                               BERT_SEQ),
                           device=dev, generator=gen)
    shard = tokens[rank * NP2_BERT_BATCH:(rank + 1) * NP2_BERT_BATCH]
    batch = {"x": shard.contiguous(), "y": shard.contiguous()}
    del tokens
    names = [f"adasum.delta.{name}" for name in NP2_BERT_WATCHED]
    op_seconds, outputs, windows = adasum_probe(set(names))
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for _ in range(NP2_ADASUM_STEPS):
        model.train()
        grads = torch.autograd.grad(
            cross_entropy_loss(model(batch["x"]), batch["y"]), watched)
        local = local_adamw_steps(inner, watched, grads)
        del grads
        old = [p.detach().clone() for p in watched]
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        kernel = dict(adasum_kernels.LAUNCHES)
        counts = dict(cuda_backend.stats)
        op_seconds[0] = 0.0
        outputs.clear()
        windows.clear()
        t0 = time.perf_counter()
        loss = train_step(model, opt, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        steps.append({
            "loss": float(loss), "ms": ms, "adasum_ms": 1e3 * op_seconds[0],
            **{k: fa.LAUNCHES[k] - launches[k] for k in FLASH_KERNELS},
            **{k: adasum_kernels.LAUNCHES[k] - kernel[k] for k in kernel},
            **{k: cuda_backend.stats[k] - counts[k] for k in counts},
            "hash": _sha_all(p for _, p in params),
            "windows": list(windows),
            "local": local,
            "applied": [outputs[n].float().cpu() for n in names],
            # The optimizer wrote old + the reduced delta, nothing else.
            "written": all(torch.equal(p.detach(), o + outputs[n])
                           for p, o, n in zip(watched, old, names))})
        del old
    out = {"steps": steps,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    hvd.shutdown()
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print("NP2_BERT_ADASUM_DONE", rank, flush=True)


def phase_np2_bert_adasum(card_line: str, average: dict) -> dict:
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="np2_bert_adasum.",
                                     dir=REPO / "_runs") as out_dir:
        t0 = time.perf_counter()
        code, out, err = launch_job(2, ["np2-bert-adasum", out_dir],
                                    LAUNCH_TIMEOUT)
        seconds = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"np=2 BERT-large Adasum job failed with "
                                 f"exit {code}:\n{out}\n{err}")
        ranks = [torch.load(Path(out_dir) / f"rank{r}.pt") for r in range(2)]
    launches = 0
    for r, rk in enumerate(ranks):
        assert len(rk["steps"]) == NP2_ADASUM_STEPS, r
        for step, s in enumerate(rk["steps"]):
            for kernel in FLASH_KERNELS:
                assert s[kernel] == BERT_LAYERS, (r, step, kernel, s[kernel])
            assert s["adasum_tensors"] == BERT_PARAMS, (r, step, s)
            assert s["allreduce_tensors"] == 0, (r, step, s)
            step_launches = sum(s[k] for k in adasum_kernels.LAUNCHES)
            assert step_launches > 0, (r, step, s)
            # One window per triplets and per combine launch.
            assert all(s[k] == len(s["windows"])
                       for k in adasum_kernels.LAUNCHES), (r, step, s)
            launches += step_launches
            assert s["written"], (r, step)
            assert math.isfinite(s["loss"]), (r, step, s["loss"])
    for step in range(NP2_ADASUM_STEPS):
        h0, h1 = (rk["steps"][step]["hash"] for rk in ranks)
        if h0 != h1:
            raise AssertionError(f"Adasum step {step}: parameters differ "
                                 f"across ranks ({h0} vs {h1})")
    # Step 1: the applied update against the fp64 closed form of the two
    # local steps, rank 0's the lower subgroup's ``a``, per tensor; the
    # plain mean of the two (the control) must miss the closed forms of
    # the three together by more than the limit.  (A tensor whose two
    # first AdamW steps, ~lr·sign(g), agree in every sign has Adasum equal
    # to the mean: its own miss is printed, not gated.)
    first = [rk["steps"][0] for rk in ranks]
    worst, misses, closed_all, mean_all = 0.0, {}, [], []
    for i, name in enumerate(NP2_BERT_WATCHED):
        assert torch.equal(first[0]["applied"][i], first[1]["applied"][i])
        closed = adasum64(first[0]["local"][i], first[1]["local"][i])
        applied = first[0]["applied"][i].double().reshape(-1)
        mean = (first[0]["local"][i].double().reshape(-1)
                + first[1]["local"][i].double().reshape(-1)) / 2
        err = ((applied - closed).norm() / closed.norm()).item()
        misses[name] = ((mean - closed).norm() / closed.norm()).item()
        closed_all.append(closed)
        mean_all.append(mean)
        worst = max(worst, err)
        if err > NP2_ADASUM_REL_RMS:
            raise AssertionError(
                f"Adasum step 1 {name}: applied update vs the closed form "
                f"of the local steps, relative RMS {err!r} (limit "
                f"{NP2_ADASUM_REL_RMS})")
    closed_all, mean_all = torch.cat(closed_all), torch.cat(mean_all)
    control = ((mean_all - closed_all).norm() / closed_all.norm()).item()
    if control <= NP2_ADASUM_REL_RMS:
        raise AssertionError(f"Adasum step 1: the plain mean misses the "
                             f"closed form by {control!r}, not more than "
                             f"the limit {NP2_ADASUM_REL_RMS}: {misses}")
    for r, rk in enumerate(ranks):
        per = rk["steps"]
        print(f"np2 BERT Adasum: rank {r} BERT-large batch "
              f"{NP2_BERT_BATCH} x {BERT_SEQ} bf16, AdamW, op=Adasum, host "
              f"plane, ms/step {[round(s['ms'], 1) for s in per]} (in the "
              f"Adasum op {[round(s['adasum_ms'], 1) for s in per]}); "
              f"Average in the same call: ms/step "
              f"{[round(v, 1) for v in average['ms'][r]]} (in the plane's "
              f"op {[round(v, 1) for v in average['plane_ms'][r]]}); losses "
              f"{[round(s['loss'], 4) for s in per]}, Adasum responses per "
              f"step {[s['adasum_responses'] for s in per]}, kernel "
              f"launches per step "
              f"{[{k: s[k] for k in adasum_kernels.LAUNCHES} for s in per]}"
              f", peak {rk['peak_mem_gb']:.1f} GB, worker "
              f"{rk['seconds']:.1f}s [{card_line}]", flush=True)
    return {"seconds": seconds, "worst_rel_rms": worst,
            "control_rel_rms": control, "control_per_tensor": misses,
            "launches": launches,
            "windows": [[s["windows"] for s in rk["steps"]] for rk in ranks]}


def phase_adasum_windows(windows: list, card_line: str) -> dict:
    """The Adasum kernels at the main path's own shapes: every window
    ``(entry sizes, lo, hi)`` that phase 13's ranks handed them, held
    against the plain versions on fresh inputs (``check_adasum_layout``)
    and timed.  ``windows[r][step]`` is rank r's list for that step; a
    window that recurs is checked and timed once.  Returns the rows, and
    the kernels', plain and bound ms per step and rank (the sum over its
    windows), averaged over ranks and steps."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, totals = {}, []
    keys = ("ms", "plain_ms", "bound_ms", "elements")
    for r, per_step in enumerate(windows):
        for step, step_windows in enumerate(per_step):
            total = dict.fromkeys(keys, 0)
            for sizes, lo, hi in step_windows:
                key = (tuple(sizes), lo, hi)
                if key not in rows:
                    rows[key] = check_adasum_layout(
                        f"np2 window [{lo}, {hi}) of {len(sizes)} entries",
                        sizes, lo, hi, False, True, gen=gen)
                    torch.cuda.empty_cache()
                for k in keys:
                    total[k] += rows[key][k]
            totals.append(total)
            print(f"adasum windows: rank {r} step {step + 1}: "
                  f"{len(step_windows)} windows, {total['elements']} "
                  f"elements, kernels {total['ms']!r} ms (bound "
                  f"{total['bound_ms']!r}), plain {total['plain_ms']!r} "
                  f"ms; elements per window "
                  f"{[hi - lo for _, lo, hi in step_windows]} "
                  f"[{card_line}]", flush=True)
    for row in rows.values():
        print("adasum window", json.dumps(row), flush=True)
    mean = {k: sum(t[k] for t in totals) / len(totals) for k in keys}
    by = {row["bound_by"] for row in rows.values()}
    return {"rows": list(rows.values()), "totals": totals, **mean,
            "bound_by": "bytes" if by == {"bytes"} else "operations"}


def np2_stall_worker(out_dir: str) -> None:
    """One rank of the stall job: five steps of two named allreduces on
    the card, then rank 0 submits ``stuck``, which rank 1 never submits."""
    hvd.init(device="cuda:0")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd.device()
    assert size == 2 and dev == torch.device("cuda", 0), (size, dev)
    ctl = global_state().controller
    sums = []
    for step in range(5):
        a = torch.full((1024,), float(rank + step), device=dev)
        b = torch.full((7, 3), float(2 * rank + step), device=dev)
        ha = hvd.allreduce_async(a, op=hvd.Sum, name="warm.a")
        hb = hvd.allreduce_async(b, op=hvd.Sum, name="warm.b")
        sums.append([float(hvd.synchronize(ha)[0]),
                     float(hvd.synchronize(hb)[0, 0])])
    out = {"sums": sums, "hits": ctl.cache_hit_count}
    t0 = time.perf_counter()
    if rank == 0:
        handle = hvd.allreduce_async(torch.ones(3, device=dev), name="stuck")
        try:
            hvd.synchronize(handle)
            out["error"] = ""
        except HorovodInternalError as e:
            out["error"] = str(e)
    else:
        out["loop_ended"] = global_state().shutdown_complete.wait(
            STALL_TIMEOUT)
        out["error"] = ""
    out["abort_s"] = time.perf_counter() - t0
    try:
        hvd.allreduce(torch.ones(1, device=dev), name="after")
        out["next_error"] = ""
    except HorovodInternalError as e:
        out["next_error"] = str(e)
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print("NP2_STALL_DONE", rank, flush=True)


def phase_np2_stall(card_line: str) -> dict:
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="np2_stall.",
                                     dir=REPO / "_runs") as out_dir:
        t0 = time.perf_counter()
        code, out, err = launch_job(
            2, ["np2-stall", out_dir], STALL_TIMEOUT,
            {"HOROVOD_FLIGHT_RECORDER_DIR": out_dir},
            ["--stall-check-warning-time-seconds", "1",
             "--stall-check-shutdown-time-seconds", str(STALL_SHUTDOWN_S)])
        seconds = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"np=2 stall job failed with exit {code}:"
                                 f"\n{out}\n{err}")
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(2)]
        dumps = [json.loads((Path(out_dir) / "hvd_flight_recorder" /
                             f"hvd_flight_recorder.rank{r}.json").read_text())
                 for r in range(2)]
    r0, r1 = ranks
    want_sums = [[float(1 + 2 * s), float(2 + 2 * s)] for s in range(5)]
    for r, rk in enumerate(ranks):
        assert rk["sums"] == want_sums, (r, rk["sums"])
    assert r1["hits"] >= 8, r1["hits"]
    text = r0["error"]
    if not (text.startswith("stall shutdown: tensor stuck incomplete for ")
            and text.endswith("missing ranks [1]")):
        raise AssertionError(f"rank 0's stuck handle: {text!r}\n{err}")
    if r0["abort_s"] > STALL_ABORT_S:
        raise AssertionError(f"the abort took {r0['abort_s']:.1f}s "
                             f"(limit {STALL_ABORT_S}s)")
    assert r1["loop_ended"] is True, r1
    for r, rk in enumerate(ranks):
        if rk["next_error"] != text:
            raise AssertionError(f"rank {r}'s next enqueue raised "
                                 f"{rk['next_error']!r}, not {text!r}")
        assert text in dumps[r]["reason"], (r, dumps[r]["reason"])
    print(f"np2 stall: rank 0's stuck handle raised after "
          f"{r0['abort_s']:.2f}s (shutdown time {STALL_SHUTDOWN_S}s), rank "
          f"1's loop ended after {r1['abort_s']:.2f}s, both ranks' next "
          f"enqueue raised the same text: {text!r}; job {seconds:.1f}s "
          f"(launch included) [{card_line}]", flush=True)
    return {"seconds": seconds, "abort_s": r0["abort_s"], "text": text}


# ---------------------------------------------------------------------------
# the whole step as one CUDA graph, distributed_value_and_grad, overlap
# ---------------------------------------------------------------------------


def graph_setup(kind: str, dev: torch.device):
    """(model, optimizer) from seed 0: ResNet-50 with SGD-momentum, or
    BERT-large with AdamW(capturable=True), as both paths take them."""
    if kind == "resnet":
        model = resnet.ResNet50(
            num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
            generator=torch.Generator().manual_seed(0)).to(dev)
        return model, torch.optim.SGD(model.parameters(), lr=0.01,
                                      momentum=0.9)
    cfg = transformer.bert_large_config(max_len=BERT_SEQ, causal=False)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    return model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                    weight_decay=1e-4, capturable=True)


def graph_batches(kind: str, dev: torch.device) -> list:
    gen = torch.Generator(device=dev).manual_seed(11)
    batches = []
    for _ in range(GRAPH_STEPS):
        if kind == "resnet":
            batches.append({
                "x": torch.randn(BATCH, IMAGE, IMAGE, 3, device=dev,
                                 generator=gen),
                "y": torch.randint(0, 1000, (BATCH,), device=dev,
                                   generator=gen)})
        else:
            tokens = torch.randint(0, 30522, (BERT_BATCH, BERT_SEQ),
                                   device=dev, generator=gen)
            batches.append({"x": tokens, "y": tokens})
    return batches


def graph_loss(model, batch) -> torch.Tensor:
    return cross_entropy_loss(model(batch["x"]), batch["y"])


def timed_steps(fn, n: int) -> float:
    """ms per call of ``fn`` over ``n`` calls, the card idle at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def phase_graph(kind: str, card_line: str) -> dict:
    """Phases 15 and 16: the eager hook path, then
    ``make_overlapped_train_step``, from the same seed on the same batches
    in this one process; the parameters after ``GRAPH_STEPS`` steps, the
    kernels captured, no runtime response in a replay, and both step
    times."""
    # cuDNN's deterministic algorithms on both paths: the same bits.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    hvd.init()
    dev = hvd.device()
    batches = graph_batches(kind, dev)
    model, inner = graph_setup(kind, dev)
    params = list(model.named_parameters())
    opt = hvd.DistributedOptimizer(inner, named_parameters=params)
    eager_losses = [float(train_step(model, opt, b)) for b in batches]
    eager = [p.detach().clone() for _, p in params]
    eager_ms = timed_steps(lambda: train_step(model, opt, batches[0]),
                           GRAPH_TIMED_STEPS)
    del model, inner, opt, params
    gc.collect()
    torch.cuda.empty_cache()

    model, inner = graph_setup(kind, dev)
    model.train()
    params = list(model.named_parameters())
    step = hvd.make_overlapped_train_step(model, graph_loss, inner)
    responses = cuda_backend.stats["allreduce_responses"]
    graph_losses = [float(step(b)) for b in batches]
    same = [torch.equal(p.detach(), e) for (_, p), e in zip(params, eager)]
    differing = [name for (name, _), eq in zip(params, same) if not eq]
    worst = max((rel_rms(p.detach(), e) for (_, p), e, eq
                 in zip(params, eager, same) if not eq), default=0.0)
    graph_ms = timed_steps(lambda: step(batches[0]), GRAPH_TIMED_STEPS)
    replayed_responses = cuda_backend.stats["allreduce_responses"] - responses
    captured, launches, replays = dict(step.captured_launches), \
        step.launches(), step.replays
    del step, model, inner, params, eager
    gc.collect()
    torch.cuda.empty_cache()
    hvd.shutdown()
    torch.backends.cudnn.deterministic = deterministic

    assert all(math.isfinite(v) for v in eager_losses + graph_losses), \
        (eager_losses, graph_losses)
    if worst > GRAPH_REL_RMS:
        raise AssertionError(
            f"{kind}: the graph's parameters after {GRAPH_STEPS} steps vs "
            f"the eager path's: {len(differing)} tensors differ, worst "
            f"relative RMS {worst!r} (limit {GRAPH_REL_RMS}): {differing}")
    want = {"matmul_bn_stats": LAUNCHES_PER_STEP if kind == "resnet" else 0,
            **{k: BERT_LAYERS if kind == "bert" else 0
               for k in FLASH_KERNELS}}
    if captured != want:
        raise AssertionError(f"{kind}: kernels captured per step {captured},"
                             f" expected {want}")
    if replayed_responses != 0:
        raise AssertionError(f"{kind}: {replayed_responses} runtime "
                             "responses during the graph path")
    result = {"kind": kind, "eager_ms": eager_ms, "graph_ms": graph_ms,
              "eager_over_graph": eager_ms / graph_ms,
              "eager_losses": eager_losses, "graph_losses": graph_losses,
              "differing_tensors": differing, "worst_rel_rms": worst,
              "captured_per_step": captured, "replays": replays,
              "launches_in_replays": launches,
              "responses_in_replays": replayed_responses}
    print(f"graph step: {json.dumps(result)} [{card_line}]", flush=True)
    return result


def phase_value_and_grad(card_line: str) -> dict:
    """Phase 17: ``hvd.distributed_value_and_grad`` against the hook path's
    gradients, 2 layers at BERT-large width on the card."""
    hvd.init()
    dev = hvd.device()
    cfg = transformer.bert_large_config(num_layers=2, max_len=256)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(5)).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(6))
    params = dict(model.named_parameters())
    before = dict(fa.LAUNCHES)
    value, grads = hvd.distributed_value_and_grad(
        lambda p, t: cross_entropy_loss(model(t), t))(params, tokens)
    launches = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.0),
                                   named_parameters=list(params.items()))
    opt.zero_grad(set_to_none=True)
    cross_entropy_loss(model(tokens), tokens).backward()
    opt.synchronize()
    errors = {name: rel_rms(grads[name], p.grad) if p.grad.norm() > 0
              else float(not torch.equal(grads[name], p.grad))
              for name, p in params.items()}
    hvd.shutdown()
    worst = max(errors, key=errors.get)
    result = {"value": value.item(), "tensors": len(errors),
              "worst": worst, "worst_rel_rms": errors[worst],
              "flash_launches": launches}
    print(f"distributed_value_and_grad: {json.dumps(result)} [{card_line}]",
          flush=True)
    if errors[worst] > VALUE_AND_GRAD_REL_RMS or \
            not all(n == cfg.num_layers for n in launches.values()):
        raise AssertionError(f"distributed_value_and_grad vs the hook path: "
                             f"{result} (limit {VALUE_AND_GRAD_REL_RMS})")
    return result


def np2_overlap_worker(out_dir: str) -> None:
    """One rank of the np=2 overlap job: BERT-large from a per-rank seed,
    rank 0's weights broadcast, then ``OVERLAP_STEPS`` steps of
    ``OVERLAP_PASSES`` microbatches through
    ``DistributedOptimizer(overlap=True)``, and the same from the same
    weights with ``overlap=False``; first ``make_overlapped_train_step``
    on the host plane, which must refuse."""
    hvd.init(device="cuda:0")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd.device()
    cfg = transformer.bert_large_config(max_len=BERT_SEQ, causal=False)
    gen = torch.Generator(device=dev).manual_seed(4321 + rank)
    micro = [torch.randint(0, cfg.vocab_size, (OVERLAP_BATCH, BERT_SEQ),
                           device=dev, generator=gen)
             for _ in range(OVERLAP_STEPS * OVERLAP_PASSES)]
    out = {"modes": {}}
    # Before the job's first collective: a rank that finished early would
    # stop the other's runtime with its shutdown.
    tiny = torch.nn.Linear(4, 2).to(dev)
    try:
        hvd.make_overlapped_train_step(
            tiny, lambda m, b: m(b).square().mean(),
            torch.optim.SGD(tiny.parameters(), lr=0.1))(
                torch.ones(2, 4, device=dev))
        out["refusal"] = ""
    except RuntimeError as e:
        out["refusal"] = str(e)
    weights = {}
    op_seconds = time_host_allreduce()
    for overlap in (True, False):
        model = transformer.Transformer(
            cfg, generator=torch.Generator().manual_seed(1234 + rank)).to(dev)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        params = list(model.named_parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4),
            named_parameters=params, backward_passes_per_step=OVERLAP_PASSES,
            overlap=overlap)
        steps = []
        for w in range(OVERLAP_STEPS):
            counts = dict(cuda_backend.stats)
            op_seconds[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            losses = []
            for mb in micro[w * OVERLAP_PASSES:(w + 1) * OVERLAP_PASSES]:
                loss = cross_entropy_loss(model(mb), mb)
                loss.backward()
                losses.append(loss.detach())
            opt.step()
            torch.cuda.synchronize()
            steps.append({
                "ms": 1e3 * (time.perf_counter() - t0),
                "plane_ms": 1e3 * op_seconds[0],
                "losses": [float(v) for v in losses],
                **{k: cuda_backend.stats[k] - counts[k]
                   for k in ("allreduce_tensors", "allreduce_responses")}})
        weights[overlap] = torch.cat([p.detach().reshape(-1)
                                      for _, p in params])
        out["modes"][str(overlap)] = {"steps": steps,
                                      "hash": _sha(weights[overlap])}
        del model, opt, params
        gc.collect()
        torch.cuda.empty_cache()
    out["rel_rms"] = rel_rms(weights[True], weights[False])
    del weights
    hvd.shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print("NP2_OVERLAP_DONE", rank, flush=True)


def phase_np2_overlap(card_line: str) -> dict:
    """Phase 18: the np=2 overlap job's gates."""
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="np2_overlap.",
                                     dir=REPO / "_runs") as out_dir:
        t0 = time.perf_counter()
        code, out, err = launch_job(2, ["np2-overlap", out_dir],
                                    LAUNCH_TIMEOUT)
        seconds = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"np=2 overlap job failed with exit "
                                 f"{code}:\n{out}\n{err}")
        ranks = [torch.load(Path(out_dir) / f"rank{r}.pt") for r in range(2)]
    for mode in ("True", "False"):
        hashes = {r["modes"][mode]["hash"] for r in ranks}
        if len(hashes) != 1:
            raise AssertionError(f"overlap={mode}: weights differ across "
                                 f"ranks {hashes}")
    for r, rank_out in enumerate(ranks):
        for mode, want_tensors in (("True", OVERLAP_PASSES),
                                   ("False", BERT_PARAMS)):
            for s in rank_out["modes"][mode]["steps"]:
                assert all(math.isfinite(v) for v in s["losses"]), s
                if s["allreduce_tensors"] != want_tensors or (
                        mode == "True"
                        and s["allreduce_responses"] != OVERLAP_PASSES):
                    raise AssertionError(
                        f"rank {r} overlap={mode}: {s}; expected "
                        f"{want_tensors} tensors per step (overlap: one "
                        f"fused response per microbatch)")
        if rank_out["rel_rms"] > OVERLAP_REL_RMS:
            raise AssertionError(
                f"rank {r}: overlap=True vs overlap=False weights, relative "
                f"RMS {rank_out['rel_rms']!r} (limit {OVERLAP_REL_RMS})")
        want = ("HOROVOD_DATA_PLANE=nccl", "DistributedOptimizer(overlap=True)")
        if not all(w in rank_out["refusal"] for w in want):
            raise AssertionError(f"rank {r}: make_overlapped_train_step on "
                                 f"the host plane: {rank_out['refusal']!r}")
        for mode in ("True", "False"):
            steps = rank_out["modes"][mode]["steps"]
            print(f"np2 overlap={mode}: rank {r} BERT-large {OVERLAP_PASSES}"
                  f" x {OVERLAP_BATCH} x {BERT_SEQ} per step, ms/step "
                  f"{[round(s['ms'], 1) for s in steps]} (in the plane's op "
                  f"{[round(s['plane_ms'], 1) for s in steps]}), tensors "
                  f"{[s['allreduce_tensors'] for s in steps]} in responses "
                  f"{[s['allreduce_responses'] for s in steps]} per step "
                  f"[{card_line}]", flush=True)
    return {"seconds": seconds, "rel_rms": [r["rel_rms"] for r in ranks],
            "refusal": ranks[0]["refusal"]}


# ---------------------------------------------------------------------------
# the timeline: phases 19 and 20, and the trace of phase 12
# ---------------------------------------------------------------------------


def phase_delta(before: dict) -> dict:
    """ms per phase of ``phase_stats`` since the snapshot ``before``."""
    after = phase_stats.snapshot()
    return {k: v["total_ms"] - before.get(k, {}).get("total_ms", 0.0)
            for k, v in after.items()}


def load_rank_traces(path: Path, size: int) -> list:
    """Each rank's trace (rank 0 at ``path``, rank r at ``path.rank<r>``),
    which must load as JSON: the writer closed every file."""
    traces = []
    for r in range(size):
        rank_path = Path(f"{path}.rank{r}" if r else path)
        traces.append(json.loads(rank_path.read_text()))
    return traces


def trace_lanes(events: list) -> dict:
    """Per lane (tensor name), its B/E/i records as ``(name, ph, args)`` in
    write order, each E named after the span it closes.  Raises on an E
    with no open span and on a span left open."""
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("name") == "thread_name"}
    stacks = {tid: [] for tid in names}
    lanes = {name: [] for name in names.values()}
    for e in events:
        tid = e.get("tid")
        if tid not in names or e["ph"] == "M":
            continue
        lane, stack = lanes[names[tid]], stacks[tid]
        if e["ph"] == "B":
            stack.append(e["name"])
            lane.append((e["name"], "B", e.get("args") or {}))
        elif e["ph"] == "E":
            if not stack:
                raise AssertionError(f"lane {names[tid]}: an E record with "
                                     "no open span")
            lane.append((stack.pop(), "E", {}))
        else:
            lane.append((e["name"], e["ph"], e.get("args") or {}))
    left = {names[tid]: stack for tid, stack in stacks.items() if stack}
    if left:
        raise AssertionError(f"{len(left)} lanes with spans left open, e.g. "
                             f"{next(iter(left.items()))}")
    return lanes


def op_cycles(lanes: dict) -> dict:
    """Per lane, the cycle of each of its op spans; each must carry one."""
    out = {}
    for lane, records in lanes.items():
        out[lane] = []
        for name, ph, args in records:
            if ph == "B" and name in OP_SPANS:
                if not isinstance(args.get("cycle"), int):
                    raise AssertionError(f"lane {lane}: op span {name} "
                                         f"without a cycle: {args}")
                out[lane].append(args["cycle"])
    return out


def check_trace(events: list, n_lanes: int) -> dict:
    """Phase 19's gates on one rank's trace: ``n_lanes`` lanes, every
    ``LC_SUBMITTED`` and ``LC_CALLBACK`` closed, every op span tagged with
    a cycle, and critical_path giving one step per tagged cycle, every op's
    among them.  Returns the counts and critical_path's report."""
    lanes = trace_lanes(events)
    if len(lanes) != n_lanes:
        raise AssertionError(f"{len(lanes)} lanes in the trace, expected "
                             f"{n_lanes} (one per gradient)")
    for lane, records in lanes.items():
        for stage in ("LC_SUBMITTED", "LC_CALLBACK"):
            opened = sum(1 for n, ph, _ in records if n == stage and ph == "B")
            closed = sum(1 for n, ph, _ in records if n == stage and ph == "E")
            if opened == 0 or opened != closed:
                raise AssertionError(f"lane {lane}: {opened} {stage} begins, "
                                     f"{closed} ends")
    ops = op_cycles(lanes)
    tagged = {e["args"]["cycle"] for e in events
              if e.get("ph") == "B" and "cycle" in (e.get("args") or {})}
    doc = critical_path.analyze(events)
    steps = [s["cycle"] for s in doc["steps"]]
    op_set = {c for cycles in ops.values() for c in cycles}
    if steps != sorted(tagged) or not op_set <= set(steps):
        raise AssertionError(f"critical_path: steps {steps[:20]}... for "
                             f"{len(tagged)} tagged cycles, op cycles "
                             f"{sorted(op_set)[:20]}...")
    return {"lanes": len(lanes), "events": len(events),
            "op_spans": sum(len(c) for c in ops.values()),
            "op_cycles": len(op_set), "steps": len(steps),
            "coverage": doc["coverage"], "report": doc}


def trace_split(traces: list, steps_by_rank: list) -> list:
    """critical_path over the merged trace, per rank: ms of each of
    ``TRACE_PHASES`` in each of the rank's steps, a step being the cycles
    ``(first, last]`` its worker recorded."""
    doc = critical_path.analyze(trace_merge.merge(
        [list(t) for t in traces], warn=lambda msg: print(msg, flush=True)))
    out = []
    for rank, steps in enumerate(steps_by_rank):
        per = {p: [] for p in TRACE_PHASES}
        for step in steps:
            first, last = step["cycles"]
            for p in TRACE_PHASES:
                per[p].append(round(sum(
                    s["phases_us"].get(str(rank), {}).get(p, 0.0)
                    for s in doc["steps"] if first < s["cycle"] <= last)
                    / 1e3, 1))
        out.append(per)
    return out


def phase_timeline_np1(card_line: str) -> list:
    """Phase 19: ResNet-50 b128 and BERT-large b8 x 512 through the eager
    hook path, ``TIMELINE_STEPS`` steps with the timeline off, then
    ``hvd.start_timeline`` and as many on, then ``hvd.stop_timeline``, in
    one process; the trace's gates (``check_trace``), and both times."""
    hvd.init()
    dev = hvd.device()
    results = []
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="timeline.",
                                     dir=REPO / "_runs") as out_dir:
        for kind, n_params in (("resnet", NP2_PARAMS), ("bert", BERT_PARAMS)):
            model, inner = graph_setup(kind, dev)
            opt = hvd.DistributedOptimizer(
                inner, named_parameters=list(model.named_parameters()))
            batch = graph_batches(kind, dev)[0]

            def step():
                train_step(model, opt, batch)

            for _ in range(WARMUP_STEPS):
                step()
            off_ms = timed_steps(step, TIMELINE_STEPS)
            path = Path(out_dir) / f"{kind}.json"
            responses = cuda_backend.stats["allreduce_responses"]
            hvd.start_timeline(str(path))
            on_ms = timed_steps(step, TIMELINE_STEPS)
            # The finalizer closes the last LC_CALLBACK spans after the
            # handles it releases: let it finish before the file closes.
            time.sleep(0.2)
            hvd.stop_timeline()
            responses = cuda_backend.stats["allreduce_responses"] - responses
            check = check_trace(json.loads(path.read_text()), n_params)
            if check["op_spans"] != n_params * TIMELINE_STEPS:
                raise AssertionError(f"{kind}: {check['op_spans']} op spans, "
                                     f"expected {n_params} x "
                                     f"{TIMELINE_STEPS}")
            report = check.pop("report")
            result = {"kind": kind, "off_ms": off_ms, "on_ms": on_ms,
                      "on_over_off": on_ms / off_ms,
                      "trace_bytes": path.stat().st_size,
                      "responses": responses, **check}
            print(f"timeline np=1: {json.dumps(result)} [{card_line}]",
                  flush=True)
            print(critical_path.render_text(report, top=3), flush=True)
            results.append(result)
            del model, inner, opt, batch
            gc.collect()
            torch.cuda.empty_cache()
    hvd.shutdown()
    return results


def example_worker(script: str, args: list) -> None:
    """One rank of phase 20: the example script as its own ``__main__``,
    then this rank's ``phase_stats``."""
    sys.argv = [script, *args]
    runpy.run_path(script, run_name="__main__")
    print("PHASE_STATS", json.dumps(phase_stats.snapshot()), flush=True)


def phase_example_np2(card_line: str) -> dict:
    """Phase 20: ``examples/torch_port/pytorch_synthetic_benchmark.py`` at
    np=2 on the one card through the launcher's ``--timeline-filename``,
    ``--output-filename`` and ``-v``, on the host plane."""
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="np2_example.",
                                     dir=REPO / "_runs") as out_dir:
        trace, logs = Path(out_dir) / "tl.json", Path(out_dir) / "logs"
        t0 = time.perf_counter()
        code, out, err = launch_job(
            2, ["example", str(EXAMPLE), *EXAMPLE_ARGS], LAUNCH_TIMEOUT,
            launcher_args=["--timeline-filename", str(trace),
                           "--output-filename", str(logs), "-v"])
        seconds = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"np=2 example failed with exit {code}:\n"
                                 f"{out}\n{err}")
        for r in range(2):
            for name in ("stdout", "stderr"):
                if not (logs / f"rank.{r}" / name).is_file():
                    raise AssertionError(f"--output-filename: no "
                                         f"rank.{r}/{name} under {logs}")
        rank0_log = (logs / "rank.0" / "stdout").read_text()
        traces = load_rank_traces(trace, 2)
    total = [line for line in out.splitlines()
             if line.startswith("[0]<stdout>: Total img/sec on 2 rank(s): ")]
    if not total or total[0].split(": ", 1)[1] not in rank0_log:
        raise AssertionError(f"no Total img/sec line from rank 0 (or not in "
                             f"its --output-filename file):\n{out}")
    merged = trace_merge.merge([list(t) for t in traces],
                               warn=lambda msg: print(msg, flush=True))
    pids = {e["pid"] for e in merged if "pid" in e}
    if pids != {0, 1}:
        raise AssertionError(f"merged trace pids {pids}, expected {{0, 1}}")
    cycles = [op_cycles(trace_lanes(t)) for t in traces]
    if cycles[0] != cycles[1]:
        differ = [k for k in set(cycles[0]) | set(cycles[1])
                  if cycles[0].get(k) != cycles[1].get(k)]
        raise AssertionError(f"op cycles differ across ranks for "
                             f"{len(differ)} tensors, e.g. {differ[:3]}")
    grad_cycles = {c for lane, cs in cycles[0].items()
                   if lane.startswith("grad.") for c in cs}
    doc = critical_path.analyze(merged)
    per_step = {r: {p: round(sum(
        s["phases_us"].get(str(r), {}).get(p, 0.0) for s in doc["steps"]
        if s["cycle"] in grad_cycles) / 1e3 / EXAMPLE_STEPS, 2)
        for p in TRACE_PHASES} for r in range(2)}
    stats = {}
    for line in out.splitlines():
        m = re.match(r"\[(\d)\]<stdout>: PHASE_STATS (.*)", line)
        if m:
            stats[int(m.group(1))] = json.loads(m.group(2))
    if set(stats) != {0, 1}:
        raise AssertionError(f"phase_stats from ranks {sorted(stats)}")
    result = {"seconds": seconds, "total": total[0].split(": ", 1)[1],
              "tensors": len(cycles[0]), "gradient_cycles": len(grad_cycles),
              "ms_per_step": per_step,
              "phase_stats_ms_per_step": {
                  r: {k: round(v["total_ms"] / EXAMPLE_STEPS, 2)
                      for k, v in stats[r].items()} for r in range(2)}}
    print(f"np2 example: {json.dumps(result)} [{card_line}]", flush=True)
    return result


def sync_batch(dev: torch.device) -> tuple:
    """Phase 21's global batch: 128 seeded images, the second half 2x + 1."""
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(2 * NP2_BATCH, IMAGE, IMAGE, 3, device=dev, generator=gen)
    y = torch.randint(0, 1000, (2 * NP2_BATCH,), device=dev, generator=gen)
    x[NP2_BATCH:] = 2 * x[NP2_BATCH:] + 1
    return x, y


def sync_model(dev: torch.device, sync: bool, seed: int = 0) -> tuple:
    """ResNet-50 (bf16, fused) from ``seed`` and its SGD-momentum
    ``DistributedOptimizer``."""
    model = resnet.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
        sync_bn=sync, generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=list(model.named_parameters()))
    return model, opt


def stats_probe() -> dict:
    """Wraps ``ops.allreduce``, through which the synced layers reduce their
    statistics: counts their forward (``.fwd``) and backward (``.bwd``)
    allreduces and sums the wall seconds spent in them."""
    acc = {"fwd": 0, "bwd": 0, "seconds": 0.0}
    inner = hvd_ops.allreduce

    def counted(tensor, *args, name=None, **kwargs):
        t = time.perf_counter()
        try:
            return inner(tensor, *args, name=name, **kwargs)
        finally:
            if name is not None and name.startswith("sync_bn."):
                acc[name.rsplit(".", 1)[1]] += 1
                acc["seconds"] += time.perf_counter() - t

    hvd_ops.allreduce = counted
    return acc


def running_stats(model) -> dict:
    """The watched layers' running mean and variance, on the host."""
    return {name: (model.get_submodule(name).mean.float().cpu(),
                   model.get_submodule(name).var.float().cpu())
            for name in SYNC_STATS_WATCHED}


def sync_step(model, opt, batch: dict, watched: list, probe: dict,
              negotiation: dict) -> dict:
    """One step of phase 21's job, with its counts, times and state."""
    torch.cuda.synchronize()
    launches = conv_bn_stats.LAUNCHES
    counts = dict(cuda_backend.stats)
    stats = dict(probe)
    before = negotiation_snapshot(negotiation)
    t0 = time.perf_counter()
    loss = train_step(model, opt, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return {
        **negotiation_delta(before, negotiation),
        "loss": float(loss), "ms": ms,
        "launches": conv_bn_stats.LAUNCHES - launches,
        "allreduce_tensors": cuda_backend.stats["allreduce_tensors"]
        - counts["allreduce_tensors"],
        "stats_fwd": probe["fwd"] - stats["fwd"],
        "stats_bwd": probe["bwd"] - stats["bwd"],
        "stats_ms": 1e3 * (probe["seconds"] - stats["seconds"]),
        "hash": _sha_all(p for _, p in model.named_parameters()),
        "applied": [p.grad.float().cpu() for p in watched],
        "running": running_stats(model)}


def checkpoint_probe(model, opt, out_dir: str) -> dict:
    """Phase 22 at np=2: rank 0 saves the synced model and its optimizer,
    both ranks restore the newest snapshot onto the card, and a missing
    path raises ``CheckpointNotFoundError`` on both."""
    base = os.path.join(out_dir, "ckpt", "resnet50")
    live = _sha_all(model.state_dict().values())
    t0 = time.perf_counter()
    published = checkpoint.save_rotating(
        base, {"model": model.state_dict(), "opt": opt.state_dict(),
               "step": SYNC_STEPS}, keep=CKPT_KEEP)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = checkpoint.restore_latest(
        base, like={"model": model.state_dict(), "opt": opt.state_dict(),
                    "step": 0})
    restore_s = time.perf_counter() - t0
    try:
        checkpoint.restore(os.path.join(out_dir, "ckpt", "missing"))
        missing = None
    except CheckpointNotFoundError as e:
        missing = str(e)
    return {"published": os.path.basename(published), "save_s": save_s,
            "restore_s": restore_s, "live": live, "step": state["step"],
            "restored": _sha_all(state["model"].values()),
            "devices": sorted({str(v.device)
                               for v in state["model"].values()}),
            "missing": missing}


def np2_syncbn_worker(out_dir: str) -> None:
    """One rank of phase 21's job: SYNC_STEPS synced steps on its half of
    the batch, phase 22's checkpoint of that state, then one unsynced step
    from the same weights (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    hvd.init(device="cuda:0")
    rank, size = hvd.rank(), hvd.size()
    dev = hvd.device()
    assert size == 2 and dev == torch.device("cuda", 0), (size, dev)
    x, y = sync_batch(dev)
    shard = slice(rank * NP2_BATCH, (rank + 1) * NP2_BATCH)
    batch = {"x": x[shard].contiguous(), "y": y[shard].contiguous()}
    del x, y
    probe = stats_probe()
    negotiation = negotiation_probe()
    out = {}
    for sync, steps in ((True, SYNC_STEPS), (False, 1)):
        model, opt = sync_model(dev, sync)
        params = dict(model.named_parameters())
        watched = [params[name] for name in SYNC_WATCHED]
        synced = sum(getattr(m, "sync_name", None) is not None
                     for m in model.modules())
        assert synced == (SYNC_LAYERS if sync else 0), synced
        out[f"sync.{sync}"] = [
            sync_step(model, opt, batch, watched, probe, negotiation)
            for _ in range(steps)]
        if sync:
            out["ckpt"] = checkpoint_probe(model, opt, out_dir)
        del model, opt, params, watched
        torch.cuda.empty_cache()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    hvd.shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print("NP2_SYNCBN_DONE", rank, flush=True)


def sync_reference(dev: torch.device) -> tuple:
    """Phase 21's np=1 step on the whole batch of 128: the applied gradient
    of SYNC_WATCHED and the watched running statistics; then the same step
    with the batch's halves swapped, which changes nothing but the order
    of the sums: its distance from the first is the bf16 noise floor."""
    hvd.init()
    x, y = sync_batch(dev)
    steps = []
    for order in (slice(None), torch.cat([torch.arange(NP2_BATCH, 2 *
                                                       NP2_BATCH),
                                          torch.arange(NP2_BATCH)])):
        model, opt = sync_model(dev, True)
        train_step(model, opt, {"x": x[order], "y": y[order]})
        params = dict(model.named_parameters())
        steps.append({
            "applied": [params[n].grad.float().cpu() for n in SYNC_WATCHED],
            "running": running_stats(model)})
        del model, opt, params
    del x, y
    hvd.shutdown()
    torch.cuda.empty_cache()
    ref, swapped = steps
    return ref, sync_errors(swapped, ref)


def sync_errors(step: dict, ref: dict) -> dict:
    """Relative RMS against the np=1 step: each watched applied gradient,
    and per watched layer the larger of its running mean's and running
    variance's update (running minus the initial 0 and 1)."""
    grads = {}
    for name, got, want in zip(SYNC_WATCHED, step["applied"],
                               ref["applied"]):
        assert want.norm() > 0, f"{name}: no gradient in the np=1 step"
        grads[name] = rel_rms(got, want)
    stats = {}
    for name in SYNC_STATS_WATCHED:
        (mean, var), (rmean, rvar) = step["running"][name], \
            ref["running"][name]
        stats[name] = max(rel_rms(mean, rmean), rel_rms(var - 1, rvar - 1))
    return {"grad": grads, "stats": stats}


def phase_np2_syncbn(card_line: str, np2: dict) -> dict:
    """Phase 21 and phase 22's np=2 part: the reference step here, then the
    job through the launcher (``--worker np2-syncbn``)."""
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    try:
        ref, floor = sync_reference(dev)
    finally:
        torch.backends.cudnn.deterministic = False
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="np2_syncbn.",
                                     dir=REPO / "_runs") as out_dir:
        t0 = time.perf_counter()
        code, out, err = launch_job(2, ["np2-syncbn", out_dir],
                                    LAUNCH_TIMEOUT)
        seconds = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"np=2 SyncBN job failed with exit {code}:"
                                 f"\n{out}\n{err}")
        ranks = [torch.load(Path(out_dir) / f"rank{r}.pt")
                 for r in range(2)]
    for sync in (True, False):
        runs = [r[f"sync.{sync}"] for r in ranks]
        for step, (s0, s1) in enumerate(zip(*runs)):
            for r, s in enumerate((s0, s1)):
                want = (SYNC_LAYERS, SYNC_LAYERS) if sync else (0, 0)
                assert s["launches"] == LAUNCHES_PER_STEP, (sync, r, step, s)
                assert (s["stats_fwd"], s["stats_bwd"]) == want, \
                    (sync, r, step, s["stats_fwd"], s["stats_bwd"])
                assert s["allreduce_tensors"] == NP2_PARAMS + sum(want), \
                    (sync, r, step, s["allreduce_tensors"])
                assert math.isfinite(s["loss"]), (sync, r, step, s["loss"])
            if s0["hash"] != s1["hash"]:
                raise AssertionError(
                    f"sync_bn={sync} step {step}: parameters differ across "
                    f"ranks ({s0['hash']} vs {s1['hash']})")
    errors = {}
    for sync in (True, False):
        s0, s1 = (r[f"sync.{sync}"][0] for r in ranks)
        for name, a0, a1 in zip(SYNC_WATCHED, s0["applied"], s1["applied"]):
            assert torch.equal(a0, a1), (sync, name)
        for name in SYNC_STATS_WATCHED:
            for a, b in zip(s0["running"][name], s1["running"][name]):
                if sync:
                    assert torch.equal(a, b), name
        errors[sync] = sync_errors(s0, ref)
    synced, control = errors[True], errors[False]
    print(f"np2 syncbn against the np=1 step on 128 images, relative RMS: "
          f"synced {json.dumps(synced)}; control {json.dumps(control)}; "
          f"np=1 with the halves swapped (the noise floor) "
          f"{json.dumps(floor)} (limits: gradients {SYNC_GRAD_REL_RMS}, "
          f"statistics' update {SYNC_STATS_REL_RMS}) [{card_line}]",
          flush=True)
    # Each layer's allreduces are named after it: from step 2 on rank 1's
    # requests are all answered by the cache.
    for step, s in enumerate(ranks[1]["sync.True"][1:], start=1):
        if s["serialized_request_count"] != 0:
            raise AssertionError(
                f"step {step}: rank 1 sent {s['serialized_request_count']} "
                f"serialized requests with sync_bn=True (expected 0)")
    ckpts = [r["ckpt"] for r in ranks]
    for r, c in enumerate(ckpts):
        if c["restored"] != c["live"] or c["devices"] != ["cuda:0"] or \
                c["step"] != SYNC_STEPS or not (c["missing"] or "").startswith(
                    "no checkpoint at"):
            raise AssertionError(f"rank {r} checkpoint: {c}")
    assert ckpts[0]["live"] == ckpts[1]["live"]
    assert ckpts[0]["missing"] == ckpts[1]["missing"]
    assert ckpts[0]["published"] == ckpts[1]["published"] == \
        "resnet50.00000001", ckpts
    keys = ("loss", "ms", "stats_ms", "launches", "allreduce_tensors",
            "stats_fwd", "stats_bwd", "negotiation_ms") + NEGOTIATION_COUNTERS
    summary = {
        "seconds": seconds, "floor": floor,
        "errors": {str(k): v for k, v in errors.items()},
        "launches": sum(s["launches"] for r in ranks for s in r["sync.True"]),
        "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
        "ckpt": [{k: c[k] for k in ("save_s", "restore_s", "published")}
                 for c in ckpts],
        "per_rank": {str(sync): [{k: [s[k] for s in r[f"sync.{sync}"]]
                                  for k in keys} for r in ranks]
                     for sync in (True, False)}}
    for r in range(2):
        on = summary["per_rank"]["True"][r]
        off = summary["per_rank"]["False"][r]
        print(f"np2 syncbn: rank {r} ResNet-50 batch {NP2_BATCH} "
              f"{IMAGE}x{IMAGE} bf16, host plane, sync_bn=True ms/step "
              f"{[round(v, 1) for v in on['ms']]} (in the {2 * SYNC_LAYERS} "
              f"statistics allreduces {[round(v, 1) for v in on['stats_ms']]}"
              f"), control sync_bn=False {[round(v, 1) for v in off['ms']]}, "
              f"phase 11 (unsynced) "
              f"{[round(v, 1) for v in np2['per_rank'][r]['ms']]}; losses "
              f"{[round(v, 4) for v in on['loss']]}; allreduced tensors "
              f"{on['allreduce_tensors']} ({NP2_PARAMS} gradients + "
              f"{on['stats_fwd']} + {on['stats_bwd']}); ms in "
              f"compute_response_list "
              f"{[round(v, 1) for v in on['negotiation_ms']]}, serialized "
              f"requests {on['serialized_request_count']}, cache hits "
              f"{on['cache_hit_count']}, misses {on['cache_miss_count']}; "
              f"peak {summary['peak_mem_gb'][r]:.1f} GB [{card_line}]",
              flush=True)
    print(f"np2 checkpoint: rank 0 saved {ckpts[0]['published']} in "
          f"{ckpts[0]['save_s']:.3f}s; restore_latest on both ranks "
          f"{[round(c['restore_s'], 3) for c in ckpts]}s, the live hash; "
          f"a missing path raised CheckpointNotFoundError on both: "
          f"{ckpts[0]['missing']!r} [{card_line}]", flush=True)
    if max(synced["grad"].values()) > SYNC_GRAD_REL_RMS or \
            max(synced["stats"].values()) > SYNC_STATS_REL_RMS:
        raise AssertionError(
            f"synced np=2 step against the np=1 step: {synced} (limits: "
            f"gradients {SYNC_GRAD_REL_RMS}, statistics {SYNC_STATS_REL_RMS})")
    if max(control["grad"].values()) <= SYNC_GRAD_REL_RMS or \
            max(control["stats"].values()) <= SYNC_STATS_REL_RMS:
        raise AssertionError(
            f"the unsynced control must miss both limits: {control}")
    return summary


def elastic_batch(batch: int, rank: int, dev: torch.device) -> dict:
    """Batch ``batch``'s 64 images for ``rank``, from a seed of both."""
    gen = torch.Generator(device=dev).manual_seed(1000 * batch + rank)
    return {"x": torch.randn(NP2_BATCH, IMAGE, IMAGE, 3, device=dev,
                            generator=gen),
            "y": torch.randint(0, 1000, (NP2_BATCH,), device=dev,
                               generator=gen)}


def _raw_sha(tensors) -> str:
    """SHA-256 of the tensors' raw bytes, whatever their dtype (bf16
    included)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def elastic_hash(model, inner, batch: int) -> str:
    """The parameters, buffers, optimizer state and ``batch``, hashed."""
    tensors = [t for _, t in sorted(model.state_dict().items())]
    for pid, pstate in sorted(inner.state_dict()["state"].items()):
        tensors.extend(v for _, v in sorted(pstate.items())
                       if isinstance(v, torch.Tensor))
    tensors.append(torch.tensor([batch]))
    return _raw_sha(tensors)


def elastic_worker(out_dir: str) -> None:
    """One process of phase 23's elastic job (module docstring): records
    each step, each state sync and each reset in
    ``out_dir/<identity>.<pid>.jsonl``."""
    from horovod_tpu_torch.elastic import state as elastic_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    hosts = Path(out_dir) / "hosts.txt"
    me = os.environ["HOROVOD_HOSTNAME"]
    log_path = Path(out_dir) / f"{me}.{os.getpid()}.jsonl"

    def record(**fields) -> None:
        with open(log_path, "a") as f:
            f.write(json.dumps({"t": time.time(), **fields}) + "\n")

    hvd.init(device="cuda:0")
    dev = hvd.device()
    record(kind="start", epoch=int(os.environ.get("HOROVOD_EPOCH", "0")),
           rank=hvd.rank(), size=hvd.size(), process=process_start())
    model = resnet.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
        generator=torch.Generator().manual_seed(0)).to(dev)
    record(kind="model")
    inner = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    opt = hvd.DistributedOptimizer(inner,
                                   named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model, opt, batch=0)
    record(kind="state")

    def wait_for_change(text: str) -> None:
        if hvd.rank() == 0:
            hosts.write_text(text)
            record(kind="change", what=text.strip().replace("\n", ","))
        deadline = time.monotonic() + ELASTIC_PAUSE_SECS
        while time.monotonic() < deadline:
            state.check_host_updates()
            time.sleep(0.02)
        raise AssertionError(f"batch {state.batch}: the host change never "
                             "arrived")

    @hvd.elastic.run
    def train(state):
        record(kind="enter", epoch=int(os.environ["HOROVOD_EPOCH"]),
               rank=hvd.rank(), size=hvd.size(), batch=state.batch,
               hash=elastic_hash(model, inner, state.batch),
               resets=elastic_state.reset_log)
        while state.batch < ELASTIC_BATCHES:
            plan = ELASTIC_PLAN.get(state.batch)
            if plan is not None and hvd.size() == plan[0]:
                wait_for_change(plan[1])
            batch = elastic_batch(state.batch, hvd.rank(), dev)
            check = None
            if hvd.size() == 1 and state.batch == min(ELASTIC_PLAN):
                # The first step at size 1: the same step without the
                # runtime, from the same state, must give the same bits.
                check = (copy.deepcopy(model.state_dict()),
                         copy.deepcopy(inner.state_dict()))
            torch.cuda.synchronize()
            launches = conv_bn_stats.LAUNCHES
            start = time.time()
            t0 = time.perf_counter()
            model.train()
            opt.zero_grad(set_to_none=True)
            loss = cross_entropy_loss(model(batch["x"]), batch["y"])
            if state.batch == ELASTIC_KILL and hvd.size() == 2 \
                    and me == "127.0.0.1":
                record(kind="kill")
                os.kill(os.getpid(), signal.SIGKILL)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            end = time.time()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = conv_bn_stats.LAUNCHES - launches
            digest = elastic_hash(model, inner, state.batch + 1)
            plain = None
            if check is not None:
                plain = elastic_plain_step(model, check, batch)
            record(kind="step", epoch=int(os.environ["HOROVOD_EPOCH"]),
                   rank=hvd.rank(), size=hvd.size(), batch=state.batch,
                   loss=float(loss), ms=ms, start=start, end=end,
                   launches=launches,
                   params=_raw_sha(p for _, p in
                                   sorted(model.named_parameters())),
                   plain=plain)
            state.batch += 1
            state.commit()
            record(kind="commit", batch=state.batch, hash=digest)

    train(state)
    record(kind="done", rank=hvd.rank(), size=hvd.size())
    hvd.shutdown()


def process_start() -> float:
    """This process's start, wall clock: its start in clock ticks since
    boot (``/proc/self/stat``) against the boot clock now."""
    ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                .split()[19])
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - \
        ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - age


def elastic_plain_step(model, check: tuple, batch: dict) -> str:
    """The step of ``model`` from the state ``check`` (its state dict and
    its SGD's) on ``batch`` with no runtime: the parameters' hash."""
    local = copy.deepcopy(model)
    local.load_state_dict(check[0])
    opt = torch.optim.SGD(local.parameters(), lr=0.01, momentum=0.9)
    opt.load_state_dict(check[1])
    launches = conv_bn_stats.LAUNCHES
    train_step(local, opt, batch)
    torch.cuda.synchronize()
    # The comparison's launches are not the main path's.
    conv_bn_stats.LAUNCHES = launches
    out = _raw_sha(p for _, p in sorted(local.named_parameters()))
    del local, opt
    return out


def phase_elastic(card_line: str) -> dict:
    """Phase 23 (module docstring): the job through the elastic launcher,
    then its gates from the processes' records."""
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="elastic.",
                                     dir=REPO / "_runs") as out_dir:
        hosts = Path(out_dir) / "hosts.txt"
        hosts.write_text(ELASTIC_BOTH)
        script = Path(out_dir) / "discover.sh"
        script.write_text(f"#!/bin/sh\ncat {hosts}\n")
        script.chmod(0o755)
        t0 = time.perf_counter()
        code, out, err = launch_job(
            2, ["elastic", out_dir], LAUNCH_TIMEOUT,
            launcher_args=["--min-np", "1", "--max-np", "2",
                           "--host-discovery-script", str(script)])
        seconds = time.perf_counter() - t0
        logs = {p.name: [json.loads(l) for l in p.read_text().splitlines()]
                for p in sorted(Path(out_dir).glob("*.jsonl"))}
    if code != 0:
        raise AssertionError(f"elastic job failed with exit {code}:\n"
                             f"{out[-6000:]}\n{err[-6000:]}")
    return elastic_gates(logs, seconds, card_line)


def elastic_gates(logs: dict, seconds: float, card_line: str) -> dict:
    events = sorted((e for log in logs.values() for e in log),
                    key=lambda e: e["t"])
    steps = [e for e in events if e["kind"] == "step"]
    # The survivor: the process on localhost that ran every batch.
    survivor = next(name for name, log in logs.items()
                    if name.startswith("localhost.")
                    and any(e["kind"] == "done" for e in log))
    own = logs[survivor]
    sizes = [e["size"] for e in own if e["kind"] == "step"]
    assert sizes == ELASTIC_SIZES, sizes
    assert [e["batch"] for e in own if e["kind"] == "step"] == \
        list(range(ELASTIC_BATCHES)), own
    seen = [s for i, s in enumerate(sizes) if i == 0 or s != sizes[i - 1]]
    assert seen == [2, 1, 2, 1], seen
    for e in steps:
        assert e["launches"] == LAUNCHES_PER_STEP, e
        assert math.isfinite(e["loss"]), e
    # Every step at size 2 is taken by both ranks and leaves the same
    # parameters on both (each rank's BatchNorm statistics are its own).
    for batch in range(ELASTIC_BATCHES):
        both = [e for e in steps if e["batch"] == batch and e["size"] == 2]
        if both:
            assert len(both) == 2 and both[0]["params"] == \
                both[1]["params"], (batch, both)
    # After every sync (each entry into the training function at size 2),
    # the same state on both ranks.
    enters = [e for e in events if e["kind"] == "enter"]
    for epoch in sorted({e["epoch"] for e in enters}):
        at = [e for e in enters if e["epoch"] == epoch]
        if at[0]["size"] == 2:
            assert len(at) == 2 and at[0]["hash"] == at[1]["hash"] and \
                at[0]["batch"] == at[1]["batch"], at
    # The first step at size 1: the bits of a step without the runtime.
    first = next(e for e in own if e["kind"] == "step" and e["size"] == 1)
    assert first["plain"] is not None and first["plain"] == \
        first["params"], first
    # The kill: the survivor resumes from its last commit, bit for bit.
    kill = next(e for e in events if e["kind"] == "kill")
    commits = [e for e in own if e["kind"] == "commit" and e["t"] < kill["t"]]
    resumed = next(e for e in own if e["kind"] == "enter"
                   and e["t"] > kill["t"])
    assert resumed["batch"] == commits[-1]["batch"] == ELASTIC_KILL, \
        (resumed["batch"], commits[-1])
    assert resumed["hash"] == commits[-1]["hash"], (resumed, commits[-1])
    # Recovery times, on the survivor: from the change (the hosts file's
    # write, or the kill) to the first finished step at the new size.
    changes = [e for e in events if e["kind"] in ("change", "kill")]
    resets = resumed["resets"]
    assert len(resets) == 3 and len(changes) == 3, (resets, changes)
    recovery = []
    for change, reset in zip(changes, resets):
        done = next(e for e in own if e["kind"] == "step"
                    and e["epoch"] == reset["epoch"])
        r = {
            "change": change.get("what", "kill 127.0.0.1"),
            "cause": reset["cause"], "epoch": reset["epoch"],
            "total_s": done["end"] - change["t"],
            "notice_s": reset["caught"] - change["t"],
            "teardown_s": reset["torn_down"] - reset["caught"],
            "wait_epoch_s": reset["adopted"] - reset["torn_down"],
            "group_build_s": reset["initialized"] - reset["adopted"],
            "sync_s": reset["synced"] - reset["initialized"],
            # The phase's own checks between the sync and the step: the
            # entry state's hash and the plain step's snapshot.
            "checks_s": done["start"] - reset["synced"],
            "first_step_s": done["end"] - done["start"],
        }
        joiner = [log for log in logs.values()
                  if any(e["kind"] == "start" and e["epoch"] == reset["epoch"]
                         for e in log)]
        if joiner:
            # The process that joined, from the change: its start, its
            # runtime up (imports, CUDA, the group), its model built, its
            # optimizer and elastic state built (torch's first optimizer
            # in a process imports torch._dynamo), its state synced.
            at = {e["kind"]: e for e in joiner[0]}
            r["joiner_s"] = {
                "process": at["start"]["process"] - change["t"],
                "init": at["start"]["t"] - change["t"],
                "model": at["model"]["t"] - change["t"],
                "state": at["state"]["t"] - change["t"],
                "synced": at["enter"]["t"] - change["t"]}
        recovery.append(r)
    ms = {size: [e["ms"] for e in own if e["kind"] == "step"
                 and e["size"] == size] for size in (1, 2)}
    return {"seconds": seconds, "recovery": recovery, "ms": ms,
            "launches": sum(e["launches"] for e in steps)}


def outage_worker(out_dir: str) -> None:
    """One process of phase 24's job (module docstring): phase 23's step,
    taken until the phase writes ``out_dir/stop``; each step's record holds
    the lease renewals' failures so far."""
    from horovod_tpu_torch.core import metrics
    from horovod_tpu_torch.elastic import state as elastic_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = Path(out_dir)
    log_path = out / f"{os.environ['HOROVOD_HOSTNAME']}.{os.getpid()}.jsonl"

    def record(**fields) -> None:
        with open(log_path, "a") as f:
            f.write(json.dumps({"t": time.time(), **fields}) + "\n")

    hvd.init(device="cuda:0")
    dev = hvd.device()
    model = resnet.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
        generator=torch.Generator().manual_seed(0)).to(dev)
    inner = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    opt = hvd.DistributedOptimizer(inner,
                                   named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model, opt, batch=0)

    @hvd.elastic.run
    def train(state):
        record(kind="enter", epoch=int(os.environ["HOROVOD_EPOCH"]),
               rank=hvd.rank(), size=hvd.size(), batch=state.batch,
               hash=elastic_hash(model, inner, state.batch),
               resets=elastic_state.reset_log)
        while not (out / "stop").exists():
            batch = elastic_batch(state.batch, hvd.rank(), dev)
            torch.cuda.synchronize()
            launches = conv_bn_stats.LAUNCHES
            start = time.time()
            model.train()
            opt.zero_grad(set_to_none=True)
            loss = cross_entropy_loss(model(batch["x"]), batch["y"])
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            end = time.time()
            record(kind="step", epoch=int(os.environ["HOROVOD_EPOCH"]),
                   rank=hvd.rank(), size=hvd.size(), batch=state.batch,
                   loss=float(loss), start=start, end=end,
                   launches=conv_bn_stats.LAUNCHES - launches,
                   params=_raw_sha(p for _, p in
                                   sorted(model.named_parameters())),
                   failures=metrics.registry.get_counter(
                       "lease_renew_failures_total"))
            state.batch += 1
            state.commit()

    train(state)
    record(kind="done", rank=hvd.rank(), size=hvd.size())
    hvd.shutdown()


def serve_rendezvous(port: int, out: Path, n: int, key: str):
    """The supervised rendezvous server, incarnation ``n``, on ``port``
    over ``out/journal``, writing its trace to ``out/server<n>.json``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.rendezvous",
         "--bind", "127.0.0.1", "--port", str(port),
         "--journal-dir", str(out / "journal")],
        cwd=str(REPO), text=True, stdout=subprocess.PIPE,
        env={**os.environ, "HOROVOD_SECRET_KEY": key,
             "HOROVOD_SERVER_TIMELINE": str(out / f"server{n}.json"),
             "HOROVOD_TIMELINE_CONTROL_PLANE": "1"})
    line = proc.stdout.readline()
    if not line.startswith("rendezvous serving on port"):
        proc.kill()
        raise AssertionError(f"the rendezvous server did not start: {line!r}")
    return proc


def outage_logs(out: Path) -> dict:
    return {p.name: [json.loads(line) for line in p.read_text().splitlines()]
            for p in sorted(out.glob("*.jsonl"))}


def outage_steps(logs: dict, host: str) -> list:
    return [e for name, log in logs.items() if name.startswith(host + ".")
            for e in log if e["kind"] == "step"]


def outage_wait(out: Path, what: str, cond, deadline: float) -> None:
    while not cond(outage_logs(out)):
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 24 timed out waiting for {what}")
        time.sleep(0.1)


def phase_outage(card_line: str) -> dict:
    """Phase 24 (module docstring): the job, the kill, the restart and the
    shrink, then the gates from the processes' records and traces."""
    (REPO / "_runs").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="outage.",
                                     dir=REPO / "_runs") as out_dir:
        out = Path(out_dir)
        hosts = out / "hosts.txt"
        hosts.write_text(ELASTIC_BOTH)
        script = out / "discover.sh"
        script.write_text(f"#!/bin/sh\ncat {hosts}\n")
        script.chmod(0o755)
        key = secrets.token_hex(32)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        server = serve_rendezvous(port, out, 0, key)
        marks = {}
        t0 = time.perf_counter()
        job_out, job_err = open(out / "job.out", "w"), open(out / "job.err",
                                                            "w")
        job = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
             "2", "--min-np", "1", "--max-np", "2",
             "--host-discovery-script", str(script), sys.executable,
             str(REPO / "chip_smoke.py"), "--worker", "outage", out_dir],
            cwd=str(REPO), text=True, stdout=job_out, stderr=job_err,
            start_new_session=True,
            env={**os.environ,
                 "HOROVOD_RENDEZVOUS_EXTERNAL": f"127.0.0.1:{port}",
                 "HOROVOD_SECRET_KEY": key,
                 "HOROVOD_METRICS_PUSH_SECS": str(OUTAGE_RENEW_SECS),
                 "HOROVOD_TIMELINE": str(out / "tl.json"),
                 "HOROVOD_TIMELINE_CONTROL_PLANE": "1"})
        deadline = time.monotonic() + LAUNCH_TIMEOUT
        try:
            outage_wait(out, "both ranks training", lambda logs: all(
                len(outage_steps(logs, h)) >= OUTAGE_PRE_STEPS
                for h in ("localhost", "127.0.0.1")), deadline)
            marks["kill"] = time.time()
            server.send_signal(signal.SIGKILL)
            server.wait(timeout=30)
            time.sleep(OUTAGE_SECS)
            server = serve_rendezvous(port, out, 1, key)
            marks["restart"] = time.time()
            os.environ["HOROVOD_SECRET_KEY"] = key
            try:
                marks["replayed_epoch"] = int(HTTPStoreClient(
                    "127.0.0.1", port).get("driver", "epoch"))
            finally:
                del os.environ["HOROVOD_SECRET_KEY"]
            outage_wait(out, "steps after the restart", lambda logs: all(
                any(e["start"] > marks["restart"] + 2 * OUTAGE_RENEW_SECS
                    for e in outage_steps(logs, h))
                for h in ("localhost", "127.0.0.1")), deadline)
            marks["shrink"] = time.time()
            hosts.write_text("localhost:1\n")
            outage_wait(out, "the steps at size 1", lambda logs: sum(
                e["size"] == 1 for e in outage_steps(logs, "localhost"))
                >= OUTAGE_SIZE1_STEPS, deadline)
            (out / "stop").write_text("")
            code = job.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            try:
                os.killpg(job.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            # SIGTERM: the restarted server closes its trace.  The killed
            # one's trace is lost with its unwritten buffer.
            server.terminate()
            server.wait(timeout=30)
            job.wait()
            job_out.close()
            job_err.close()
        seconds = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(
                f"phase 24's job failed with exit {code}:\n"
                f"{(out / 'job.out').read_text()[-6000:]}\n"
                f"{(out / 'job.err').read_text()[-6000:]}")
        logs = outage_logs(out)
        traces = {name: trace_merge.load_trace(str(out / name))
                  for name in ("server1.json", "tl.json.driver", "tl.json")}
        cp = control_path.analyze(trace_merge.merge(list(traces.values())))
        journal_bytes = sum(f.stat().st_size
                            for f in (out / "journal").iterdir())
    return outage_gates(logs, traces, cp, marks, journal_bytes, seconds)


def outage_gates(logs: dict, traces: dict, cp: dict, marks: dict,
                 journal_bytes: int, seconds: float) -> dict:
    survivor = [e for name, log in logs.items()
                if name.startswith("localhost.") for e in log]
    steps = {h: outage_steps(logs, h) for h in ("localhost", "127.0.0.1")}
    # One process per host: no worker was shed and spawned again.
    assert sorted(name.rsplit(".", 2)[0] for name in logs) == \
        ["127.0.0.1", "localhost"], sorted(logs)
    # No epoch change for the outage: both ranks at size 2 in epoch 0
    # until the shrink; then the survivor alone, at the replayed epoch + 1.
    for host, own in steps.items():
        before = [e for e in own if e["start"] < marks["shrink"]]
        assert before and {(e["size"], e["epoch"]) for e in before} == \
            {(2, 0)}, (host, before)
    enters = [e for e in survivor if e["kind"] == "enter"]
    assert [e["epoch"] for e in enters] == \
        [0, marks["replayed_epoch"] + 1], enters
    assert enters[1]["t"] > marks["shrink"], (enters, marks)
    assert marks["replayed_epoch"] == 0, marks
    after = [e for e in steps["localhost"] if e["size"] == 1]
    assert {e["epoch"] for e in after} == {1}, after
    # The renewals failed during the outage, on both ranks.
    for host, own in steps.items():
        during = [e["failures"] for e in own
                  if marks["restart"] < e["start"] < marks["shrink"]]
        assert during and max(during) > 0, (host, during)
    # 36 B8 launches per step; the same parameters on both ranks at every
    # step at size 2, and the same state after the sync at the start.
    all_steps = steps["localhost"] + steps["127.0.0.1"]
    for e in all_steps:
        assert e["launches"] == LAUNCHES_PER_STEP, e
        assert math.isfinite(e["loss"]), e
    ours = {e["batch"]: e["params"] for e in steps["localhost"]
            if e["size"] == 2}
    theirs = {e["batch"]: e["params"] for e in steps["127.0.0.1"]}
    assert set(ours) == set(theirs) and all(
        ours[b] == theirs[b] for b in ours), (ours, theirs)
    first = [e for log in logs.values() for e in log
             if e["kind"] == "enter" and e["epoch"] == 0]
    assert len(first) == 2 and first[0]["hash"] == first[1]["hash"], first
    # The driver's trace: one CHURN_EVENT per epoch change; control_path's
    # phases sum to its coverage of the window.
    churn = [e for e in traces["tl.json.driver"]
             if e.get("name") == "CHURN_EVENT"]
    assert [e["args"]["epoch"] for e in churn] == [1], churn
    assert cp["event_count"] == 1, cp
    event = cp["events"][0]
    covered = sum(event["phases_us"].values())
    assert abs(covered - event["coverage"] * event["duration_us"]) <= \
        0.01 * event["duration_us"] + 1.0, event
    server = traces["server1.json"]
    replay = [e for e in server if e.get("name") == "JR_REPLAY"]
    fsyncs = [e for e in server if e.get("name") == "JR_FSYNC"]
    assert len(replay) == 1 and fsyncs, (replay, len(fsyncs))
    span = [e["ts"] for e in server if "ts" in e]
    reset = enters[1]["resets"][-1]
    done = after[0]

    def ms_per_step(lo, hi):
        return [round(1e3 * (e["end"] - e["start"]), 1)
                for e in steps["localhost"] if lo <= e["start"] < hi]

    return {
        "seconds": seconds,
        "outage_s": marks["restart"] - marks["kill"],
        "replay_ms": replay[0]["dur"] / 1e3,
        "ms_before": ms_per_step(0, marks["kill"]),
        "ms_across": ms_per_step(marks["kill"], marks["restart"]),
        "ms_after": ms_per_step(marks["restart"], marks["shrink"]),
        "shrink": {
            "total_s": done["end"] - marks["shrink"],
            "notice_s": reset["caught"] - marks["shrink"],
            "teardown_s": reset["torn_down"] - reset["caught"],
            "wait_epoch_s": reset["adopted"] - reset["torn_down"],
            "group_build_s": reset["initialized"] - reset["adopted"],
            "sync_s": reset["synced"] - reset["initialized"],
            "first_step_s": done["end"] - done["start"]},
        "churn_ms": event["duration_us"] / 1e3,
        "churn_phases_ms": {k: v / 1e3 for k, v in
                            event["phases_us"].items()},
        "churn_unattributed_ms": event["unattributed_us"] / 1e3,
        "coverage": event["coverage"],
        "journal_bytes": journal_bytes,
        "fsync_ms": sum(e["dur"] for e in fsyncs) / 1e3 / len(fsyncs),
        "writes_per_s": len(fsyncs) / ((max(span) - min(span)) / 1e6),
        "launches": sum(e["launches"] for e in all_steps),
        "steps": len(all_steps),
    }


def flip_payload_byte(snapshot: str) -> None:
    path = os.path.join(snapshot, checkpoint.PAYLOAD_FILE)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def phase_checkpoint(card_line: str) -> dict:
    """Phase 22 at np=1: three rotating snapshots of ResNet-50 and its
    SGD-momentum state (after steps 1, 2 and 3), the newest corrupted;
    ``restore_latest`` must skip it and return the second, from which step
    3 must give the live step 3's bits."""
    torch.backends.cudnn.deterministic = True
    hvd.init()
    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(22)
    batch = {"x": torch.randn(BATCH, IMAGE, IMAGE, 3, device=dev,
                              generator=gen),
             "y": torch.randint(0, 1000, (BATCH,), device=dev,
                                generator=gen)}
    model, opt = sync_model(dev, False)
    skipped = []
    warn = checkpoint.log.warning
    checkpoint.log.warning = lambda msg, *a: skipped.append(msg % a)
    try:
        (REPO / "_runs").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="ckpt.",
                                         dir=REPO / "_runs") as out_dir:
            base = os.path.join(out_dir, "resnet50")
            saves, published = [], []
            for step in (1, 2, 3):
                train_step(model, opt, batch)
                torch.cuda.synchronize()
                if step == 3:
                    live = _sha_all(model.state_dict().values())
                t0 = time.perf_counter()
                published.append(checkpoint.save_rotating(
                    base, {"model": model.state_dict(),
                           "opt": opt.state_dict(), "step": step},
                    keep=CKPT_KEEP))
                saves.append(time.perf_counter() - t0)
            nbytes = json.loads(Path(published[-1] + checkpoint.MANIFEST_SUFFIX)
                                .read_text())["bytes"]
            kept = [os.path.basename(p) for _, p in
                    checkpoint._list_snapshots(base)]
            assert kept == ["resnet50.00000003", "resnet50.00000002"], kept
            flip_payload_byte(published[-1])
            del model, opt
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            state = checkpoint.restore_latest(base)
            restore_s = time.perf_counter() - t0
            assert state["step"] == 2, state["step"]
            assert len(skipped) == 1 and "resnet50.00000003" in skipped[0] \
                and "payload CRC mismatch" in skipped[0], skipped
            model, opt = sync_model(dev, False, seed=1)
            model.load_state_dict(state["model"])
            opt.load_state_dict(state["opt"])
            train_step(model, opt, batch)
            torch.cuda.synchronize()
            resumed = _sha_all(model.state_dict().values())
            if resumed != live:
                raise AssertionError(
                    f"step 3 from the restored snapshot ({resumed}) differs "
                    f"from the live step 3 ({live})")
            try:
                checkpoint.restore(os.path.join(out_dir, "missing"))
                raise AssertionError("restore of a missing path returned")
            except CheckpointNotFoundError as e:
                missing = str(e)
    finally:
        checkpoint.log.warning = warn
        torch.backends.cudnn.deterministic = False
        hvd.shutdown()
    mb = nbytes / 1e6
    result = {"mb": mb, "save_s": saves, "restore_s": restore_s,
              "save_mb_per_s": [mb / s for s in saves],
              "restore_mb_per_s": mb / restore_s, "skipped": skipped[0],
              "missing": missing}
    print(f"checkpoint np=1: ResNet-50 + SGD-momentum, {mb:.1f} MB per "
          f"snapshot; save_rotating(keep={CKPT_KEEP}) x3 "
          f"{[round(s, 3) for s in saves]}s "
          f"({[round(v, 1) for v in result['save_mb_per_s']]} MB/s); the "
          f"newest corrupted, restore_latest {restore_s:.3f}s "
          f"({result['restore_mb_per_s']:.1f} MB/s) logged "
          f"{skipped[0]!r}; step 3 from the restored state the live step "
          f"3's bits; a missing path: {missing!r} [{card_line}]", flush=True)
    return result


def reset_counts() -> None:
    conv_bn_stats.LAUNCHES = 0
    for launches in (fa.LAUNCHES, adasum_kernels.LAUNCHES):
        for key in launches:
            launches[key] = 0
    for key in cuda_backend.stats:
        cuda_backend.stats[key] = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--worker"]:
        if sys.argv[2:3] == ["np2-resnet"]:
            np2_worker(sys.argv[3])
        elif sys.argv[2:3] == ["np2-bert"]:
            np2_bert_worker(sys.argv[3])
        elif sys.argv[2:3] == ["np2-bert-adasum"]:
            np2_bert_adasum_worker(sys.argv[3])
        elif sys.argv[2:3] == ["np2-stall"]:
            np2_stall_worker(sys.argv[3])
        elif sys.argv[2:3] == ["np2-overlap"]:
            np2_overlap_worker(sys.argv[3])
        elif sys.argv[2:3] == ["nccl-np2"]:
            nccl_np2_worker()
        elif sys.argv[2:3] == ["example"]:
            example_worker(sys.argv[3], sys.argv[4:])
        elif sys.argv[2:3] == ["np2-syncbn"]:
            np2_syncbn_worker(sys.argv[3])
        elif sys.argv[2:3] == ["elastic"]:
            elastic_worker(sys.argv[3])
        elif sys.argv[2:3] == ["outage"]:
            outage_worker(sys.argv[3])
        else:
            raise SystemExit(f"unknown worker {sys.argv[2:]}")
        return 0
    card_line = card()
    print(card_line, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    # fp32 comparisons on the card: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.compile_all(["matmul_bn_stats", "flash_attention", "adasum"])
    conv_bn_stats._kernel()
    fa._kernels()
    adasum_kernels._kernels()
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

    torch.cuda.empty_cache()
    adasum_rows = phase_adasum_kernels(bert["sizes"], main["sizes"])

    torch.cuda.empty_cache()
    nccl = phase_nccl_one_rank()
    print(f"nccl plane, one rank: allreduce and Adasum bit-exact against "
          f"the plain arithmetic, broadcast, allgather and alltoall "
          f"against their inputs' bits, entries {nccl}", flush=True)
    print(f"nccl plane at np=2 on one card refused: "
          f"{phase_nccl_np2_refused()}", flush=True)

    torch.cuda.empty_cache()
    reset_counts()
    np2 = phase_np2_resnet(card_line)
    print(f"np2 main path: 2 ranks x {NP2_STEPS} steps in "
          f"{np2['seconds']:.1f}s (launch included), parameters identical "
          f"across ranks after every step, applied gradients within "
          f"{np2['worst_grad_rel_rms']!r} relative RMS of the mean of the "
          f"local ones (limit {NP2_GRAD_REL_RMS}; the bf16-summed control "
          f"at least {np2['narrow_control_rel_rms']!r}); with the cache off "
          f"({np2['off_seconds']:.1f}s) the same parameters, bit for bit, "
          f"after every step [{card_line}]", flush=True)

    torch.cuda.empty_cache()
    reset_counts()
    bert2 = phase_np2_bert(card_line)
    print(f"np2 BERT: 2 ranks from per-rank seeds in {bert2['seconds']:.1f}s "
          f"(launch included); after the broadcasts every parameter and "
          f"optimizer-state tensor is rank 0's on both ranks (all "
          f"{BERT_PARAMS} + {3 * BERT_PARAMS} differed across the ranks "
          f"before); parameters "
          f"identical across ranks after steps 1 and 2; on rank 0's joined "
          f"step the applied gradient is within "
          f"{bert2['worst_grad_rel_rms']!r} of half its own (limit "
          f"{NP2_GRAD_REL_RMS}; unhalved control "
          f"{bert2['control_rel_rms']!r}); {bert2['evictions']} cache "
          f"evictions [{card_line}]", flush=True)

    torch.cuda.empty_cache()
    reset_counts()
    adasum2 = phase_np2_bert_adasum(card_line, bert2)
    print(f"np2 BERT Adasum: 2 ranks x {NP2_ADASUM_STEPS} steps in "
          f"{adasum2['seconds']:.1f}s (launch included), parameters "
          f"identical across ranks after every step, {BERT_PARAMS} tensors "
          f"through Adasum per step on each rank, {adasum2['launches']} "
          f"Adasum kernel launches; in step 1 the applied update is within "
          f"{adasum2['worst_rel_rms']!r} of the closed form of the two "
          f"local AdamW steps (limit {NP2_ADASUM_REL_RMS}; the plain "
          f"mean's control {adasum2['control_rel_rms']!r}; per tensor "
          f"{adasum2['control_per_tensor']}) [{card_line}]",
          flush=True)

    torch.cuda.empty_cache()
    windows = phase_adasum_windows(adasum2["windows"], card_line)
    print(f"adasum at the main path's windows: {len(windows['rows'])} "
          f"distinct windows held against the plain versions; per step "
          f"and rank {windows['ms']!r} ms of kernels (bound "
          f"{windows['bound_ms']!r}, {windows['bound_by']}), plain "
          f"{windows['plain_ms']!r} ms [{card_line}]", flush=True)

    stall = phase_np2_stall(card_line)
    print(f"np2 stall: every rank stopped with the stall text in "
          f"{stall['seconds']:.1f}s (launch included) [{card_line}]",
          flush=True)

    torch.cuda.empty_cache()
    graphs = [phase_graph(kind, card_line) for kind in ("resnet", "bert")]
    for g in graphs:
        same = "the same bits" if not g["differing_tensors"] else \
            f"within {g['worst_rel_rms']!r} relative RMS"
        print(f"graph step: {g['kind']} eager {g['eager_ms']:.2f} ms/step, "
              f"graph {g['graph_ms']:.2f} ms/step, eager/graph "
              f"{g['eager_over_graph']:.3f}; parameters after {GRAPH_STEPS} "
              f"steps {same}; kernels captured per step "
              f"{g['captured_per_step']} "
              f"(the wrappers count once, at capture; x {g['replays']} "
              f"replays = {g['launches_in_replays']}; the kernels line "
              f"below gives the eager main paths' counts); runtime "
              f"responses in the replays {g['responses_in_replays']} "
              f"[{card_line}]", flush=True)
    phase_value_and_grad(card_line)
    torch.cuda.empty_cache()
    overlap = phase_np2_overlap(card_line)
    print(f"np2 overlap: 2 ranks in {overlap['seconds']:.1f}s (launch "
          f"included); overlap=True within {overlap['rel_rms']} of "
          f"overlap=False (limit {OVERLAP_REL_RMS}); on the host plane "
          f"make_overlapped_train_step refused: {overlap['refusal']!r} "
          f"[{card_line}]", flush=True)

    torch.cuda.empty_cache()
    reset_counts()
    timelines = phase_timeline_np1(card_line)
    for t in timelines:
        print(f"timeline np=1: {t['kind']} off {t['off_ms']:.2f} ms/step, on "
              f"{t['on_ms']:.2f} ms/step, on/off {t['on_over_off']:.3f}; "
              f"{t['lanes']} lanes, {t['op_spans']} op spans in "
              f"{t['op_cycles']} cycles, critical_path {t['steps']} steps, "
              f"{t['trace_bytes']} bytes [{card_line}]", flush=True)
    torch.cuda.empty_cache()
    example = phase_example_np2(card_line)
    print(f"np2 example: {example['total']} ({example['seconds']:.1f}s with "
          f"the launch); critical_path ms per step over the gradients' "
          f"cycles {example['ms_per_step']}; phase_stats ms per step "
          f"{example['phase_stats_ms_per_step']} [{card_line}]", flush=True)

    torch.cuda.empty_cache()
    syncbn = phase_np2_syncbn(card_line, np2)
    print(f"np2 syncbn: 2 ranks x {SYNC_STEPS} synced steps and 1 control "
          f"step in {syncbn['seconds']:.1f}s (launch included), "
          f"{syncbn['launches']} B8 launches in the synced steps; against "
          f"the np=1 step the synced gradients within "
          f"{max(syncbn['errors']['True']['grad'].values())!r} (limit "
          f"{SYNC_GRAD_REL_RMS}) and the running statistics within "
          f"{max(syncbn['errors']['True']['stats'].values())!r} (limit "
          f"{SYNC_STATS_REL_RMS}), the control at "
          f"{max(syncbn['errors']['False']['grad'].values())!r} and "
          f"{max(syncbn['errors']['False']['stats'].values())!r} "
          f"[{card_line}]", flush=True)
    torch.cuda.empty_cache()
    ckpt = phase_checkpoint(card_line)
    print(f"checkpoint: {ckpt['mb']:.1f} MB snapshots, save "
          f"{[round(s, 3) for s in ckpt['save_s']]}s, restore_latest past a "
          f"corrupted newest {ckpt['restore_s']:.3f}s, the resumed step "
          f"bit-exact [{card_line}]", flush=True)

    torch.cuda.empty_cache()
    elastic = phase_elastic(card_line)
    for r in elastic["recovery"]:
        joiner = "" if "joiner_s" not in r else (
            "; the joiner, from the change: process started "
            f"{r['joiner_s']['process']:.3f}s, runtime up "
            f"{r['joiner_s']['init']:.3f}s, model built "
            f"{r['joiner_s']['model']:.3f}s, optimizer and state built "
            f"{r['joiner_s']['state']:.3f}s, synced (its state hashed) "
            f"{r['joiner_s']['synced']:.3f}s")
        print(f"elastic recovery: {r['change']} ({r['cause']}, epoch "
              f"{r['epoch']}): {r['total_s']:.3f}s from the change to the "
              f"end of the first step at the new size = notice "
              f"{r['notice_s']:.3f} + teardown {r['teardown_s']:.3f} + "
              f"waiting for the epoch {r['wait_epoch_s']:.3f} + group "
              f"build {r['group_build_s']:.3f} + state sync "
              f"{r['sync_s']:.3f} + the phase's checks "
              f"{r['checks_s']:.3f} + first step {r['first_step_s']:.3f}"
              f"{joiner} [{card_line}]", flush=True)
    print(f"elastic: np=2 ResNet-50 shrunk, grown and killed in "
          f"{elastic['seconds']:.1f}s (launch included), sizes 2, 1, 2, 1; "
          f"{elastic['launches']} B8 launches, 36 per step on every rank; "
          f"the first size-1 step the bits of a step without the runtime; "
          f"the survivor resumed at its last commit's hash; ms per step "
          f"at size 1 {[round(v, 1) for v in elastic['ms'][1]]}, at size 2 "
          f"{[round(v, 1) for v in elastic['ms'][2]]} [{card_line}]",
          flush=True)

    torch.cuda.empty_cache()
    outage = phase_outage(card_line)
    sh = outage["shrink"]
    print(f"outage: np=2 elastic ResNet-50 through the supervised "
          f"rendezvous server in {outage['seconds']:.1f}s (launch "
          f"included): the server SIGKILLed and down "
          f"{outage['outage_s']:.3f}s, restarted on its port over its "
          f"journal (JR_REPLAY {outage['replay_ms']:.3f} ms), no epoch "
          f"change for it, renewals failed and no worker shed, then a "
          f"shrink at the replayed epoch + 1; {outage['launches']} B8 "
          f"launches in {outage['steps']} steps, 36 per step; ms per step "
          f"before the kill {outage['ms_before']}, while down "
          f"{outage['ms_across']}, after the restart {outage['ms_after']} "
          f"[{card_line}]", flush=True)
    print(f"outage shrink: {sh['total_s']:.3f}s from the hosts file's "
          f"change to the end of the first step at size 1 = notice "
          f"{sh['notice_s']:.3f} + teardown {sh['teardown_s']:.3f} + "
          f"waiting for the epoch {sh['wait_epoch_s']:.3f} + group build "
          f"{sh['group_build_s']:.3f} + state sync {sh['sync_s']:.3f} + "
          f"first step {sh['first_step_s']:.3f}; the driver's CHURN_EVENT "
          f"{outage['churn_ms']:.3f} ms, by control_path "
          f"{ {k: round(v, 3) for k, v in outage['churn_phases_ms'].items()} } "
          f"+ unattributed {outage['churn_unattributed_ms']:.3f} ms "
          f"(coverage {outage['coverage']}); journal "
          f"{outage['journal_bytes']} bytes, {outage['writes_per_s']:.2f} "
          f"durable writes/s after the restart, JR_FSYNC "
          f"{outage['fsync_ms']:.3f} ms each [{card_line}]", flush=True)

    timed = [r for r in rows if "ms" in r]

    def per_step(key):
        return sum(r[key] * r["launches_per_step"] for r in timed)

    ops_ms, bytes_ms = per_step("ops_ms"), per_step("bytes_ms")
    summary = {"kernels": [{
        "name": "matmul_bn_stats",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/matmul_bn_stats.cu",
        "replaces": "horovod_tpu/kernels/conv_bn_stats.py:90",
        # The np=1 main path's, phase 21's synced steps' on both ranks and
        # phases 23's and 24's elastic steps' on every process.
        "launches": launches + syncbn["launches"] + elastic["launches"]
        + outage["launches"],
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
    # Per np=2 step and rank: the triplets and the combine over each of
    # the rank's windows of phase 13, summed.
    summary["kernels"].append({
        "name": "adasum", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/adasum.cu",
        "replaces": "horovod_tpu/backend/xla.py:346, "
                    "horovod_tpu/backend/adasum.py:68",
        "launches": adasum2["launches"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in adasum_rows + windows["rows"]),
        "ms": windows["ms"], "plain_ms": windows["plain_ms"],
        "bound_ms": windows["bound_ms"], "bound_by": windows["bound_by"],
        # No one PyTorch call computes a per-entry Adasum.
        "library_ms": None,
    })
    print(card_line, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
