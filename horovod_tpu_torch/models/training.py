"""Loss and one training step through the port's DistributedOptimizer.

Counterpart of ``horovod_tpu/models/training.py`` (``cross_entropy_loss``,
the step of ``make_sharded_train_step``) in eager PyTorch: forward, loss,
backward — during which the optimizer's hooks enqueue each gradient's
allreduce — then ``optimizer.step()``, which synchronizes and updates.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy in fp32; ``[..., C]`` logits, ``[...]``
    integer labels."""
    logits = logits.float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def train_step(model: torch.nn.Module, optimizer,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One step on ``batch = {'x': inputs, 'y': integer labels}``; returns
    the loss (detached, on the model's device).  For the transformer, ``x``
    is ``[b, s]`` token ids and ``y`` the ``[b, s]`` labels (the tokens
    themselves in ``chip_smoke.py``, as in ``benchmarks/bert_bench.py``)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(batch["x"]), batch["y"])
    loss.backward()
    optimizer.step()
    return loss.detach()
