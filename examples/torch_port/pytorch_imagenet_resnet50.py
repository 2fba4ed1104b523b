"""ImageNet-style ResNet-50 training on ``horovod_tpu_torch`` (the torch
port's version of ``examples/pytorch/pytorch_imagenet_resnet50.py``,
BASELINE config 3), on its synthetic path: rank-seeded random batches, no
dataset and no torchvision.

The reference recipe: ``DistributedOptimizer`` with its gradient hooks,
linear learning-rate scaling with warm-up, resume on rank 0 fanned out
through ``broadcast_object`` (the epoch), ``broadcast_parameters`` and
``broadcast_optimizer_state``, metrics averaged by an allreduce, and rank
0 alone saving a checkpoint (``torch.save``) after each epoch.

Run::

    python -m horovod_tpu_torch.runner.launch -np 2 \\
        python examples/torch_port/pytorch_imagenet_resnet50.py --epochs 2
"""

import argparse
import os

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.training import cross_entropy_loss


def make_loader(args, dev):
    """Fixed random batches, seeded per rank (the reference's synthetic
    fallback)."""
    g = torch.Generator(device=dev).manual_seed(1234 + hvd.rank())
    return [(torch.randn(args.batch_size, args.image_size, args.image_size,
                         3, device=dev, generator=g),
             torch.randint(0, 1000, (args.batch_size,), device=dev,
                           generator=g))
            for _ in range(args.synthetic_batches)]


def adjust_lr(optimizer, epoch, batch_idx, loader_len, args):
    """Linear scaling with warm-up (reference pytorch_imagenet_resnet50.py)."""
    if epoch < args.warmup_epochs:
        progress = (batch_idx + 1 + epoch * loader_len) / \
            (args.warmup_epochs * loader_len)
        lr_adj = progress * (hvd.size() - 1) / hvd.size() + 1 / hvd.size()
    else:
        lr_adj = 10 ** (-sum(epoch >= e for e in (30, 60, 80)))
    for group in optimizer.param_groups:
        group["lr"] = args.base_lr * hvd.size() * lr_adj


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50", choices=["resnet50"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--base-lr", type=float, default=0.0125)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=5e-5)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--synthetic-batches", type=int, default=8)
    p.add_argument("--fp16-allreduce", action="store_true")
    p.add_argument("--checkpoint-format",
                   default="checkpoint-{epoch}.pth.tar")
    p.add_argument("--device", default=None,
                   help="cpu, cuda:N, or the rank's card (default)")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()

    model = resnet.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
        generator=torch.Generator().manual_seed(1234 + hvd.rank())).to(dev)
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=args.base_lr * hvd.size(),
                                momentum=args.momentum,
                                weight_decay=args.wd)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=(hvd.Compression.fp16 if args.fp16_allreduce
                     else hvd.Compression.none))

    # Resume from a checkpoint on rank 0, then fan out (reference idiom).
    resume_epoch = 0
    if hvd.rank() == 0:
        for epoch in range(args.epochs, 0, -1):
            path = args.checkpoint_format.format(epoch=epoch)
            if os.path.exists(path):
                ckpt = torch.load(path, map_location=dev, weights_only=True)
                model.load_state_dict(ckpt["model"])
                optimizer.load_state_dict(ckpt["optimizer"])
                resume_epoch = epoch
                break
    resume_epoch = int(hvd.broadcast_object(resume_epoch, 0,
                                            name="resume_epoch"))
    if resume_epoch and hvd.rank() != 0:
        # Every rank must hold the state tensors rank 0 restored before
        # they are broadcast: one zero-gradient step makes them (the
        # reference's functions.py:62-90 does the same); the broadcasts
        # overwrite its effect.
        for param in model.parameters():
            param.grad = torch.zeros_like(param)
        optimizer.step()
        optimizer.zero_grad()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)
    if hvd.rank() == 0:
        print(f"resumed from epoch {resume_epoch}", flush=True)

    loader = make_loader(args, dev)
    for epoch in range(resume_epoch, args.epochs):
        model.train()
        epoch_loss, epoch_acc, seen = 0.0, 0.0, 0
        for batch_idx, (data, target) in enumerate(loader):
            adjust_lr(optimizer, epoch, batch_idx, len(loader), args)
            optimizer.zero_grad()
            output = model(data)
            loss = cross_entropy_loss(output, target)
            loss.backward()
            optimizer.step()
            epoch_loss += loss.item() * len(target)
            epoch_acc += (output.argmax(1) == target).float().sum().item()
            seen += len(target)

        # Metrics averaged across ranks (the reference's Metric class).
        loss_avg, acc_avg = hvd.allreduce(
            torch.tensor([epoch_loss / seen, epoch_acc / seen],
                         dtype=torch.float64),
            op=hvd.Average, name=f"metrics.{epoch}").tolist()
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {loss_avg:.4f} "
                  f"acc {acc_avg:.4f}", flush=True)
            torch.save({"model": model.state_dict(),
                        "optimizer": optimizer.state_dict()},
                       args.checkpoint_format.format(epoch=epoch + 1))
    if hvd.rank() == 0:
        print(f"trained epochs {resume_epoch}..{args.epochs - 1}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
