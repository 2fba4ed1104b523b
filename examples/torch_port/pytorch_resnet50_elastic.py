"""Elastic ResNet-50 training on ``horovod_tpu_torch`` (the torch port's
version of ``examples/elastic/tensorflow2_resnet50_elastic.py``, BASELINE
config 5: ResNet-50 on preemptible capacity).

Synthetic ImageNet-shaped data from a per-rank seed; the model, the
optimizer and the batch count commit every ``--commit-every`` batches, so
that a host that leaves or dies costs at most that much recomputation, and
the job resizes between ``--min-np`` and the discovered capacity.  The
default model is a small stand-in with the same plumbing (the port's
ResNet with one bottleneck block per stage, 64x64 images); ``--full-resnet``
trains the real ResNet-50 at 224x224 with ``fuse_conv1x1_bn=True``.  It
runs on the rank's card by default; ``--device cpu`` on the CPU, ``--device
cuda:0`` puts every rank on one card.

Run::

    echo 'echo localhost:2' > discover.sh && chmod +x discover.sh
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 \\
        --host-discovery-script ./discover.sh \\
        python examples/torch_port/pytorch_resnet50_elastic.py
"""

import argparse

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.training import cross_entropy_loss


def build_model(full: bool) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(0)
    if full:
        return resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                               fuse_conv1x1_bn=True, generator=gen)
    # A CI-sized stand-in with the same training plumbing.
    return resnet.ResNet(stage_sizes=[1, 1, 1, 1],
                         block_cls=resnet.BottleneckBlock, num_classes=1000,
                         num_filters=8, dtype=torch.float32,
                         fuse_conv1x1_bn=True, generator=gen)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--commit-every", type=int, default=10)
    p.add_argument("--base-lr", type=float, default=0.001)
    p.add_argument("--full-resnet", action="store_true",
                   help="real ResNet-50 at 224x224 (default: small model)")
    p.add_argument("--device", default=None,
                   help="cpu, cuda:N, or the rank's card (default)")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()
    size = 224 if args.full_resnet else args.image_size
    model = build_model(args.full_resnet).to(dev)
    inner = torch.optim.SGD(model.parameters(), lr=args.base_lr * hvd.size(),
                            momentum=0.9)
    opt = hvd.DistributedOptimizer(inner,
                                   named_parameters=model.named_parameters())

    # TorchState snapshots the model and the optimizer on every commit and
    # broadcasts them after a reset (reference torch/elastic/state.py).
    state = hvd.elastic.TorchState(model, opt, batch=0)

    def train_batch() -> float:
        gen = torch.Generator(device=dev).manual_seed(
            1234 + 1000 * state.batch + hvd.rank())
        x = torch.randn(args.batch_size, size, size, 3, device=dev,
                        generator=gen)
        y = torch.randint(0, 1000, (args.batch_size,), device=dev,
                          generator=gen)
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(x), y)
        loss.backward()
        opt.step()
        return float(loss)

    @hvd.elastic.run
    def train(state):
        # Entered again after every reset: the learning rate follows the
        # live world's size (the linear scaling rule).
        for group in inner.param_groups:
            group["lr"] = args.base_lr * hvd.size()
        while state.batch < args.batches:
            loss = train_batch()
            state.batch += 1
            if state.batch % args.commit_every == 0:
                state.commit()
                if hvd.rank() == 0:
                    print(f"batch {state.batch} size={hvd.size()} "
                          f"loss={loss:.4f}", flush=True)

    train(state)
    if hvd.rank() == 0:
        print("ELASTIC RESNET DONE", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
