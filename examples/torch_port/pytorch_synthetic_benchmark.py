"""Synthetic ResNet-50 benchmark on ``horovod_tpu_torch`` (the torch
port's version of ``examples/pytorch/pytorch_synthetic_benchmark.py``).

The model is the port's ResNet-50 v1.5 (``horovod_tpu_torch/models/
resnet.py``, bf16, ``fuse_conv1x1_bn=True``, so the 1x1 convolutions run
the hand-written matmul + BatchNorm-statistics kernel on the card), not
torchvision's.  The same flags and the same img/sec lines as the
reference's script; ``--device cpu`` runs it on the CPU, ``--device
cuda:0`` puts every rank on one card, and the default is the rank's own
card.

Run::

    python -m horovod_tpu_torch.runner.launch -np 2 \\
        python examples/torch_port/pytorch_synthetic_benchmark.py --num-iters 3
"""

import argparse
import timeit

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.training import cross_entropy_loss


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="resnet50", choices=["resnet50"])
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--num-batches-per-iter", type=int, default=3)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--fp16-allreduce", action="store_true")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--device", default=None,
                        help="cpu, cuda:N, or the rank's card (default)")
    args = parser.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()

    model = resnet.ResNet50(
        num_classes=1000, dtype=torch.bfloat16, fuse_conv1x1_bn=True,
        generator=torch.Generator().manual_seed(1234 + hvd.rank())).to(dev)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size())

    compression = hvd.Compression.fp16 if args.fp16_allreduce \
        else hvd.Compression.none
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression)

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    gen = torch.Generator(device=dev).manual_seed(1234 + hvd.rank())
    # The port's ResNet takes NHWC images.
    data = torch.randn(args.batch_size, args.image_size, args.image_size, 3,
                       device=dev, generator=gen)
    target = torch.randint(0, 1000, (args.batch_size,), device=dev,
                           generator=gen)

    def benchmark_step():
        optimizer.zero_grad()
        loss = cross_entropy_loss(model(data), target)
        loss.backward()
        optimizer.step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def log(s):
        if hvd.rank() == 0:
            print(s, flush=True)

    log(f"Model: {args.model}, batch size {args.batch_size}, "
        f"ranks {hvd.size()}")
    for _ in range(args.num_warmup_batches):
        benchmark_step()

    img_secs = []
    for i in range(args.num_iters):
        t = timeit.timeit(benchmark_step, number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / t
        log(f"Iter #{i}: {img_sec:.1f} img/sec per rank")
        img_secs.append(img_sec)

    img_sec_mean = sum(img_secs) / len(img_secs)
    total = hvd.allreduce(torch.tensor([img_sec_mean], dtype=torch.float64),
                          op=hvd.Sum, name="imgsec")[0].item()
    log(f"Img/sec per rank: {img_sec_mean:.1f}")
    log(f"Total img/sec on {hvd.size()} rank(s): {total:.1f}")

    hvd.shutdown()


if __name__ == "__main__":
    main()
