"""Adasum BERT pretraining on ``horovod_tpu_torch`` (the torch port's
version of ``examples/adasum/adasum_bert_pretraining.py``, BASELINE config
4).

Masked-LM pretraining on synthetic token streams with the port's
Transformer (``--bert-large`` selects the real 24-layer, 1024-wide
config; the default is a small model with the same code paths;
``--num-layers`` and ``--seq-len`` cut either) and
``hvd.DistributedOptimizer(AdamW, op=hvd.Adasum)``: each rank steps
locally and the parameter deltas merge with the scale-insensitive Adasum
operator.  Rank 0's initial weights are broadcast; each rank draws its
own tokens from its own seed (``42 + rank``).

Run::

    python -m horovod_tpu_torch.runner.launch -np 2 \\
        python examples/torch_port/adasum_bert_pretraining.py
"""

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import (
    Transformer,
    bert_large_config,
    tiny_config,
)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--num-layers", type=int, default=None,
                   help="layers (default: the config's own)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--bert-large", action="store_true",
                   help="full BERT-large config (needs the card)")
    p.add_argument("--device", default=None,
                   help="cpu, cuda:N, or the rank's card (default)")
    args = p.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()

    overrides = {"max_len": args.seq_len, "causal": False}
    if args.num_layers is not None:
        overrides["num_layers"] = args.num_layers
    cfg = bert_large_config(**overrides) if args.bert_large \
        else tiny_config(**overrides)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0)) \
        .to(dev)
    mask_id = cfg.vocab_size - 1
    rng = np.random.RandomState(42 + hvd.rank())
    # Rank 0's weights are canonical (the reference broadcast idiom).
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=args.lr),
        named_parameters=model.named_parameters(), op=hvd.Adasum)

    for step in range(args.steps):
        tokens = rng.randint(0, cfg.vocab_size - 1,
                             (args.batch_size, args.seq_len))
        mask = rng.rand(args.batch_size, args.seq_len) < args.mask_prob
        masked = torch.from_numpy(np.where(mask, mask_id, tokens)).to(dev)
        targets = torch.from_numpy(tokens).to(dev)
        weight = torch.from_numpy(mask.astype(np.float32)).to(dev)
        opt.zero_grad()
        logits = model(masked).float()
        ll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
            reduction="none").reshape(targets.shape)
        loss = (ll * weight).sum() / weight.sum().clamp(min=1)
        loss.backward()
        opt.step()
        if hvd.rank() == 0 and step % 5 == 0:
            print(f"step {step}: mlm_loss {loss.item():.4f}", flush=True)

    if hvd.rank() == 0:
        print("ADASUM BERT DONE", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
