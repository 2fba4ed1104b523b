"""Transformer encoder/decoder, BERT-large and GPT presets, in PyTorch.

Counterpart of ``horovod_tpu/models/transformer.py``.  Token ids
``[batch, seq]`` → logits ``[batch, seq, vocab]``.  fp32 parameters,
``cfg.dtype`` compute (bf16 on the card).  Submodules carry the flax
module's names (``embed.embedding``, ``pos_embed``,
``layer_{i}.attn.qkv.kernel``, ``layer_{i}.ln1.scale`` ... ``ln_f``), so
that :func:`horovod_tpu_torch.convert.from_flax` maps parameters one to one.
``Dense`` kernels keep flax's ``[in, out]`` layout.

Where torch's defaults differ from flax's, this module does what flax does:

- LayerNorm: ``epsilon=1e-6``, the one-pass variance ``E[x²] − E[x]²``
  clipped at 0, statistics and output in fp32 (the next ``Dense`` casts);
- GELU: the tanh approximation (flax's ``nn.gelu`` default);
- the residual stream is in ``cfg.dtype``: the embedding is looked up in
  ``cfg.dtype`` and the position embedding cast to it before the sum;
- the weight-tied readout computes in ``cfg.dtype`` (flax's
  ``Embed.attend`` promotes both operands to the module's dtype), so the
  logits are bf16 on the card; the loss widens them to fp32.

Attention ``"full"`` has two implementations, chosen explicitly by
``cfg.attention_impl``:

- ``"flash"`` (the default):
  :func:`~horovod_tpu_torch.kernels.flash_attention.flash_attention`, the
  CUDA kernels on the card (bf16, head_dim 64 or 128; anything else raises
  and names ``"einsum"``), their plain versions on the CPU;
- ``"einsum"``: :func:`attention_einsum`, the reference's own default path
  (``horovod_tpu/models/transformer.py:138-146``) in plain torch, for any
  dtype and head_dim on either device.

Nothing switches between them on its own.  The sequence-parallel modes
(``"ring"``, ``"ulysses"``) arrive with the ``parallel/`` slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention

# Mesh axis names of horovod_tpu/parallel/mesh.py (AXIS_SEQ, AXIS_MODEL).
AXIS_SEQ = "seq"
AXIS_MODEL = "model"

_INIT_STD = 0.02
_LN_EPSILON = 1e-6


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_len: int = 512
    causal: bool = True               # decoder (GPT); False = encoder (BERT)
    attention: str = "full"           # full | ring | ulysses
    seq_axis: str = AXIS_SEQ
    model_axis: str = AXIS_MODEL
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    attention_impl: str = "flash"     # flash | einsum

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def bert_large_config(**overrides) -> TransformerConfig:
    """BERT-large (the reference's Adasum pretraining benchmark model)."""
    return TransformerConfig(**{**dict(
        vocab_size=30522, num_layers=24, num_heads=16, d_model=1024,
        d_ff=4096, max_len=512, causal=False), **overrides})


def gpt_small_config(**overrides) -> TransformerConfig:
    return TransformerConfig(**{**dict(
        vocab_size=50257, num_layers=12, num_heads=12, d_model=768,
        d_ff=3072, max_len=1024, causal=True), **overrides})


def tiny_config(**overrides) -> TransformerConfig:
    """For tests: tiny shapes, same code paths."""
    return TransformerConfig(**{**dict(
        vocab_size=128, num_layers=2, num_heads=4, d_model=32,
        d_ff=64, max_len=64, causal=True), **overrides})


def _normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``initializers.normal(0.02)`` in fp32."""
    return torch.empty(shape).normal_(0.0, _INIT_STD, generator=generator)


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ kernel + bias`` in ``dtype``, kernel
    ``[in, out]``, fp32 parameters."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(_normal((in_features, features), generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=float32)``: fp32 one-pass statistics,
    ``epsilon=1e-6``, fp32 output."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + _LN_EPSILON) * self.scale) \
            + self.bias


def attention_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, sm_scale: float) -> torch.Tensor:
    """The reference's einsum attention over ``[b, s, h, d]``: fp32 scores,
    scaled; a ``-inf`` causal mask; softmax; probabilities cast to
    ``q.dtype``; the product with ``v`` in ``q.dtype``."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))      # [b, h, s, d]
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        * sm_scale
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


_ATTENTION_IMPLS = {"flash": flash_attention, "einsum": attention_einsum}


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.attention_impl not in _ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}; "
                             f"expected one of {sorted(_ATTENTION_IMPLS)}")
        if cfg.attention in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention={cfg.attention!r} (sequence parallelism) arrives "
                "with the parallel/ slice of the port (ROADMAP.md, queue A, "
                "item 9)")
        if cfg.attention != "full":
            raise ValueError(f"unknown attention mode {cfg.attention!r}")
        self.cfg = cfg
        h, dh = cfg.num_heads, cfg.head_dim
        self.qkv = Dense(cfg.d_model, 3 * h * dh, cfg.dtype, generator)
        self.out = Dense(h * dh, cfg.d_model, cfg.dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        h, dh = cfg.num_heads, cfg.head_dim
        # [b, s, 3h, dh] split on the head axis: q is features [0, h·dh),
        # then k, then v.  Strided views: the kernels read them in place.
        q, k, v = self.qkv(x).view(b, s, 3 * h, dh).split(h, dim=2)
        out = _ATTENTION_IMPLS[cfg.attention_impl](q, k, v, cfg.causal,
                                                   dh ** -0.5)
        return self.out(out.reshape(b, s, h * dh))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model)
        self.attn = Attention(cfg, generator)
        self.ln2 = LayerNorm(cfg.d_model)
        self.ffn_in = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, generator)
        self.ffn_out = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.ffn_in(self.ln2(x)), approximate="tanh")
        return x + self.ffn_out(y)


class Embed(nn.Module):
    """``flax.linen.Embed``'s parameter: ``embedding`` ``[vocab, d]``."""

    def __init__(self, vocab_size: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = nn.Parameter(_normal((vocab_size, features),
                                              generator))


class Transformer(nn.Module):
    """Token ids ``[batch, seq]`` → logits ``[batch, seq, vocab]`` in
    ``cfg.dtype``."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, generator)
        self.pos_embed = nn.Parameter(_normal((cfg.max_len, cfg.d_model),
                                              generator))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", Block(cfg, generator))
        self.ln_f = LayerNorm(cfg.d_model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        s = tokens.shape[1]
        # One cast serves the lookup and the tied readout, as in flax.
        table = self.embed.embedding.to(cfg.dtype)
        x = F.embedding(tokens, table) + self.pos_embed[:s].to(cfg.dtype)
        for i in range(cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if cfg.remat:
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.ln_f(x).to(cfg.dtype) @ table.t()


__all__ = ["TransformerConfig", "bert_large_config", "gpt_small_config",
           "tiny_config", "Dense", "LayerNorm", "attention_einsum",
           "Attention", "Block", "Embed", "Transformer"]
