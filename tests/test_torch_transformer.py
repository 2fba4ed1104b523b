"""The port's transformer against the flax ``Transformer``, and two AdamW
steps through the port's runtime against the JAX package's train step.

Weights come from flax's init and are carried across by
``horovod_tpu_torch.convert.from_flax``; tokens are numpy.  On the CPU the
port's attention takes the plain versions of its flash-attention kernels,
the flax model its einsum path.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (matmuls, softmax and LayerNorm
sums in another order; two AdamW steps carry those roundings into the
parameters).  bf16 logits within 1e-2 relative RMS: both sides round
activations to bf16 after every Dense, the GELU and the attention, but XLA
and PyTorch may round at different places inside a fused elementwise chain.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jax_transformer
from horovod_tpu.models.training import (
    create_train_state,
    make_sharded_train_step,
)
from horovod_tpu_torch.backend import cuda as cuda_backend
from horovod_tpu_torch.convert import from_flax
from horovod_tpu_torch.kernels import flash_attention as fa
from horovod_tpu_torch.models import transformer
from horovod_tpu_torch.models.training import train_step

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-3
WEIGHT_DECAY = 1e-4   # optax.adamw's default; torch.optim.AdamW's is 1e-2
BF16_LOGITS_REL_RMS = 1e-2
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def runtime():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, batch=2, seq=16, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _pair(dtype="float32", **overrides):
    """The flax model, its params as numpy, and the port's model loaded from
    them."""
    jdt, tdt = _DTYPES[dtype]
    jcfg = jax_transformer.tiny_config(dtype=jdt, **overrides)
    jmodel = jax_transformer.Transformer(jcfg)
    tokens = _tokens(jcfg)
    boxed = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    model = transformer.Transformer(transformer.tiny_config(dtype=tdt,
                                                            **overrides))
    model.load_state_dict(from_flax(boxed))
    return jmodel, boxed, model, tokens


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_flax(dtype, causal):
    jmodel, boxed, model, tokens = _pair(dtype, causal=causal)
    expected = np.asarray(jmodel.apply({"params": boxed}, jnp.asarray(tokens))
                          .astype(jnp.float32))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert logits.dtype == _DTYPES[dtype][1]  # the readout is in cfg.dtype
    got = logits.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, expected, **TOL)
    else:
        rel = np.linalg.norm(got - expected) / np.linalg.norm(expected)
        assert rel < BF16_LOGITS_REL_RMS, rel


@pytest.mark.parametrize("causal", [True, False])
def test_two_adamw_steps_match_jax_train_step(runtime, causal):
    """``{'x': tokens, 'y': tokens}`` as ``benchmarks/bert_bench.py`` feeds
    BERT; every gradient goes through the runtime's allreduce."""
    _two_adamw_steps(causal, "flash")


def _two_adamw_steps(causal: bool, attention_impl: str) -> None:
    jcfg = jax_transformer.tiny_config(dtype=jnp.float32, causal=causal)
    jmodel = jax_transformer.Transformer(jcfg)
    tokens = _tokens(jcfg, seed=1)
    tx = optax.adamw(LR, weight_decay=WEIGHT_DECAY)
    state = create_train_state(jmodel, jax.random.PRNGKey(1),
                               jnp.asarray(tokens), tx)
    step = make_sharded_train_step(jmodel, tx, mesh=None, donate=False,
                                   model_kwargs={})

    model = transformer.Transformer(transformer.tiny_config(
        dtype=torch.float32, causal=causal, attention_impl=attention_impl))
    model.load_state_dict(from_flax(_numpy_tree(state.params)))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR,
                          weight_decay=WEIGHT_DECAY),
        named_parameters=model.named_parameters())
    n_params = len(list(model.parameters()))
    batch_j = {"x": jnp.asarray(tokens), "y": jnp.asarray(tokens)}
    t = torch.from_numpy(tokens).long()
    batch_t = {"x": t, "y": t}
    before = cuda_backend.stats["allreduce_tensors"]
    for i in range(2):
        state, loss_j = step(state, batch_j)
        loss_t = train_step(model, opt, batch_t)
        np.testing.assert_allclose(loss_t.item(), float(loss_j),
                                   err_msg=f"loss at step {i}", **TOL)
    # The tied embedding is one parameter: its hook fires once per step.
    assert cuda_backend.stats["allreduce_tensors"] - before == 2 * n_params
    expected = from_flax(_numpy_tree(state.params))
    got = model.state_dict()
    assert set(got) == set(expected)
    for key, value in expected.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=key, **TOL)


def test_from_flax_keys_equal_state_dict_and_keep_dense_layout():
    """Boxed (``nn.Partitioned``) params convert as they are; Dense kernels
    keep ``[in, out]``."""
    _, boxed, model, _ = _pair()
    state = from_flax(boxed)
    assert set(state) == set(model.state_dict())
    assert tuple(state["layer_0.attn.qkv.kernel"].shape) == (32, 96)
    assert tuple(state["layer_1.ffn_out.kernel"].shape) == (64, 32)
    assert tuple(state["embed.embedding"].shape) == (128, 32)
    np.testing.assert_array_equal(
        state["layer_0.attn.out.kernel"].numpy(),
        np.asarray(boxed["layer_0"]["attn"]["out"]["kernel"].unbox()))


def test_remat_matches_no_remat():
    gen = torch.Generator().manual_seed(2)
    plain = transformer.Transformer(
        transformer.tiny_config(dtype=torch.float32), generator=gen)
    remat = transformer.Transformer(
        transformer.tiny_config(dtype=torch.float32, remat=True))
    remat.load_state_dict(plain.state_dict())
    tokens = torch.from_numpy(_tokens(plain.cfg, seed=2)).long()
    for m in (plain, remat):
        m(tokens).float().square().mean().backward()
    for (name, a), (_, b) in zip(plain.named_parameters(),
                                 remat.named_parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=0,
                                   msg=name)


def test_bert_large_on_meta_device():
    """Full-width BERT-large, shapes only: ≈334M parameters
    (``benchmarks/scaling_model.py``), 292 parameter tensors, 24 attention
    modules (one launch of each flash kernel per step each)."""
    with torch.device("meta"):
        model = transformer.Transformer(transformer.bert_large_config())
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == 334_090_240
    assert len(params) == 292
    assert sum(isinstance(m, transformer.Attention)
               for m in model.modules()) == 24


@pytest.mark.parametrize("preset", ["bert_large_config", "gpt_small_config",
                                    "tiny_config"])
def test_presets_match_jax(preset):
    ours = dataclasses.asdict(getattr(transformer, preset)())
    theirs = dataclasses.asdict(getattr(jax_transformer, preset)())
    assert ours.pop("dtype") == torch.bfloat16
    assert theirs.pop("dtype") == jnp.bfloat16
    # The port's explicit choice of attention path; the flax model has its
    # einsum by default and the Pallas kernel behind an environment knob.
    assert ours.pop("attention_impl") == "flash"
    assert ours == theirs


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sequence_parallel_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="queue A, item 9"):
        transformer.Transformer(transformer.tiny_config(attention=mode))



# ---------------------------------------------------------------------------
# attention_impl: the explicit plain path on the card (fault C1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_einsum_attention_logits_match_flax(dtype, causal):
    """``attention_impl="einsum"`` is the reference's own default path: any
    dtype, any head_dim (``tiny_config`` has head_dim 8)."""
    jmodel, boxed, flash_model, tokens = _pair(dtype, causal=causal)
    model = transformer.Transformer(transformer.tiny_config(
        dtype=_DTYPES[dtype][1], causal=causal, attention_impl="einsum"))
    model.load_state_dict(flash_model.state_dict())
    assert model.cfg.head_dim == 8
    expected = np.asarray(jmodel.apply({"params": boxed}, jnp.asarray(tokens))
                          .astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, expected, **TOL)
    else:
        rel = np.linalg.norm(got - expected) / np.linalg.norm(expected)
        assert rel < BF16_LOGITS_REL_RMS, rel


@pytest.mark.parametrize("causal", [True, False])
def test_einsum_attention_two_adamw_steps_match_jax_train_step(runtime,
                                                               causal):
    """The fp32 configuration through the einsum path: losses and
    parameters after two steps equal the JAX train step's."""
    _two_adamw_steps(causal, "einsum")


def test_flash_refuses_on_the_card_what_its_kernels_do_not_take():
    """Off the CPU, ``"flash"`` with a dtype or head_dim the kernels do not
    take raises and names ``attention_impl="einsum"``; nothing switches on
    its own.  (``meta`` tensors take the path a CUDA tensor takes.)"""
    hint = 'attention_impl="einsum"'
    head_dim_8 = torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16)
    fp32 = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match=hint):
        fa._check(head_dim_8, head_dim_8, head_dim_8)
    with pytest.raises(TypeError, match=hint):
        fa._check(fp32, fp32, fp32)
    for t in (head_dim_8.to("meta"), fp32.to("meta")):
        with pytest.raises((TypeError, ValueError), match=hint):
            fa.flash_attention(t, t, t, causal=True)
    cfg = transformer.tiny_config(dtype=torch.float32)
    x = torch.zeros(2, 4, cfg.d_model, device="meta")
    with torch.device("meta"):
        flash = transformer.Attention(cfg)
        einsum = transformer.Attention(dataclasses.replace(
            cfg, attention_impl="einsum"))
    with pytest.raises(TypeError, match=hint):
        flash(x)
    assert einsum(x).shape == (2, 4, cfg.d_model)


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError, match="attention_impl"):
        transformer.Attention(transformer.tiny_config(attention_impl="sdpa"))
