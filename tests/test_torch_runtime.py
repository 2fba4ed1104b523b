"""The port's runtime at np=1 against the JAX package's.

Each case feeds the same numpy values through ``horovod_tpu_torch`` (on the
CPU: ``hvd.init(device="cpu")``) and through ``horovod_tpu``'s eager ops or
DistributedOptimizer, and compares the results.  The arithmetic is the same
on both sides (widen 16-bit floats to fp32, multiply by prescale·postscale,
cast back), so the results are bit-equal unless stated.

Also here: the guard that the port, its tools, its examples
(``examples/torch_port/``) and ``chip_smoke.py`` load neither JAX nor
``horovod_tpu`` (in a subprocess, because this test process imports JAX),
and the entry points' refusals.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import horovod_tpu.torch as jax_torch
import horovod_tpu_torch as hvd
from horovod_tpu.common.topology import ProcessTopology as JaxTopology
from horovod_tpu.core import controller as jax_controller
from horovod_tpu.core import messages as jax_messages
from horovod_tpu.core import state as jax_state
from horovod_tpu.frameworks.jax import basics as jax_basics
from horovod_tpu.frameworks.jax import ops as jax_ops
from horovod_tpu.frameworks.jax.compression import Compression as JaxCompression
from horovod_tpu.frameworks.jax.optimizer import (
    DistributedOptimizer as JaxDistributedOptimizer,
)
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core import controller, messages

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent

_NP_DTYPES = {"float32": np.float32, "float16": np.float16,
              "bfloat16": ml_dtypes.bfloat16, "int32": np.int32}
_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "int32": torch.int32}


@pytest.fixture(scope="module")
def runtimes():
    jax_state.reset_global_state()
    jax_basics.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    jax_state.reset_global_state()


def _values(dtype: str, seed: int = 0, n: int = 37) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return rng.randint(-50, 50, size=n).astype(np.int32)
    return (rng.randn(n) * 3).astype(np.float32).astype(_NP_DTYPES[dtype])


def _to_torch(values: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(values.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(values.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype,op,prescale,postscale", [
    ("float32", "sum", 1.0, 1.0),
    ("float32", "average", 0.5, 3.0),
    ("bfloat16", "sum", 0.3, 1.7),       # widened to fp32, cast back
    ("float16", "average", 1.0, 0.3),
    ("int32", "sum", 2.0, 1.0),
])
def test_allreduce_matches_jax_ops(runtimes, dtype, op, prescale, postscale):
    values = _values(dtype)
    expected = np.asarray(jax_ops.allreduce(
        jnp.asarray(values), op=op, prescale_factor=prescale,
        postscale_factor=postscale, name=f"jax.{dtype}.{op}.{prescale}"))
    tensor = _to_torch(values, dtype)
    out = hvd.allreduce(tensor, op=op, prescale_factor=prescale,
                        postscale_factor=postscale)
    assert out.dtype == _TORCH_DTYPES[dtype]
    assert out is not tensor
    assert torch.equal(tensor, _to_torch(values, dtype))  # input untouched
    np.testing.assert_array_equal(_to_numpy(out), expected)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inplace_async_then_synchronize(runtimes, dtype):
    values = _values(dtype, seed=1)
    expected = np.asarray(jax_ops.allreduce(
        jnp.asarray(values), op="sum", prescale_factor=0.25,
        name=f"jax.inplace.{dtype}"))
    tensor = _to_torch(values, dtype)
    handle = hvd.allreduce_async_(tensor, op=hvd.Sum, prescale_factor=0.25)
    deadline = time.monotonic() + 30
    while not hvd.poll(handle):
        assert time.monotonic() < deadline, "allreduce never completed"
        time.sleep(0.001)
    out = hvd.synchronize(handle)
    assert out is tensor
    np.testing.assert_array_equal(_to_numpy(tensor), expected)


def test_compression_fp16_matches_jax(runtimes):
    values = _values("float32", seed=2)
    comp, ctx = JaxCompression.fp16.compress(jnp.asarray(values))
    expected = np.asarray(JaxCompression.fp16.decompress(
        jax_ops.allreduce(comp, name="jax.fp16"), ctx))
    tcomp, tctx = hvd.Compression.fp16.compress(torch.from_numpy(values))
    assert tcomp.dtype == torch.float16
    out = hvd.Compression.fp16.decompress(hvd.allreduce(tcomp), tctx)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), expected)


@pytest.mark.parametrize("bpps,compression,op", [
    (1, "none", "average"),
    (2, "none", "average"),
    (1, "fp16", "sum"),
])
def test_distributed_optimizer_matches_jax(runtimes, bpps, compression, op):
    """Two optimizer steps of SGD-momentum on per-microbatch gradients fed
    in directly.  Rounding of the two SGD implementations may differ in the
    last bit (torch fuses p + (-lr)·buf): rtol 1e-6."""
    rng = np.random.RandomState(3)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(2 * bpps)]

    tx = JaxDistributedOptimizer(
        optax.sgd(0.1, momentum=0.9), op=op,
        compression=getattr(JaxCompression, compression),
        backward_passes_per_step=bpps, name=f"jopt.{bpps}.{compression}")
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)

    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p], lr=0.1, momentum=0.9),
        named_parameters=[(f"w.{bpps}.{compression}", p)],
        compression=getattr(hvd.Compression, compression),
        backward_passes_per_step=bpps, op=op)
    for i, g in enumerate(grads):
        (p * torch.from_numpy(g)).sum().backward()
        if (i + 1) % bpps == 0:
            opt.step()
            opt.zero_grad()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-6, atol=0)


def test_controller_fuses_like_jax_controller():
    """The same cycle of requests gives the same fused responses: FIFO with
    look-ahead, one bucket per (dtype, device, scales), 600-byte threshold."""
    spec = [("a", "FLOAT32", [10], 1.0), ("b", "FLOAT16", [20], 1.0),
            ("c", "FLOAT32", [100], 1.0), ("d", "FLOAT32", [40], 0.5),
            ("e", "FLOAT32", [30], 1.0), ("f", "FLOAT16", [300], 1.0),
            ("g", "FLOAT32", [2, 5], 1.0)]

    def run(mod, ctl):
        reqs = [mod.Request(request_rank=0, tensor_name=n,
                            tensor_type=mod.DataType[t], tensor_shape=s,
                            prescale_factor=pre)
                for n, t, s, pre in spec]
        return [(r.response_type.name, r.tensor_names, r.tensor_sizes,
                 r.tensor_type.name)
                for r in ctl.compute_response_list(reqs).responses]

    ours = run(messages, controller.Controller(
        ProcessTopology(), fusion_threshold_bytes=600))
    theirs = run(jax_messages, jax_controller.Controller(
        JaxTopology(), None, fusion_threshold_bytes=600))
    assert ours == theirs
    assert len(ours) >= 3


@pytest.mark.parametrize("dtype", list(messages.DataType))
def test_datatype_round_trips_torch_and_matches_jax_numbering(dtype):
    assert messages.DataType.from_torch(dtype.to_torch()) is dtype
    theirs = jax_messages.DataType[dtype.name]
    assert int(theirs) == int(dtype)
    assert theirs.itemsize == dtype.itemsize


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adasum_at_size_one_applies_the_scales_like_jax(runtimes, dtype):
    """At size 1 Adasum is the scales: bit-equal to the JAX package's
    device path (``XlaAdasum``: widen, multiply by prescale·postscale,
    round once) and within 2 ulps of the dtype of the JAX bridge's, whose
    host path (``AdasumAllreduce``) rounds in the dtype after each scale."""
    values = _values(dtype, seed=4)
    core = np.asarray(jax_ops.allreduce(
        jnp.asarray(values), op="adasum", prescale_factor=0.3,
        postscale_factor=1.7, name=f"jax.adasum.{dtype}"))
    if dtype == "float32":
        bridge = jax_torch.allreduce(
            torch.from_numpy(values.copy()), op=jax_torch.Adasum,
            prescale_factor=0.3, postscale_factor=1.7,
            name="bridge.adasum").numpy()
    else:   # the bridge cannot hand bf16 back: its core op on numpy
        bridge = np.asarray(jax_ops.allreduce(
            values, op="adasum", prescale_factor=0.3, postscale_factor=1.7,
            name="bridge.adasum.bf16"))
    out = hvd.allreduce(_to_torch(values, dtype), op=hvd.Adasum,
                        prescale_factor=0.3, postscale_factor=1.7)
    assert out.dtype == _TORCH_DTYPES[dtype]
    np.testing.assert_array_equal(_to_numpy(out), core)
    ulp = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
    got, want = _to_numpy(out).astype(np.float64), bridge.astype(np.float64)
    assert np.all(np.abs(got - want) <= 2 * ulp * np.abs(want))


@pytest.mark.parametrize("inner", ["sgd", "adamw"])
def test_adasum_optimizer_at_size_one_is_the_inner_step(runtimes, inner):
    """``old + adasum(new - old)`` over one rank is the inner step within
    one fp32 ulp, and the JAX bridge's, bit for bit."""
    rng = np.random.RandomState(6)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(2)]

    def run(make_distributed, name):
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = torch.optim.SGD([p], lr=0.1, momentum=0.9) if inner == "sgd" \
            else torch.optim.AdamW([p], lr=0.01)
        if make_distributed is not None:
            opt = make_distributed(opt, [(name, p)])
        for g in grads:
            opt.zero_grad()
            (p * torch.from_numpy(g)).sum().backward()
            opt.step()
        return p.detach().numpy()

    plain = run(None, "")
    ours = run(lambda opt, named: hvd.DistributedOptimizer(
        opt, named_parameters=named, op=hvd.Adasum), f"w.port.{inner}")
    theirs = run(lambda opt, named: jax_torch.DistributedOptimizer(
        opt, named_parameters=named, op=jax_torch.Adasum), f"w.jax.{inner}")
    assert np.all(np.abs(ours - plain) <= np.spacing(np.abs(plain)))
    np.testing.assert_array_equal(ours, theirs)


def test_init_without_device_needs_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: init() would take it")
    hvd.shutdown()
    with pytest.raises(HorovodInternalError, match="CUDA is not available"):
        hvd.init()
    with pytest.raises(HorovodInternalError, match="CUDA is not available"):
        hvd.init(device="cuda")
    assert not hvd.is_initialized()


def test_init_refuses_more_than_one_process(monkeypatch):
    """Size > 1 without the launcher's rendezvous store raises, naming the
    two variables the launcher sets, and leaves nothing initialized."""
    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", raising=False)
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_PORT", raising=False)
    with pytest.raises(HorovodInternalError,
                       match="HOROVOD_GLOO_RENDEZVOUS_ADDR and "
                             "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_collectives_after_shutdown_raise_and_reinit_works():
    hvd.shutdown()
    with pytest.raises(HorovodInternalError, match="init"):
        hvd.allreduce(torch.ones(2))
    hvd.init(device="cpu")
    try:
        assert hvd.size() == 1 and hvd.rank() == 0
        assert hvd.device() == torch.device("cpu")
        np.testing.assert_array_equal(
            hvd.allreduce(torch.arange(3.0), op=hvd.Sum).numpy(),
            [0.0, 1.0, 2.0])
    finally:
        hvd.shutdown()


_GUARD = """
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {examples!r})
import torch
import chip_smoke
import profile_step
import adasum_bert_pretraining
import pytorch_imagenet_resnet50
import pytorch_synthetic_benchmark
import pytorch_resnet50_elastic
import horovod_tpu_torch as hvd
from horovod_tpu_torch.elastic import (
    constants, discovery, driver, launcher, registration, rendezvous_client,
    state, torch_state, worker)
from horovod_tpu_torch.tools import critical_path, trace_merge
from horovod_tpu_torch.models import resnet, transformer
from horovod_tpu_torch.models.training import train_step

hvd.init(device="cpu")
model = resnet.ResNet(stage_sizes=[1], block_cls=resnet.BottleneckBlock,
                      num_classes=4, num_filters=8, dtype=torch.float32,
                      fuse_conv1x1_bn=True,
                      generator=torch.Generator().manual_seed(0))
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
loss = train_step(model, opt, {{"x": torch.rand(2, 16, 16, 3),
                                "y": torch.tensor([0, 1])}})
assert torch.isfinite(loss)
bert = transformer.Transformer(transformer.tiny_config(causal=False),
                               generator=torch.Generator().manual_seed(0))
opt = hvd.DistributedOptimizer(torch.optim.AdamW(bert.parameters()),
                               named_parameters=bert.named_parameters())
tokens = torch.randint(0, 128, (2, 16))
assert torch.isfinite(train_step(bert, opt, {{"x": tokens, "y": tokens}}))
# The elastic state that chip_smoke.py --worker elastic commits each step.
elastic = hvd.elastic.TorchState(model, opt, batch=0)
elastic.batch = 1
elastic.commit()
elastic.batch = 2
elastic.restore()
assert elastic.batch == 1
chip_smoke.elastic_hash(model, opt, elastic.batch)
hvd.shutdown()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "horovod_tpu"))
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_and_chip_smoke_load_no_jax():
    proc = subprocess.run([sys.executable, "-c", _GUARD.format(
        repo=str(REPO), examples=str(REPO / "examples" / "torch_port"))],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _sources():
    yield from sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    yield from sorted((REPO / "examples" / "torch_port").glob("*.py"))
    yield REPO / "chip_smoke.py"
    yield REPO / "profile_step.py"


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    offenders = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] in _FORBIDDEN]
    assert not offenders, offenders
