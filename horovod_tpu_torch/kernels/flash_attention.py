"""Flash attention: the forward, dK/dV and dQ kernels and their plain versions.

Counterpart of ``_scaled_dot_attention`` (``horovod_tpu/models/transformer.py``
:111-145) and of the three Pallas TPU kernels of the library flash attention
that it reaches (``jax.experimental.pallas.ops.tpu.flash_attention``: the
forward ``_flash_attention_impl``, ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``).  The kernels are CUDA C++ for sm_90a
(``csrc/flash_attention.cu``; each loads its tiles by TMA and multiplies
with ``wgmma``); layout is the JAX package's ``[b, s, h, d]``.

:func:`flash_attention` sends CPU tensors to :func:`attention_reference` and
:func:`attention_bwd_reference`, the plain versions, and CUDA tensors to the
kernels.  A CUDA tensor the kernels do not take raises; nothing falls back.
The kernels read strided views (the q, k, v slices of a fused qkv projection,
row stride ``3·h·d``) without a copy; only the head dimension must be
contiguous.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build

#: Launches of each CUDA kernel in this process, by kernel.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}

HEAD_DIMS = (64, 128)
#: Tiles of the forward kernel by head_dim: (queries per work item, keys
#: per k tile).  A copy of ``FwdPlan`` in ``csrc/flash_attention.cu``,
#: checked against it when the library loads.
FWD_TILES = {64: (128, 128), 128: (128, 128)}
#: Tiles of the dK/dV kernel by head_dim: (keys per block, queries per q
#: tile), a copy of ``DkvPlan``.  The block loops over q tiles in order,
#: from the q tile holding its first key when causal, else from 0.
DKV_TILES = {64: (128, 64), 128: (128, 32)}
#: Tiles of the dQ kernel by head_dim: (queries per work item, keys per k
#: tile), a copy of ``DqPlan``.  A work item loops over k tiles in order
#: from 0, to the tile holding its last query when causal.
DQ_TILES = {64: (128, 128), 128: (128, 64)}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: the einsum path of ``_scaled_dot_attention``.

    Scores in fp32, then scaled; the causal mask is ``-inf`` above the
    diagonal; softmax in fp32; probabilities rounded to ``q.dtype`` before
    the product with ``v``.  Returns ``(o [b,s,h,d] in q.dtype,
    lse [b,h,s] fp32)``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return o.to(q.dtype), lse


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(o∘dO)`` in fp32, contiguous ``[b, h, s]``: a torch op
    outside the kernels, as in the library (its ``_flash_attention_bwd``)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, lse, do, di, causal: bool, sm_scale: float):
    """fp32 ``P = exp(S − lse)`` and ``dS = P∘(dO Vᵀ − di)``, ``[b,h,q,k]``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.exp(scores - lse[..., None])
    if causal:
        s = q.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - di[..., None])


def _dkv(p, ds, q, do, sm_scale):
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    return dk, torch.einsum("bhqk,bqhd->bkhd", p, do.float())


def _dq(ds, k, sm_scale):
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale


def attention_bwd_dkv_reference(q, k, v, lse, do, di, causal: bool,
                                sm_scale: float):
    """Plain version of the dK/dV kernel: fp32 ``(dk, dv)``."""
    p, ds = _probs_and_ds(q, k, v, lse, do, di, causal, sm_scale)
    return _dkv(p, ds, q, do, sm_scale)


def attention_bwd_dq_reference(q, k, v, lse, do, di, causal: bool,
                               sm_scale: float):
    """Plain version of the dQ kernel: fp32 ``dq``."""
    _, ds = _probs_and_ds(q, k, v, lse, do, di, causal, sm_scale)
    return _dq(ds, k, sm_scale)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, causal: bool,
                            sm_scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain backward in flash form, all fp32: ``P = exp(S − lse)``,
    ``dV = Pᵀ dO``, ``dP = dO Vᵀ``, ``dS = P∘(dP − di)`` with
    ``di = rowsum(o∘dO)``, ``dQ = dS K·scale``, ``dK = dSᵀ Q·scale``.
    Returns fp32 ``(dq, dk, dv)`` in ``[b, s, h, d]``."""
    p, ds = _probs_and_ds(q, k, v, lse, do, row_dot(o, do), causal,
                          sm_scale)
    dk, dv = _dkv(p, ds, q, do, sm_scale)
    return _dq(ds, k, sm_scale), dk, dv


class _Params(ctypes.Structure):
    """Mirror of ``HvdFlashParams`` in ``csrc/flash_attention.cu``."""
    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("q", "k", "v", "dout", "di", "lse", "o", "dq", "dk", "dv")]
                + [(name, ctypes.c_longlong * 3) for name in
                   ("q_stride", "k_stride", "v_stride", "do_stride")]
                + [("b", ctypes.c_int), ("h", ctypes.c_int),
                   ("s", ctypes.c_int), ("scale", ctypes.c_float),
                   ("causal", ctypes.c_int)])


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.library("flash_attention")
    lib.hvd_flash_params_size.argtypes = []
    lib.hvd_flash_params_size.restype = ctypes.c_int
    if lib.hvd_flash_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("flash_attention: HvdFlashParams of the CUDA "
                           "source and its ctypes mirror differ in size")
    lib.hvd_flash_tiles.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.hvd_flash_tiles.restype = ctypes.c_int
    for d in HEAD_DIMS:
        tiles = (ctypes.c_int * 6)()
        want = FWD_TILES[d] + DKV_TILES[d] + DQ_TILES[d]
        if lib.hvd_flash_tiles(d, tiles) != 0 or tuple(tiles) != want:
            raise RuntimeError(f"flash_attention: tiles of the CUDA source at "
                               f"head_dim {d} are {tuple(tiles)}, the wrapper's "
                               f"{want}")
    fns = {}
    for name in LAUNCHES:
        fn = getattr(lib, f"hvd_{name}_bf16")
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _check(*tensors: torch.Tensor) -> None:
    """Raise on anything the CUDA kernels do not take.  Each tensor is
    ``[b, s, h, d]`` with a contiguous, 16-byte aligned head dimension."""
    q = tensors[0]
    if any(t.device != q.device for t in tensors):
        raise ValueError(
            "flash_attention: tensors on "
            f"{sorted({str(t.device) for t in tensors})}; the kernels take "
            "tensors on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"flash_attention: the kernels take bf16, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.dim() != 4 or t.shape != q.shape for t in tensors):
        shapes = [tuple(t.shape) for t in tensors]
        raise ValueError(f"flash_attention: shapes {shapes} are not one "
                         "[b, s, h, d]")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d}; the kernels take "
                         f"{HEAD_DIMS}")
    if min(b, s, h) < 1 or max(b, h) > 65535:
        raise ValueError(f"flash_attention: shape {(b, s, h, d)}; the "
                         "kernels take b, h in [1, 65535] and s >= 1")
    for t in tensors:
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                st % 8 for st in t.stride()[:3]):
            raise ValueError(
                f"flash_attention: strides {t.stride()}; the kernels take a "
                "contiguous head dimension, 16-byte aligned rows and heads")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device}; the "
                         "kernels take CUDA tensors (CPU tensors take the "
                         "plain version)")


def _launch(name: str, params: _Params, head_dim: int, device) -> None:
    fn = _kernels()[name]
    with torch.cuda.device(device):
        err = fn(ctypes.byref(params), head_dim,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: {name} launch failed with "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def _params(q, k, v, causal: bool, sm_scale: float, **pointers) -> _Params:
    b, s, h, _ = q.shape
    p = _Params(b=b, h=h, s=s, scale=sm_scale, causal=int(causal))
    for name, t in (("q", q), ("k", k), ("v", v)):
        setattr(p, name, t.data_ptr())
        getattr(p, f"{name}_stride")[:] = t.stride()[:3]
    for name, t in pointers.items():
        setattr(p, name, t.data_ptr())
    if "dout" in pointers:
        p.do_stride[:] = pointers["dout"].stride()[:3]
    return p


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(o [b,s,h,d] bf16, lse [b,h,s] fp32)``."""
    _check(q, k, v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", _params(q, k, v, causal, sm_scale, o=o, lse=lse),
            d, q.device)
    return o, lse


def _check_bwd(q, k, v, lse, do, di) -> None:
    _check(q, k, v, do)
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"fp32 [b, h, s] on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _empty_like_q(q: torch.Tensor) -> torch.Tensor:
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def flash_bwd_dkv(q, k, v, lse, do, di, causal: bool, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: bf16 ``(dk, dv)`` in ``[b, s, h, d]``."""
    _check_bwd(q, k, v, lse, do, di)
    dk, dv = _empty_like_q(q), _empty_like_q(q)
    _launch("flash_bwd_dkv", _params(q, k, v, causal, sm_scale, dout=do,
                                     lse=lse, di=di, dk=dk, dv=dv),
            q.shape[3], q.device)
    return dk, dv


def flash_bwd_dq(q, k, v, lse, do, di, causal: bool, sm_scale: float
                 ) -> torch.Tensor:
    """The dQ kernel: bf16 ``dq`` in ``[b, s, h, d]``."""
    _check_bwd(q, k, v, lse, do, di)
    dq = _empty_like_q(q)
    _launch("flash_bwd_dq", _params(q, k, v, causal, sm_scale, dout=do,
                                    lse=lse, di=di, dq=dq),
            q.shape[3], q.device)
    return dq


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool, sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dK/dV and dQ kernels: bf16 ``(dq, dk, dv)`` in ``[b, s, h, d]``."""
    di = row_dot(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, lse, do, di, causal, sm_scale)
    return flash_bwd_dq(q, k, v, lse, do, di, causal, sm_scale), dk, dv


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the kernels on CUDA tensors
    and the plain versions on CPU tensors.  Saves ``(q, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        if _on_cpu(q, k, v):
            o, lse = attention_reference(q, k, v, causal, sm_scale)
        else:
            o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if _on_cpu(q, k, v, do):
            grads = attention_bwd_reference(q, k, v, o, lse, do, ctx.causal,
                                            ctx.sm_scale)
            dq, dk, dv = (g.to(q.dtype) for g in grads)
        else:
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal,
                                   ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, sm_scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Differentiable ``softmax(sm_scale·q kᵀ) v`` over ``[b, s, h, d]``.

    CPU tensors take the plain versions; CUDA tensors the kernels (bf16,
    head_dim 64 or 128), or this raises.  ``sm_scale`` defaults to
    ``d ** -0.5``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, float(sm_scale))
