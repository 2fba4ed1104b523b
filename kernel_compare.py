#!/usr/bin/env python3
"""Builds of the port's CUDA kernels side by side on one GPU.

    python3 kernel_compare.py [--kernels dq,b8] [--variants NAME,...]
                              [--against DIR]

Builds ``horovod_tpu_torch/csrc`` as it is (``current``), a copy of it per
variant named in ``--variants`` (the text substitutions of ``VARIANTS``
applied to one source) and, with ``--against``, the ``csrc`` of another
checkout (for example ``git archive`` of the parent commit unpacked under
``_archive/``), one ``nvcc`` per library, all started together.  Then, for
each main-path shape of the chosen kernels (``chip_smoke.py``'s timed flash
shapes for the dQ kernel, its 15 ResNet-50 shapes for ``matmul_bn_stats``),
checks every build against the plain version (relative RMS of dq; y and
both statistics for B8, as ``chip_smoke.py`` holds them) and times it with
``chip_smoke.cuda_ms``, the builds in turns and then in reverse order
(A, B, ..., B, A).  Prints the card, then one JSON line per shape with
each build's two times.  A variant marked ``diagnostic`` removes work to
show what it costs; its results are wrong by design and are not checked.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs
from horovod_tpu_torch.kernels import build, conv_bn_stats
from horovod_tpu_torch.kernels import flash_attention as fa

VARIANT_DIR = build.BUILD_DIR / "variants"

_FA = "flash_attention.cu"
_B8 = "matmul_bn_stats.cu"
_NO_MMA = ("wgmma_ss_mn64(acc[c], a,", "if (M < 0) wgmma_ss_mn64(acc[c], a,")
_NO_EPILOGUE = ("      mbar_arrive(&empty[(it - 1) % L::kStages]);\n\n",
                "      mbar_arrive(&empty[(it - 1) % L::kStages]);\n"
                "      if (M > 0) continue;\n\n")
_NO_W = [("mbar_arrive_expect_tx(&full[stage], L::kStageBytes);",
          "mbar_arrive_expect_tx(&full[stage], L::kXBytes);"),
         ("            tma_load_2d(ws + c * BK * 64,",
          "            if (M < 0) tma_load_2d(ws + c * BK * 64,")]

# name -> (source, [(old, new), ...], diagnostic)
VARIANTS = {
    # dQ with one block per work item instead of one per SM.
    "dq_block_per_item": (_FA, [(
        "flash_bwd_dq_kernel<D><<<persistent_blocks(items),",
        "flash_bwd_dq_kernel<D><<<static_cast<int>(items),")], False),
    # dQ with 64-key tiles at head_dim 64 too.
    "dq_keys_64": (_FA, [("static constexpr int kKeys = D == 64 ? 128 : 64;",
                          "static constexpr int kKeys = 64;")], False),
    # B8 without the TMA store of y.
    "b8_no_store": (_B8, [
        ("tma_store_2d(&ty,", "if (M < 0) tma_store_2d(&ty,")], True),
    # B8 without its products (the accumulators are left as they are).
    "b8_no_mma": (_B8, [_NO_MMA], True),
    # B8 without its epilogue: no y, no statistics, nothing stored.
    "b8_no_epilogue": (_B8, [_NO_EPILOGUE], True),
    # B8's loads alone: no products and no epilogue.
    "b8_loads_only": (_B8, [_NO_EPILOGUE, _NO_MMA], True),
    # B8's loads of x alone: no w, no products, no epilogue.
    "b8_loads_x_only": (_B8, [_NO_EPILOGUE, _NO_MMA] + _NO_W, True),
    # B8 without writing y into shared memory (y is stored unwritten).
    "b8_no_y_smem": (_B8, [(
        "            *reinterpret_cast<uint32_t*>(yp + r * 128",
        "            if (M < 0) *reinterpret_cast<uint32_t*>(yp + r * 128")],
        True),
    # B8 without the statistics (butterfly, rows in shared memory, partials).
    "b8_no_stats": (_B8, [
        ("halve<32>(v, lane, 16);\n        halve<16>(v, lane, 8);\n"
         "        halve<8>(v, lane, 4);",
         "if (M < 0) {\n        halve<32>(v, lane, 16);\n"
         "        halve<16>(v, lane, 8);\n        halve<8>(v, lane, 4);\n"
         "        }"),
        ("if (col < BN && n0 + col < N) {", "if (M < 0) {")], True),
}


def build_library(csrc: Path, source: str, out: Path) -> Path:
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
           str(csrc / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc / source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    spills = [line.strip() for line in proc.stdout.splitlines()
              if re.search(r"[1-9]\d* bytes spill", line)]
    print(f"built {out.name}; ptxas spills: {spills or 'none'}", flush=True)
    return out


def variant_csrc(name: str) -> Path:
    """A copy of ``csrc`` with the variant's substitutions applied."""
    source, subs, _ = VARIANTS[name]
    dst = VARIANT_DIR / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, dst)
    text = (dst / source).read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{text.count(old)} times in {source}")
        text = text.replace(old, new)
    (dst / source).write_text(text)
    return dst


def flash_fns(lib: ctypes.CDLL) -> dict:
    fns = {}
    for name in fa.LAUNCHES:
        fn = getattr(lib, f"hvd_{name}_bf16")
        fn.argtypes = [ctypes.POINTER(fa._Params), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def b8_kernel(lib: ctypes.CDLL):
    fn = lib.hvd_matmul_bn_stats_bf16
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, conv_bn_stats.BLOCK_M, 0x7fffffff


def turns(builds: dict, run) -> dict:
    """``run(name)`` for every build, in order and then in reverse."""
    order = list(builds) + list(reversed(builds))
    times = {name: [] for name in builds}
    for name in order:
        times[name].append(run(name))
    return times


def compare_dq(libs: dict, diagnostic: set) -> None:
    gen = torch.Generator(device="cuda").manual_seed(2)
    fns = {name: flash_fns(lib) for name, lib in libs.items()}
    for shape, b, s, h, d, causal, timed in cs.FLASH_SHAPES:
        if not timed:
            continue
        scale = d ** -0.5
        qkv = torch.randn(b, s, 3 * h, d, device="cuda",
                          generator=gen).to(torch.bfloat16)
        q, k, v = qkv.split(h, dim=2)
        do = torch.randn(b, s, h, d, device="cuda",
                         generator=gen).to(torch.bfloat16)
        o, lse = fa.attention_reference(q, k, v, causal, scale)
        di = fa.row_dot(o, do)
        ref = fa.attention_bwd_dq_reference(q, k, v, lse, do, di, causal,
                                            scale)
        errors = {}
        for name in libs:
            fa._kernels = lambda name=name: fns[name]
            dq = fa.flash_bwd_dq(q, k, v, lse, do, di, causal, scale)
            errors[name] = cs.rel_rms(dq, ref)
            if name not in diagnostic and errors[name] > cs.GRAD_REL_RMS:
                raise AssertionError(f"{name} dq at {shape}: rel RMS "
                                     f"{errors[name]}")

        def run(name):
            fa._kernels = lambda: fns[name]
            return cs.cuda_ms(lambda: fa.flash_bwd_dq(
                q, k, v, lse, do, di, causal, scale), 20)
        times = turns(libs, run)
        bound_ms, bound_by = cs.flash_bound("flash_bwd_dq", b, s, h, d,
                                            causal)
        print("dq", json.dumps({"shape": shape, "bound_ms": bound_ms,
                                "bound_by": bound_by, "ms": times,
                                "dq_rel_rms": errors}), flush=True)
        del qkv, q, k, v, do, o, lse, di, ref
        torch.cuda.empty_cache()


def compare_b8(libs: dict, diagnostic: set) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = {name: b8_kernel(lib) for name, lib in libs.items()}
    for (m, k, n), per_step in cs.MAIN_PATH_SHAPES.items():
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(k, n, device="cuda", generator=gen)
             / k ** 0.5).to(torch.bfloat16)
        yr = x.float() @ w.float()
        s1r, s2r = yr.sum(0), (yr * yr).sum(0)
        tol = cs.Y_ULPS * cs.bf16_ulp(torch.maximum(
            yr.abs(), yr.abs().max() * 2.0 ** -8))
        ok = {}
        for name in libs:
            conv_bn_stats._kernel = lambda name=name: kernels[name]
            y, s1, s2 = conv_bn_stats.matmul_bn_stats(x, w)
            ok[name] = bool(
                ((y.float() - yr).abs() <= tol).all()
                and ((s1 - s1r).abs() / yr.abs().sum(0)).max() <= cs.S_REL
                and ((s2 - s2r).abs() / s2r).max() <= cs.S_REL)
            if name not in diagnostic and not ok[name]:
                raise AssertionError(f"{name} disagrees at {(m, k, n)}")
            del y, s1, s2

        def run(name):
            conv_bn_stats._kernel = lambda: kernels[name]
            return cs.cuda_ms(lambda: conv_bn_stats.matmul_bn_stats(x, w), 20)
        times = turns(libs, run)
        bound_ms, bound_by, _, _ = cs.bound(m, k, n, conv_bn_stats.BLOCK_M)
        print("b8", json.dumps({"m": m, "k": k, "n": n,
                                "launches_per_step": per_step,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "ms": times, "agrees": ok}), flush=True)
        del x, w, yr, s1r, s2r, tol
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default="dq,b8")
    parser.add_argument("--variants", default="")
    parser.add_argument("--against", type=Path, default=None,
                        help="root of another checkout to build and time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_compare: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    kernels = args.kernels.split(",")
    sources = {"dq": _FA, "b8": _B8}
    wanted = {sources[k] for k in kernels}
    variants = [v for v in args.variants.split(",") if v]
    # (build name, csrc, source) for every library to build.
    jobs = []
    for source in sorted(wanted):
        jobs.append(("current", build.CSRC_DIR, source))
        jobs += [(v, variant_csrc(v), source) for v in variants
                 if VARIANTS[v][0] == source]
        if args.against is not None:
            jobs.append(("against", args.against / "horovod_tpu_torch" /
                         "csrc", source))
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {(name, source): pool.submit(
            build_library, csrc, source,
            VARIANT_DIR / f"lib{name}-{Path(source).stem}.so")
            for name, csrc, source in jobs}
        paths = {key: f.result() for key, f in futures.items()}
    print(cs.card(), flush=True)
    diagnostic = {v for v in variants if VARIANTS[v][2]}
    for kernel in kernels:
        source = sources[kernel]
        libs = {name: ctypes.CDLL(str(path))
                for (name, src), path in paths.items() if src == source}
        (compare_dq if kernel == "dq" else compare_b8)(libs, diagnostic)
    return 0


if __name__ == "__main__":
    sys.exit(main())
