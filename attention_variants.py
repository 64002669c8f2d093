#!/usr/bin/env python3
"""Time variants of the port's masked-attention kernel against the kernel
itself, in turns, on one NVIDIA GPU at the flagship serve shape.

    python3 attention_variants.py [--rounds 10] [--variants launch_order,warps8]

A variant is the kernel's source (``distar_tpu_torch/ops/csrc``) with a few
lines replaced, as ``VARIANTS`` lists; each is built with the port's nvcc
flags into ``distar_tpu_torch/_build/variants/<name>/`` (all at once) and
called as ``kernels.masked_attention`` calls the kernel. Each variant is first
held against the plain version: the max abs error at the serve shape in f32
and bf16 against chip_smoke's tolerances, and the bf16 peaked rows of
``chip_smoke.peaked_inputs`` in bf16 ulps (chip_smoke asks for at most 1).
Both are printed, not enforced: a variant may be wrong on purpose. Then the
kernel and every variant are timed as chip_smoke times the kernel (device
time per call from torch.profiler, plan launch included), in f32 and bf16, on
three masks of [32, 2, 512, 128]: chip_smoke's serve lengths, all keys valid,
half valid; ``--rounds`` rounds, the order reversed each round. One JSON
line per (dtype, mask): each version's median, quartiles and every time.
Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# name: (why, [(file in csrc, the text replaced, its replacement)]); each text
# occurs once in its file
VARIANTS = {
    "launch_order": (
        "blocks take the samples in launch order, not longest first (the plan still runs)",
        [("masked_attention.cu", "const int b = plan.order[r], h", "const int b = r, h")]),
    "warps8": (
        "128 queries a block, 8 warps, one block an SM in f32: each K/V tile read from L2 "
        "by half as many blocks",
        [("masked_attention.cu", "constexpr int BQ = 64;", "constexpr int BQ = 128;"),
         ("masked_attention.cu", "constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),
         ("masked_attention.cu", "__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")]),
    "cvt_split": (
        "the tf32 split as two cvt.rna.tf32.f32 (hi = x rounded to tf32, lo = x - hi rounded)",
        [("common.cuh",
          "  hi = __float_as_uint(x) & 0xffffe000u;\n"
          "  lo = __float_as_uint(x - __uint_as_float(hi));\n",
          '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
          '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));\n')]),
    "divide_per_copy": (
        "each cp.async copy takes its row and column by an integer division",
        [("masked_attention.cu",
          "  for (int r = threadIdx.x / cpr, c = threadIdx.x % cpr; r < rows;) {\n",
          "  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {\n"
          "    const int r = i / cpr, c = i % cpr;\n"),
         ("masked_attention.cu",
          "    r += dr;\n    c += dc;\n    if (c >= cpr) {\n      c -= cpr;\n      ++r;\n    }\n",
          "    (void)dr;\n    (void)dc;\n")]),
    "p_one_pass": (
        "bf16: P V in one pass on P rounded to bf16 (no lo part)",
        [("masked_attention.cu", "        mma_bf16(o[2 * nt2], pl, b0);\n", ""),
         ("masked_attention.cu", "        mma_bf16(o[2 * nt2 + 1], pl, b1);\n", "")]),
}


def variant_sources(name, csrc):
    """{file name: text} of the variant: every csrc file the kernel reads,
    the variant's replacements made."""
    files = {f: open(os.path.join(csrc, f)).read() for f in ("masked_attention.cu", "common.cuh")}
    for f, old, new in VARIANTS[name][1]:
        n = files[f].count(old)
        if n != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {n} times in {f}, not once")
        files[f] = files[f].replace(old, new)
    return files


def build_variants(names):
    """Write and compile every variant at once; {name: ctypes function}."""
    from distar_tpu_torch.ops import build

    root = build.BUILD_DIR / "variants"
    procs = {}
    for name in names:
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in variant_sources(name, str(build.CSRC)).items():
            (d / f).write_text(text)
        lib = d / "masked_attention.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(d / "masked_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc exited {proc.returncode}\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}")
        fn = ctypes.CDLL(str(lib)).masked_attention_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = I
        fns[name] = fn
    return fns


def caller(fn):
    """The variant called with kernels.masked_attention's arguments and
    scratch."""
    import torch

    from distar_tpu_torch.ops import kernels as K

    def call(q, k, v, mask):
        B, H, N, Dh = q.shape
        out = torch.empty_like(q)
        plan = torch.empty(B * (2 + 2 * -(-N // K.ATTENTION_KEY_TILE)), dtype=torch.int32,
                           device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), plan.data_ptr(),
                 out.data_ptr(), B, H, N, Dh, 1.0 / Dh ** 0.5, int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed with cudaError {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("attention_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distar_tpu_torch.ops import build
    from distar_tpu_torch.ops import kernels as K

    names = [n for n in args.variants.split(",") if n]
    for n in names:
        if n not in VARIANTS:
            raise SystemExit(f"unknown variant {n}; known: {', '.join(VARIANTS)}")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line())
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build(["masked_attention"])
    fns = {"kernel": K.masked_attention}
    fns.update({n: caller(f) for n, f in build_variants(names).items()})
    print(f"built in {time.perf_counter() - t0:.1f} s")
    for n in names:
        print(f"variant {n}: {VARIANTS[n][0]}")

    B, H, N, Dh = cs.SLOTS, 2, 512, 128
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, N + 1, B)
    lengths[:3] = (1, N // 3, N)  # as chip_smoke's serve lengths
    masks = {"serve": np.arange(N)[None, :] < lengths[:, None],
             "all": np.ones((B, N), bool),
             "half": np.arange(N)[None, :] < np.full((B, 1), N // 2)}
    peaked = cs.peaked_inputs(np.random.default_rng(11), 4, 2, 64, 32, device)
    peaked_want = K.masked_attention_plain(*peaked)
    inputs = {(dt, m): cs.attention_inputs(rng, B, H, N, Dh, mask, dt, device)
              for dt in (torch.float32, torch.bfloat16) for m, mask in masks.items()}
    for name, fn in fns.items():
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            args_ = inputs[(dt, "serve")]
            errs[str(dt)[6:]] = float((fn(*args_).float() - K.masked_attention_plain(*args_).float())
                                      .abs().max())
        ulps = cs.bf16_ulps(fn(*peaked), peaked_want)
        print(json.dumps({"version": name, "max_abs_err": errs, "tol": cs.ATTN_TOL,
                          "bf16_peaked_ulps": ulps}))
    for (dt, m), a in inputs.items():
        times = {name: [] for name in fns}
        order = list(fns)
        for _ in range(args.rounds):
            for name in order:
                times[name].append(cs.device_ms(lambda: fns[name](*a))[0])
            order.reverse()
        print(json.dumps({"dtype": str(dt)[6:], "mask": m, "keys_valid": int(a[3].sum()),
                          "ms": {name: {"median": statistics.median(t),
                                        "quartiles": statistics.quantiles(t, n=4)[::2],
                                        "all": t} for name, t in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
