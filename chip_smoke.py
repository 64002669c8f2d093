#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. device  — print the card's name and power limit; TF32 off for matmuls
             and cuDNN convolutions, so the parity phases compare f32.
2. build   — compile every CUDA kernel from ``distar_tpu_torch/ops/csrc``
             (one nvcc per source, in parallel) and print the seconds.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the flagship serve shapes (32 slots, 512 entities) and at edge
             cases: attention in f32 and bf16 over head dims 4-128, 1-512
             keys, prefix and non-prefix masks, and masked K/V rows at
             +-1e4; the two scatter kernels bit-equal to the entity-order
             loop and to each other on uniform, padded and one-cell indices,
             and the loop kernel in bf16 bit-equal to the bf16 loop; kernel,
             plain and library times (attention in both dtypes), each the
             device time per call read from torch.profiler, beside a bound
             restated for the units the kernel runs on.
4. serve   — the flagship model (``default_model_config`` with the kernel
             overlay, full width, seeded random weights) behind
             ``BatchedInference(32 slots) -> BatchedInferenceEngine ->
             InferenceGateway``: 8 sessions x 3 steps plus a reset, once per
             scatter kernel, with the launch counts read around each run;
             then the kernel-backed forward held against the 'xla' strings on
             the same weights and Gumbel noise, and the median flush time.
5. train   — the SL train step at flagship width and depth, f32, batch 2 x
             unroll 32 (64 frames): each kernel's autograd Function at the
             training shapes, its forward (the kernel) against the plain
             version and its backward (the JAX formula) against autograd
             through the plain version (attention f32 and bf16, both
             scatter kernels bit for bit); one
             step per config string ('pallas', 'pallas_onehot', 'xla') from
             the same weights, batch and state, agreeing on loss, info and
             grad_norm; 8 steps of ``bin/sl_train.py``'s learner on one fixed
             batch, the loss falling and 3 attention + 1 scatter launches a
             step; step ms, SL frames/s, a profiled step, peak memory and
             each kernel's forward and backward at the training shapes; one
             bf16 step. Beside each kernel at the training shapes, the library
             calls of the same functions: SDPA with the same boolean mask
             (forward, forward + backward; f32 and bf16), ``zeros +
             index_add_`` and an ``index_select`` gather for its backward.
6. rl      — the RL learner (``RL_LEARNER_DEFAULTS``, 4 x 16: 68 observed
             frames) and the distillation student at flagship width, f32:
             each kernel's Function at the RL shapes [68, 2, 512, 128] /
             [68, 512, 32] and the student's [68, 2, 512, 64] / [68, 512,
             16], held as in phase 5 and timed beside the library calls; the
             three config strings from the same weights on a zero-observation
             ``FakeRLDataloader`` batch and on a fixed ``random_rl_batch``:
             loss and every info scalar within STEP_TOL, the whole gradients
             within GRAD_TOL of their norm, while planted wiring faults
             (UPGO or KL term dropped, time and batch axes crossed) must
             move the 'xla' gradient further than GRAD_TOL; printed beside
             them the 'xla' string's distance from its own repeat and the
             parameter groups that carry the strings' distance; then one
             step each; one step
             with the value-pretrain gate (the policy heads bit for bit
             unchanged, the winloss tower moved); 8 steps of
             ``RLLearner.run`` on its own ``FakeRLDataloader`` with 3
             attention + 1 scatter launches a step; step ms, RL frames/s, a
             profiled step, peak memory; one bf16 step; 3 steps at the
             reference's 6 x 64 with their peak memory; the
             ``DistillLearner`` strings held the same way, 4 steps of
             ``DistillLearner.run`` with 2 attention + 1 scatter launches a
             step, and its step ms.

The line before the last is the ``kernels`` JSON (launches: the serve, SL,
RL and distillation paths together, each read from zero around its run);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # CUDA cores: the scatter kernels' additions
PEAK_TF32_FLOPS = 495e12  # tensor cores: the f32 attention's 3xTF32 products
PEAK_BF16_FLOPS = 989e12  # tensor cores: the bf16 attention's products
# tensor-core passes of the attention's products: 3xTF32 for f32 inputs; in
# bf16 one for Q K^T and two (P split hi + lo) for P V
ATTN_PASSES = {"float32": 3.0, "bfloat16": 1.5}
ATTN_PEAK = {"float32": PEAK_TF32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}

SLOTS = 32
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # kernel vs plain, max abs
SCATTER_TOL = 1e-5  # the one-hot plain version sums in matmul order
SCATTER_CASES = ("uniform", "padded", "one_cell")
LOGIT_TOL = 1e-3  # kernel-backed vs 'xla' forward, max abs on unmasked logits


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


TIMING = ("device time per call: the summed durations of the call's device activities "
          "(kernels, fills, copies) over {iters} calls after {warmup} warm-up calls, read from "
          "torch.profiler; the host's time per call and the gaps it leaves on the device are "
          "not counted")


def device_activities(prof):
    """{name: (ms, count)} of the device activities (kernels, fills, copies)
    of a finished torch.profiler run."""
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


def device_ms(fn, iters=20, warmup=3):
    """(device ms per call of ``fn``, {activity name: ms per call}), as
    TIMING says. A wrapper call of a scatter kernel takes about as long on the
    host as on the card, so CUDA events around back-to-back calls would time
    the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # now and then a profiler session reports no device activity at all (seen
    # on the H100 after some hundreds of sessions in one process): run it again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {k: ms / iters for k, (ms, _) in device_activities(prof).items()}
        if per:
            break
    check(per, "the profiler saw no device activity")
    return sum(per.values()), per


def bound(nbytes, flops, peak=PEAK_F32_FLOPS, passes=1.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations (``passes`` times ``flops``) over ``peak``, the rate of
    the units the kernel runs them on."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = passes * flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- kernels
def attention_inputs(rng, B, H, N, Dh, mask, dtype, device, garbage=False):
    """q, k, v from the seed and the [B, N] numpy mask, on the card; with
    ``garbage`` the masked K/V rows are +-1e4, which must not reach the
    output."""
    import numpy as np
    import torch

    q, k, v = (rng.standard_normal((B, H, N, Dh)).astype("float32") for _ in range(3))
    if garbage:
        keep = mask[:, None, :, None]
        k, v = (np.where(keep, t, 1e4 * np.sign(t)).astype("float32") for t in (k, v))
    return [torch.from_numpy(t).to(device=device, dtype=dtype) for t in (q, k, v)] + [
        torch.from_numpy(mask).to(device)]


def attention_check(K, tag, q, k, v, mask, want=None):
    """The kernel against the plain version (or ``want``) within ATTN_TOL;
    returns the max abs error."""
    import torch

    got = K.masked_attention(q, k, v, mask)
    want = K.masked_attention_plain(q, k, v, mask) if want is None else want
    name = str(q.dtype)[6:]
    check(got.dtype == q.dtype, f"attention {tag}: output dtype {got.dtype}")
    check(torch.isfinite(got.float()).all(), f"attention {tag} {name}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(err <= ATTN_TOL[name], f"attention {tag} {name}: max abs err {err}")
    return err


def non_prefix_mask(rng, B, N, tile, pattern):
    """Valid keys only in the last key tile, or only in every other tile
    (from the second), at random density, at least one per sample."""
    import numpy as np

    tiles = np.arange(N) // tile
    where = tiles == tiles[-1] if pattern == "last_tile" else tiles % 2 == 1
    if not where.any():
        where = tiles == 0
    mask = (rng.random((B, N)) < 0.5) & where
    mask[:, np.flatnonzero(where)[-1]] = True
    return mask


def peaked_inputs(rng, B, H, N, Dh, device):
    """bf16 q, k, v, all keys valid, whose softmax rows put their weight on
    keys 0 and 1 (scores about 20 and 20 - d, d = 0.05-0.15 by query; every
    other key about 0) with V rows +c and -c (c = 500-1000 by head dim). The
    output, about c d / 2, is the difference of two large weighted rows:
    rounding the weights to bf16 (2^-9 of each) moves it by several of its
    bf16 ulps, weights kept near f32 by less than one."""
    import numpy as np
    import torch

    r = Dh ** 0.5  # undoes the 1/sqrt(Dh) scale
    q = np.zeros((B, H, N, Dh), "float32")
    q[..., 0], q[..., 1] = 1.0, rng.uniform(0.5, 1.5, (B, H, N))
    k = 0.1 * rng.standard_normal((B, H, N, Dh)).astype("float32")
    k[:, :, :2] = 0.0
    k[:, :, :2, 0] = 20 * r
    k[:, :, 1, 1] = -0.1 * r
    v = rng.standard_normal((B, H, N, Dh)).astype("float32")
    c = rng.uniform(500, 1000, (B, H, Dh))
    v[:, :, 0], v[:, :, 1] = c, -c
    return [torch.from_numpy(t).to(device, torch.bfloat16) for t in (q, k, v)] + [
        torch.ones(B, N, dtype=torch.bool, device=device)]


def bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of |want| (8 significant bits)."""
    import torch

    w = want.float()
    _, e = torch.frexp(w)
    return float(((got.float() - w).abs() / torch.ldexp(torch.ones_like(w), e - 8)).max())


def attention_edges(K, rng, device):
    """Every head dim and key count of the card tests, prefix masks with no,
    one, part and all keys valid; non-prefix masks; 1100 keys or samples;
    masked rows at +-1e4. Returns {dtype name: worst error}."""
    import numpy as np
    import torch

    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        errs = []
        for Dh in (4, 8, 32, 128):
            for N in (1, 63, 64, 65, 512):
                mask = np.arange(N)[None, :] < np.array([0, 1, N // 2, N])[:, None]
                errs.append(attention_check(K, f"{N}x{Dh} prefix", *attention_inputs(
                    rng, 4, 2, N, Dh, mask, dt, device)))
        for N, Dh in ((512, 128), (65, 8)):
            for pattern in ("last_tile", "alternating"):
                mask = non_prefix_mask(rng, 4, N, K.ATTENTION_KEY_TILE, pattern)
                errs.append(attention_check(K, f"{N}x{Dh} {pattern}", *attention_inputs(
                    rng, 4, 2, N, Dh, mask, dt, device)))
        # the plan past one warp's word: > 32 key tiles a sample, 1100 samples
        # to rank; sparse masks, a sample with none valid, one all
        side = np.random.default_rng(7)  # apart from rng: the later draws stay as they were
        for B, H, N, Dh in ((3, 2, 1100, 32), (1100, 1, 40, 8)):
            mask = side.random((B, N)) < 0.05
            mask[0], mask[1] = False, True
            errs.append(attention_check(K, f"{B}x{H}x{N}x{Dh} sparse", *attention_inputs(
                side, B, H, N, Dh, mask, dt, device)))
        B, N = 4, 512
        for pattern in ("prefix", "alternating"):
            mask = (np.arange(N)[None, :] < rng.integers(1, N + 1, (B, 1)) if pattern == "prefix"
                    else non_prefix_mask(rng, B, N, K.ATTENTION_KEY_TILE, pattern))
            seed = int(rng.integers(1 << 30))
            clean = attention_inputs(np.random.default_rng(seed), B, 2, N, 128, mask, dt, device)
            dirty = attention_inputs(np.random.default_rng(seed), B, 2, N, 128, mask, dt, device,
                                     garbage=True)
            errs.append(attention_check(K, f"{pattern} masked rows at +-1e4", *dirty,
                                        want=K.masked_attention_plain(*clean)))
        worst[str(dt)[6:]] = max(errs)
        print(f"kernel masked_attention edges {str(dt)[6:]}: {len(errs)} cases (Dh 4/8/32/128 x N "
              f"1/63/64/65/512 prefix, non-prefix, 1100 keys or samples, masked rows at +-1e4), "
              f"worst max_abs_err {max(errs):.3e} (tol {ATTN_TOL[str(dt)[6:]]:.0e})")
    # bf16 weights kept near f32 (P split hi + lo): one output ulp at most
    q, k, v, mask = peaked_inputs(np.random.default_rng(11), 4, 2, 64, 32, device)
    ulps = bf16_ulps(K.masked_attention(q, k, v, mask), K.masked_attention_plain(q, k, v, mask))
    check(ulps <= 1, f"attention bf16 peaked rows: {ulps:.2f} bf16 ulps from the plain version")
    print(f"kernel masked_attention bf16 peaked rows 4x2x64x32: {ulps:.2f} bf16 ulps of |want| "
          f"at most from the plain version (tol 1)")
    return worst


def attention_timing(K, q, k, v, mask):
    """Device ms per call of the kernel, the plain version and SDPA (an
    additive -1e9 mask in the inputs' dtype) on the same inputs; the bound
    restated for the kernel's tensor-core route and the old f32 CUDA-core
    one."""
    import torch
    import torch.nn.functional as Fn

    B, H, N, Dh = q.shape
    name = str(q.dtype)[6:]
    # the keys the function needs: a sample's valid keys, or all N when it has
    # none (its rows are then mean(V)); q read, out written, the K and V rows
    # of those keys read, the mask read
    valid = mask.sum(1)
    keys = int(torch.where(valid > 0, valid, N).sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * H * Dh * q.element_size() * keys + mask.numel()
    flops = 4 * H * Dh * N * keys  # every query row against those keys
    add_mask = torch.zeros(B, 1, 1, N, device=q.device, dtype=q.dtype).masked_fill(
        ~mask[:, None, None, :], -1e9)
    ms, per = device_ms(lambda: K.masked_attention(q, k, v, mask))  # the plan, then the attention
    rec = {"ms": ms,
           "plain_ms": device_ms(lambda: K.masked_attention_plain(q, k, v, mask), iters=5)[0],
           "library_ms": device_ms(
               lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=add_mask))[0]}
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, ATTN_PEAK[name], ATTN_PASSES[name])
    cuda_core_ms, _ = bound(nbytes, flops)
    print(f"kernel masked_attention {B}x{H}x{N}x{Dh} {name}: ms {rec['ms']:.4f} plain_ms "
          f"{rec['plain_ms']:.4f} library_ms {rec['library_ms']:.4f} (SDPA, {name}); bound_ms "
          f"{rec['bound_ms']:.4f} ({rec['bound_by']}: {nbytes / 1e6:.1f} MB at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s, {ATTN_PASSES[name]} passes x {flops / 1e9:.3f} GFLOP "
          f"at {ATTN_PEAK[name] / 1e12:.0f} TFLOP/s) = {rec['bound_ms'] / rec['ms']:.1%} of the "
          f"kernel's time; the f32 CUDA-core bound {cuda_core_ms:.4f} ms; {keys} keys read of "
          f"{B * N}; by activity "
          + json.dumps({act[:60]: round(t, 5) for act, t in per.items()}))
    check(0 < rec["bound_ms"] <= rec["ms"], f"attention {name}: bound {rec['bound_ms']} ms over the "
          f"kernel's {rec['ms']} ms: the count is wrong")
    return rec


def scatter_case(K, rng, case, B, N, D, hw, device):
    """Both scatter kernels on one index case, held bit for bit (signs of
    zeros included) against the entity-order loop ``scatter_add_plain`` and
    each other, and the one-hot kernel within SCATTER_TOL of its matmul-order
    plain version. Returns ((emb, idx), loop err, one-hot err).

    uniform: random cells, 8 rows forced into one cell, two out-of-range
    indices; padded: as observations arrive, ``entity_num`` per sample in
    1..N and the rows past it at cell 0 with embeddings ``-0.0 * x``;
    one_cell: every row of a sample at one cell."""
    import torch

    from distar_tpu_torch.ops import scatter_connection

    emb = rng.standard_normal((B, N, D)).astype("float32")
    idx = rng.integers(0, hw, (B, N))
    if case == "uniform":
        idx[:, :8] = idx[:, :1]  # forced collisions
        idx[:, 8] = -3  # out of range: clipped to 0
        idx[:, 9] = hw + 7  # out of range: clipped to hw-1
    elif case == "padded":
        for b, n in enumerate(rng.integers(1, N + 1, B)):
            idx[b, n:] = 0
            emb[b, n:] *= -0.0
    else:
        idx[:] = rng.integers(0, hw, (B, 1))
    emb, idx = torch.from_numpy(emb).to(device), torch.from_numpy(idx).to(device)
    loop = K.scatter_add_connection(emb, idx, hw)
    onehot = K.scatter_add_onehot(emb, idx, hw)
    plain = K.scatter_add_plain(emb, idx, hw)
    tag = f"scatter {case} {B}x{N}x{D} hw={hw}"
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    check(torch.equal(bits(loop), bits(onehot)), f"{tag}: the two kernels differ")
    check(torch.equal(bits(loop), bits(plain)), f"{tag}: the kernels differ from scatter_add_plain")
    # bf16 rows: the loop kernel adds in bf16 like the Pallas loop kernel,
    # bit-equal to the loop on the bf16 rows; the 'pallas_onehot' route sums
    # in f32 and rounds once. Through scatter_connection on a 1 x hw map,
    # where (x, y) = (idx, 0) is the clipped cell.
    e16, bits16 = emb.bfloat16(), (lambda t: t.view(torch.int16))  # noqa: E731
    loop16 = bits16(K.scatter_add_plain(e16, idx, hw))
    check(torch.equal(bits16(K.scatter_add_connection(e16, idx, hw)), loop16),
          f"{tag} bf16: the loop kernel differs from scatter_add_plain in bf16")
    loc = torch.stack([idx, torch.zeros_like(idx)], -1)
    once16 = bits16(K.scatter_add_plain(e16.float(), idx, hw).bfloat16())
    for impl, want in (("pallas", loop16), ("pallas_onehot", once16)):
        got = scatter_connection(e16, loc, (1, hw), impl=impl).reshape(B, hw, D)
        check(torch.equal(bits16(got), want), f"{tag} bf16: scatter_connection impl={impl} differs")
    err_loop = float((loop - plain).abs().max())
    err_onehot = float((onehot - K.scatter_add_onehot_plain(emb, idx, hw)).abs().max())
    # a cell of hundreds of rows (padded, one-cell) rounds in proportion to its sum
    tol = SCATTER_TOL * (1.0 if case == "uniform" else max(1.0, float(plain.abs().max())))
    check(err_onehot <= tol, f"{tag}: one-hot kernel vs its plain version max abs err {err_onehot}")
    print(f"kernel {tag}: both kernels bit-equal to scatter_add_plain and to each other; "
          f"one-hot vs its matmul-order plain version max_abs_err {err_onehot:.3e} (tol {tol:.1e}); "
          f"bf16: the loop kernel bit-equal to the bf16 loop, the one-hot route to the f32 sum "
          f"rounded once")
    return (emb, idx), err_loop, err_onehot


def index_add_call(emb, idx, hw):
    """The library yardstick: one torch.zeros + index_add_ over the map."""
    import torch

    B, _, D = emb.shape
    flat = (idx.clamp(0, hw - 1) + torch.arange(B, device=idx.device)[:, None] * hw).reshape(-1)
    flat_emb = emb.view(-1, D)
    return lambda: torch.zeros(B * hw, D, device=emb.device).index_add_(0, flat, flat_emb)


def phase_kernels(device, rng):
    """Every kernel vs its plain version at the flagship serve shapes and the
    CPU tests' edge cases; returns per-kernel records (errors and times at
    the serve shapes; the scatter records on the uniform case)."""
    import numpy as np
    import torch

    from distar_tpu_torch.ops import kernels as K

    print("timing: " + TIMING.format(iters=20, warmup=3))
    B, H, N, Dh = SLOTS, 2, 512, 128
    lengths = rng.integers(1, N + 1, B)
    lengths[:3] = (1, N // 3, N)  # one valid key, partial, all
    mask = np.arange(N)[None, :] < lengths[:, None]
    records = {}
    edge_errs = attention_edges(K, rng, device)
    flagship = {}
    for dt in (torch.bfloat16, torch.float32):
        args = attention_inputs(rng, B, H, N, Dh, mask, dt, device)
        err = attention_check(K, f"{B}x{H}x{N}x{Dh}", *args)
        print(f"kernel masked_attention {B}x{H}x{N}x{Dh} {str(dt)[6:]}: max_abs_err {err:.3e}")
        flagship[str(dt)[6:]] = (args, err)
    bf16 = attention_timing(K, *flagship["bfloat16"][0])
    print(json.dumps({"masked_attention_bfloat16": dict(
        bf16, max_abs_err=flagship["bfloat16"][1], edge_max_abs_err=edge_errs["bfloat16"])}))
    rec = attention_timing(K, *flagship["float32"][0])
    rec.update(max_abs_err=flagship["float32"][1], replaces="distar_tpu/ops/pallas_kernels.py:62",
               source="distar_tpu_torch/ops/csrc/masked_attention.cu")
    records["masked_attention"] = rec

    # the uniform cases first (the timed record, the case every earlier run
    # timed); then padded and one-cell
    sB, sN, sD, hw = SLOTS, 512, 32, 152 * 160
    names = ("scatter_add_connection", "scatter_add_onehot")
    cases = {}
    for case in SCATTER_CASES:
        scatter_case(K, rng, case, 2, 16, 4, 63, device)  # hw=63: one ragged tile
        cases[case] = scatter_case(K, rng, case, sB, sN, sD, hw, device)
    (emb, idx), e1, e2 = cases["uniform"]
    nbytes = emb.numel() * 4 + idx.numel() * 4 + sB * hw * sD * 4
    b_ms, b_by = bound(nbytes, emb.numel())
    for name, err, plain in zip(names, (e1, e2), (K.scatter_add_plain, K.scatter_add_onehot_plain)):
        line = 156 if name == "scatter_add_connection" else 231
        fn = getattr(K, name)
        ms, per = device_ms(lambda: fn(emb, idx, hw))
        records[name] = {
            "max_abs_err": err, "replaces": f"distar_tpu/ops/pallas_kernels.py:{line}",
            "source": f"distar_tpu_torch/ops/csrc/{name}.cu", "bound_ms": b_ms, "bound_by": b_by,
            "ms": ms, "plain_ms": device_ms(lambda: plain(emb, idx, hw), iters=3, warmup=1)[0],
            "library_ms": device_ms(index_add_call(emb, idx, hw))[0]}
        print(f"kernel {name} uniform: device ms per call by activity "
              + json.dumps({k[:60]: round(v, 5) for k, v in per.items()}))
    for case in SCATTER_CASES[1:]:
        (emb, idx), _, _ = cases[case]
        times = {name: device_ms(lambda: getattr(K, name)(emb, idx, hw))[0] for name in names}
        lib = device_ms(index_add_call(emb, idx, hw))[0]
        print(f"kernel scatter {case} {sB}x{sN}x{sD} hw={hw}: " + ", ".join(
            f"{name} ms {t:.4f} ({t / records[name]['ms']:.2f}x uniform)" for name, t in times.items())
            + f", library_ms {lib:.4f}, bound_ms {b_ms:.4f}")
    return records


# ------------------------------------------------------------------- serve
def build_model(cfg_overrides, seed, state_dict=None):
    from distar_tpu_torch.model import Model, default_model_config, init_params
    from distar_tpu_torch.utils import deep_merge_dicts

    model = Model(deep_merge_dicts(default_model_config(), cfg_overrides))
    if state_dict is None:
        init_params(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model


def check_output(out, F):
    import numpy as np

    for k, shape in F.ACTION_SHAPES.items():
        check(out["action_info"][k].shape == shape, f"action {k} shape {out['action_info'][k].shape}")
        check(out["action_logp"][k].shape == shape, f"logp {k} shape")
        check(np.isfinite(out["action_logp"][k]).all(), f"logp {k} not finite")
    for k, shape in F.LOGIT_SHAPES.items():
        check(out["logit"][k].shape == shape, f"logit {k} shape {out['logit'][k].shape}")
        check(np.isfinite(out["logit"][k]).all(), f"logit {k} not finite")
    check(0 <= int(out["action_info"]["delay"]) <= F.MAX_DELAY, "delay out of range")


def serve_run(device, cfg_overrides, state_dict, obs):
    """8 sessions x 3 steps + one reset through the port's gateway; returns
    (launch counts of this run, the model's state_dict)."""
    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.serve import BatchedInferenceEngine, InferenceGateway

    model = build_model(cfg_overrides, 0, state_dict)
    infer = BatchedInference(model, num_slots=SLOTS, seed=0, device=device)
    engine = BatchedInferenceEngine(infer)
    gw = InferenceGateway(engine, max_delay_s=0.05).start()
    try:
        gw.load_version("v0", params=model.state_dict(), activate=True)
        engine.warmup(obs[0][0])  # first launches, builds and allocator warm-up
        K.reset_launch_counts()
        sessions = [f"s{i}" for i in range(len(obs))]
        for step in range(3):
            outs = gw.act_many([{"session_id": s, "obs": obs[i][step]} for i, s in enumerate(sessions)])
            for o in outs:
                check(isinstance(o, dict), f"step {step}: {o!r}")
                check(o["session_step"] == step + 1, f"session_step {o['session_step']} at step {step}")
                check_output(o, F)
        check(gw.reset_session(sessions[0]), "reset_session failed")
        check(gw.act(sessions[0], obs[0][0])["session_step"] == 1, "reset did not restart the session")
        counts = dict(K.launch_counts)
        flushes = gw.flushes
    finally:
        gw.drain_and_stop()
    layers = model.cfg["encoder"]["entity"]["layer_num"]
    check(counts["masked_attention"] == layers * flushes,
          f"attention launches {counts['masked_attention']} for {flushes} flushes")
    impl = cfg_overrides["encoder"]["scatter"]["impl"]
    name = "scatter_add_onehot" if impl == "pallas_onehot" else "scatter_add_connection"
    check(counts[name] == flushes, f"{name} launches {counts[name]} for {flushes} flushes")
    print(f"serve scatter.impl={cfg_overrides['encoder']['scatter']['impl']}: {flushes} flushes, "
          f"launches {counts}")
    return counts, model.state_dict()


def phase_serve(device, rng):
    import numpy as np
    import torch

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.model import gumbel_noise

    obs = [[F.random_step_data(rng) for _ in range(3)] for _ in range(8)]
    launches = {}
    state = None
    for impl in ("pallas", "pallas_onehot"):
        counts, state = serve_run(device, overlay(impl, "pallas"), state, obs)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # each kernel-backed forward against the 'xla' strings, same weights/noise
    prepared = [F.random_step_data(rng) for _ in range(SLOTS)]
    outs, infers = {}, {}
    for impl, attn in (("pallas", "pallas"), ("pallas_onehot", "pallas"), ("xla", "xla")):
        infer = BatchedInference(build_model(overlay(impl, attn), 0, state), SLOTS, device=device)
        noise = gumbel_noise(infer.model.cfg, SLOTS, torch.Generator(device=device).manual_seed(7), device)
        outs[impl] = infer.sample(prepared, noise=noise)
        infers[impl] = infer
    for impl in ("pallas", "pallas_onehot"):
        worst = 0.0
        for a, b in zip(outs[impl], outs["xla"]):
            for k in F.ACTION_HEADS:
                check(np.array_equal(a["action_info"][k], b["action_info"][k]),
                      f"{impl}: action {k} differs from the 'xla' forward")
                la, lb = a["logit"][k], b["logit"][k]
                live = la > -1e8
                check(np.array_equal(live, lb > -1e8), f"{impl}: logit {k} masks differ")
                worst = max(worst, float(np.abs(la[live] - lb[live]).max(initial=0.0)))
        check(worst <= LOGIT_TOL, f"{impl} vs 'xla' logits: max abs err {worst}")
        print(f"serve parity scatter.impl={impl} vs xla: actions equal, logits max_abs_err {worst:.3e}")

    # host clock around whole flushes (each ends in the device->host copy),
    # the three forwards in turns, reversing the order each round
    times = {impl: [] for impl in infers}
    order = list(infers)
    for _ in range(8):
        for impl in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infers[impl].sample(prepared)
            times[impl].append((time.perf_counter() - t0) * 1e3)
        order.reverse()
    flush_ms = {impl: statistics.median(t[2:]) for impl, t in times.items()}
    print(f"serve flush ms (median of 6, {SLOTS} slots, host copy included): {flush_ms}")
    profiles = {impl: profile_call(lambda: infer.sample(prepared)) for impl, infer in infers.items()}
    print(json.dumps({"flush_profile": profiles}))
    return launches, flush_ms


def profile_call(fn):
    """One call of ``fn`` (a flush or a train step, ending in a device->host
    copy) under torch.profiler, after one call unprofiled: wall ms,
    device-busy ms (the sum of device activity on the one stream), idle
    share, the number of device activities (kernels and copies) and those
    that take the most time.

    The calls themselves run unguarded, so a kernel fault fails the run;
    only the profiler's own start, stop and event reading may fail softly,
    and then the profile reports why it was not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 - the profiler's own setup
        return {"not_measured": f"profiler start: {e!r}"}
    t0 = time.perf_counter()
    fn()
    wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    try:
        prof.stop()
        by_name = device_activities(prof)
    except Exception as e:  # noqa: BLE001 - the profiler's own teardown and event reading
        return {"not_measured": f"profiler events: {e!r}"}
    busy = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "device_activities": sum(n for _, n in by_name.values()),
            "top": [{"name": k[:80], "ms": ms, "count": n} for k, (ms, n) in rows[:10]]}


# ------------------------------------------------------------------- train
TRAIN_B, TRAIN_T = 2, 32  # SL_LEARNER_DEFAULTS: 64 frames a step
TRAIN_ITERS = 8
# one f32 step under each config string, max |a - b| / max(|b|, 1) over loss,
# info and grad_norm. The strings differ only inside the kernels: the scatter
# kernels are bit-equal to the loop and the attention within 1e-5 of its
# plain version (3xTF32), so the loss moves by about 1e-6 of itself; the
# argmax metrics are equal unless a near-tie flips. 1e-4 leaves two decades.
STEP_TOL = 1e-4

RL_B, RL_T = 4, 16  # RL_LEARNER_DEFAULTS: 64 acted frames, 68 observed a step
RL_BIG_B, RL_BIG_T = 6, 64  # the reference's trajectories x steps on one GPU (BASELINE.md)
RL_ITERS = 8
# the RL and distillation strings' whole gradients: within GRAD_TOL of the
# 'xla' gradient's norm, and every held wiring fault (``rl_faults``) further
# from it than that (``hold_strings``). On an H100 the sound strings lie
# 1.9e-3 (random batch) and 3.1e-3 (zero observations) of the norm from
# 'xla'; dropping UPGO moves the gradient 5.5e-2, crossing the time and
# batch axes 1.2. 1e-2 lies between, about 3x from each.
GRAD_TOL = 1e-2
DISTILL_ITERS = 4
STRINGS = {"pallas": ("pallas", "pallas"), "pallas_onehot": ("pallas_onehot", "pallas"),
           "xla": ("xla", "xla")}


def overlay(scatter_impl, attn_impl, dtype="float32"):
    return {"encoder": {"entity": {"attention_impl": attn_impl}, "scatter": {"impl": scatter_impl}},
            "dtype": dtype}


def rel_err(got, want):
    """max |got - want| / max(|want|, 1): absolute below 1, relative above
    (a bf16 gradient of 8 has an ulp of 0.0625)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def train_kernel_grads(K, rng, device, entity_num, Dh=128, D=32):
    """Each kernel's autograd Function at a training shape: attention
    [F, 2, 512, Dh] with the batch's F entity counts, f32 and bf16; both
    scatter kernels on [F, 512, D], hw 24,320, uniform and padded indices
    (F = 64 frames for the SL step, 68 for the RL step; Dh 64 and D 16 are
    the distillation student's).

    The forward is the kernel: its output is held against the plain version
    on the same inputs (attention max abs within ATTN_TOL, both scatters bit
    for bit against the entity-order loop ``scatter_add_plain``). The
    backward is the JAX formula in plain PyTorch and sees the kernel only
    through the saved inputs, so its check holds that formula against
    autograd through the plain version (attention via ``rel_err`` within
    ATTN_TOL; the scatter gather exactly: one dout element a gradient, as
    autograd through the one-hot plain version gives it). Returns the
    inputs for the timings."""
    import numpy as np
    import torch

    B, H, N = len(entity_num), 2, 512
    mask = np.arange(N)[None, :] < entity_num[:, None]
    fwd, bwd, inputs = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, m = attention_inputs(rng, B, H, N, Dh, mask, dt, device)
        w = torch.from_numpy(rng.standard_normal((B, H, N, Dh)).astype("float32")).to(device, dt)
        outs, grads = {}, {}
        for name, fn in (("kernel", K.masked_attention), ("plain", K.masked_attention_plain)):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            outs[name] = fn(*leaves, m)
            (outs[name] * w).sum().backward()
            grads[name] = [t.grad for t in leaves]
        name = str(dt)[6:]
        got = outs["kernel"].detach()
        check(got.dtype == dt and torch.isfinite(got.float()).all(), f"attention {name}: forward output")
        err = float((got.float() - outs["plain"].detach().float()).abs().max())
        check(err <= ATTN_TOL[name], f"attention forward {name}: max abs err {err}")
        fwd[f"masked_attention_{name}"] = err
        err = max(rel_err(a, b) for a, b in zip(grads["kernel"], grads["plain"]))
        check(all(g.dtype == dt for g in grads["kernel"]), f"attention {name}: gradient dtype")
        check(err <= ATTN_TOL[name], f"attention backward formula {name}: err {err}")
        bwd[f"masked_attention_{name}"] = err
        inputs[name] = (q, k, v, m, w)
    hw = 152 * 160
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    for case in ("uniform", "padded"):
        emb = rng.standard_normal((B, N, D)).astype("float32")
        idx = rng.integers(0, hw, (B, N))
        if case == "uniform":
            idx[:, :8] = idx[:, :1]
            idx[:, 8], idx[:, 9] = -3, hw + 7  # clipped to the edge cells
        else:
            for b, n in enumerate(entity_num):
                idx[b, n:] = 0
                emb[b, n:] *= -0.0
        emb, idx = torch.from_numpy(emb).to(device), torch.from_numpy(idx).to(device)
        w = torch.from_numpy(rng.standard_normal((B, hw, D)).astype("float32")).to(device)
        loop = K.scatter_add_plain(emb, idx, hw)
        e = emb.clone().requires_grad_()
        (K.scatter_add_onehot_plain(e, idx, hw) * w).sum().backward()
        for name in ("scatter_add_connection", "scatter_add_onehot"):
            got = emb.clone().requires_grad_()
            out = getattr(K, name)(got, idx, hw)
            check(torch.equal(bits(out.detach()), bits(loop)), f"{name} forward {case}: differs from "
                  f"scatter_add_plain")
            fwd[f"{name}_{case}"] = float((out.detach() - loop).abs().max())
            (out * w).sum().backward()
            check(torch.equal(got.grad, e.grad), f"{name} gather backward {case}: differs from "
                  f"autograd through the plain version")
            bwd[f"{name}_{case}"] = float((got.grad - e.grad).abs().max())
        inputs[case] = (emb, idx, w)
    print(f"train kernels at [{B}, {H}, {N}, {Dh}] / [{B}, {N}, {D}] hw {hw}, through their autograd "
          f"Functions: forward (kernel vs plain version, max abs; tol {ATTN_TOL}, scatter bit-equal) "
          + json.dumps(fwd) + "; backward formula vs autograd through the plain version (attention "
          "max |a - b| / max(|b|, 1) over dq, dk, dv; scatter max abs, must be 0) " + json.dumps(bwd))
    return inputs, fwd


def sdpa_calls(q, k, v, m, dout):
    """The library yardsticks of the attention at a training shape: SDPA
    with the same boolean key mask, forward, and forward + backward (the
    gradients of q, k and v for ``dout``)."""
    import torch
    import torch.nn.functional as Fn

    mask4 = m[:, None, None, :]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fwd = lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask4)  # noqa: E731
    both = lambda: torch.autograd.grad(  # noqa: E731
        Fn.scaled_dot_product_attention(*leaves, attn_mask=mask4), leaves, dout)
    return fwd, both


def train_kernel_times(K, inputs, tag="train"):
    """Device ms per call of each kernel's forward and backward at a
    training shape (``device_ms``), beside the library calls of the same
    functions (SDPA with the same boolean mask, forward and forward +
    backward, f32 and bf16; ``zeros + index_add_`` and, for its backward,
    an ``index_select`` gather), with bounds counted as in the kernels
    phase: the forward's as there; the attention backward reads q, dout and
    the needed keys' K and V rows, writes dq, dk and dv in full, and does 5
    products of 2 H Dh N keys operations at the f32 CUDA-core peak (a plain
    PyTorch f32 backward, TF32 off); the scatter backward reads the indices
    and one dout row an entity, and writes the gradient."""
    import torch

    q, k, v, m, dout = inputs["float32"]
    B, H, N, Dh = q.shape
    valid = m.sum(1)
    keys = int(torch.where(valid > 0, valid, N).sum())
    out = {}
    fb = 2 * q.numel() * 4 + 2 * H * Dh * 4 * keys + m.numel()
    fwd_ms, _ = device_ms(lambda: K.masked_attention(q, k, v, m))
    bwd_ms, _ = device_ms(lambda: K.masked_attention_backward(q, k, v, m, dout), iters=5, warmup=1)
    rec = out["masked_attention"] = {
        "fwd_ms": fwd_ms, "fwd_bound_ms": bound(fb, 4 * H * Dh * N * keys, PEAK_TF32_FLOPS, 3.0)[0],
        "plain_fwd_ms": device_ms(lambda: K.masked_attention_plain(q, k, v, m), iters=5, warmup=1)[0],
        "bwd_ms": bwd_ms,
        "bwd_bound_ms": bound(5 * q.numel() * 4 + 2 * H * Dh * 4 * keys + m.numel(),
                              10 * H * Dh * N * keys)[0]}
    for name in ("float32", "bfloat16"):
        q, k, v, m, dout = inputs[name]
        fwd, both = sdpa_calls(q, k, v, m, dout)
        if name == "bfloat16":
            rec["bf16_fwd_ms"] = device_ms(lambda: K.masked_attention(q, k, v, m))[0]
            rec["bf16_bwd_ms"] = device_ms(lambda: K.masked_attention_backward(q, k, v, m, dout),
                                           iters=5, warmup=1)[0]
        rec[f"library_{name}_fwd_ms"] = device_ms(fwd)[0]
        rec[f"library_{name}_fwd_bwd_ms"] = device_ms(both, iters=5, warmup=1)[0]
    emb, idx, dmap = inputs["uniform"]  # dmap: an output gradient [B, hw, D]
    hw = dmap.shape[1]
    Bs, Ns, D = emb.shape
    flat = (idx.clamp(0, hw - 1) + torch.arange(Bs, device=idx.device)[:, None] * hw).reshape(-1)
    flat_dmap = dmap.reshape(-1, D)
    library = {"library_fwd_ms": device_ms(index_add_call(emb, idx, hw))[0],
               "library_bwd_ms": device_ms(lambda: flat_dmap.index_select(0, flat))[0]}
    for name in ("scatter_add_connection", "scatter_add_onehot"):
        fn = getattr(K, name)
        out[name] = {"fwd_ms": device_ms(lambda: fn(emb, idx, hw))[0],
                     "fwd_bound_ms": bound(emb.numel() * 4 + idx.numel() * 4 + Bs * hw * D * 4,
                                           emb.numel())[0],
                     "bwd_ms": device_ms(lambda: K.scatter_add_backward(idx, dmap, hw))[0],
                     "bwd_bound_ms": bound(idx.numel() * 8 + 2 * emb.numel() * 4, 0)[0], **library}
    print(json.dumps({f"{tag}_kernel_ms": out, "shapes": {
        "attention": [B, H, N, Dh], "valid_keys": keys, "scatter": [Bs, Ns, D], "hw": hw}}))
    return out


def sl_learner(device, impl="pallas", dtype="float32"):
    """The flagship SL learner (SL_LEARNER_DEFAULTS, seeded ``init_params``)
    under config string ``impl``."""
    from distar_tpu_torch.learner import SLLearner

    return SLLearner({"learner": {"batch_size": TRAIN_B, "unroll_len": TRAIN_T},
                      "model": overlay(*STRINGS[impl], dtype)}, device=device)


def finite(log, keys=("total_loss", "grad_norm")):
    import math

    return all(math.isfinite(log[k]) for k in keys)


def train_entry_point(K, batch):
    """``python -m distar_tpu_torch.bin.sl_train --type learner`` at the
    flagship with the kernel overlay, run through the bin's learner function
    on one fixed batch for TRAIN_ITERS steps with the state carried; its
    per-step log lines are read back from its output. The launch counts
    must rise by one attention call a transformer layer and one scatter
    call a step."""
    import contextlib
    import io
    import itertools

    from distar_tpu_torch.bin import sl_train

    overlay = {"model": {"encoder": {"entity": {"attention_impl": "pallas"},
                                     "scatter": {"impl": "pallas"}}},
               "learner": {"log_freq": 1}}
    args = sl_train.parser().parse_args([
        "--type", "learner", "--full-model", "--iters", str(TRAIN_ITERS),
        "--batch-size", str(TRAIN_B), "--traj-len", str(TRAIN_T), "--config", json.dumps(overlay)])
    before = dict(K.launch_counts)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        lrn = sl_train.learner(args, itertools.repeat(batch))
    rose = {k: K.launch_counts[k] - before[k] for k in before}
    logs = [json.loads(ln) for ln in text.getvalue().splitlines() if ln.startswith("{")]
    check(len(logs) == TRAIN_ITERS, f"entry point: {len(logs)} log lines for {TRAIN_ITERS} steps")
    check(all(finite(lg) for lg in logs), "entry point: a non-finite loss or grad_norm")
    losses = [lg["total_loss"] for lg in logs]
    check(losses[-1] < losses[0], f"entry point: loss {losses[0]} -> {losses[-1]} on a fixed batch")
    layers = lrn.model_cfg.encoder.entity.layer_num  # one attention call a layer
    want = {"masked_attention": layers * TRAIN_ITERS, "scatter_add_connection": TRAIN_ITERS,
            "scatter_add_onehot": 0}
    check(rose == want, f"entry point launches {rose}, want {want}")
    print(f"train entry point (bin/sl_train.py learner, flagship, kernel overlay, f32, fixed batch, "
          f"{TRAIN_ITERS} steps): total_loss " + " ".join(f"{x:.3f}" for x in losses)
          + f"; grad_norm {logs[0]['grad_norm']:.2f} -> {logs[-1]['grad_norm']:.2f}; "
          f"launches {rose}; log line keys {sorted(logs[0])}")
    return losses


def phase_train(device, rng):
    """The SL train step on the card (module docstring, phase 5). Returns
    the launch counts of the train path (every launch after the kernel
    gradient and timing calls) and the measurements."""
    import torch

    from distar_tpu_torch.learner import random_sl_batch
    from distar_tpu_torch.ops import kernels as K

    print(f"train: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    batch = random_sl_batch(TRAIN_B, TRAIN_T, rng)  # one fixed batch, 64 frames
    inputs, train_fwd_err = train_kernel_grads(K, rng, device, batch["entity_num"])
    kernel_ms = train_kernel_times(K, inputs)
    del inputs

    K.reset_launch_counts()
    # config strings agree on one step from the same weights, batch and state
    learners = {impl: sl_learner(device, impl) for impl in STRINGS}
    logs = {impl: lrn._train(batch) for impl, lrn in learners.items()}
    worst = strings_agree(logs, "train step")
    print(f"train step parity vs 'xla' (loss, {len(logs['xla'])} info scalars, grad_norm; "
          f"max |a - b| / max(|b|, 1), tol {STEP_TOL}): {worst}; total_loss "
          + json.dumps({k: lg["total_loss"] for k, lg in logs.items()}))

    losses = train_entry_point(K, batch)

    # step time in turns (3 warm-up steps each, the parity step included),
    # a profiled step and the peak memory of one step
    step_ms, times = step_times(learners, batch, warmup=2)
    frames = TRAIN_B * TRAIN_T
    memory = {impl: step_memory(lrn, batch)[0] for impl, lrn in learners.items()}
    profiles = {impl: profile_call(lambda: lrn._train(batch)) for impl, lrn in learners.items()}
    del learners

    # one bf16 step: finite, no parity claim
    lrn16 = sl_learner(device, dtype="bfloat16")
    log16 = lrn16._train(batch)
    check(finite(log16), f"bf16 train step: loss {log16['total_loss']} grad_norm {log16['grad_norm']}")
    print(f"train bf16 step (kernel overlay): total_loss {log16['total_loss']:.4f} "
          f"grad_norm {log16['grad_norm']:.3f}")
    del lrn16
    launches = dict(K.launch_counts)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the train path")
    result = {"step_ms": step_ms, "step_ms_all": times,
              "sl_frames_per_s": {impl: frames / (ms / 1e3) for impl, ms in step_ms.items()},
              "memory": memory, "step_profile": profiles, "train_kernel_ms": kernel_ms,
              "train_kernel_max_abs_err": train_fwd_err,
              "entry_point_losses": losses, "launches": launches}
    print(json.dumps({"train": result}))
    return launches, result


# --------------------------------------------------------------------- RL
def rl_learner(device, impl="pallas", dtype="float32", B=RL_B, T=RL_T, **learner):
    """The flagship RL learner (RL_LEARNER_DEFAULTS, seeded ``init_params``)
    under config string ``impl``."""
    from distar_tpu_torch.learner import RLLearner

    return RLLearner({"learner": {"batch_size": B, "unroll_len": T, **learner},
                      "model": overlay(*STRINGS[impl], dtype)}, device=device)


def distill_learner(device, impl="pallas", **learner):
    """The distillation student (``student_model_config``) under ``impl``."""
    from distar_tpu_torch.learner import DistillLearner

    return DistillLearner({"learner": {"batch_size": RL_B, "unroll_len": RL_T, **learner},
                           "model": overlay(*STRINGS[impl])}, device=device)


def strings_agree(logs, what):
    """Every config string's step scalars within STEP_TOL of the 'xla'
    string's (max |a - b| / max(|b|, 1)); returns the worst key of each."""
    worst = {}
    for impl in ("pallas", "pallas_onehot"):
        check(set(logs[impl]) == set(logs["xla"]), f"{what} {impl}: info keys differ")
        errs = {k: abs(logs[impl][k] - v) / max(abs(v), 1.0) for k, v in logs["xla"].items()}
        key = max(errs, key=errs.get)
        check(errs[key] <= STEP_TOL, f"{what} {impl} vs xla: {key} {logs[impl][key]} vs {logs['xla'][key]}")
        worst[impl] = (key, errs[key])
    check(all(finite(lg, [k for k in ("total_loss", "grad_norm") if k in lg]) for lg in logs.values()),
          f"{what}: a non-finite loss or grad_norm")
    return worst


def step_times(learners, batch, rounds=5, warmup=3):
    """Host ms of ``_train`` (it ends in the device->host copy of the
    scalars) to ``synchronize``, the learners in turns, reversing the order
    each round; (median per learner, every time)."""
    import torch

    for _ in range(warmup):
        for lrn in learners.values():
            lrn._train(batch)
    times = {impl: [] for impl in learners}
    order = list(learners)
    for _ in range(rounds):
        for impl in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learners[impl]._train(batch)
            torch.cuda.synchronize()
            times[impl].append((time.perf_counter() - t0) * 1e3)
        order.reverse()
    return {impl: statistics.median(t) for impl, t in times.items()}, times


def step_memory(lrn, batch):
    """({peak GB, the step's working set in GB}, the step's log) of one
    ``_train``."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log = lrn._train(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_gb": peak / 1e9, "step_gb": (peak - held) / 1e9}, log


def entry_point(K, lrn, iters, what):
    """``lrn.run(iters)`` on its own ``FakeRLDataloader``, as the JAX
    package drives its RL and distillation learners: the launch counts set
    to 0 just before the run and read just after, one attention launch a
    transformer layer and one scatter launch a step; the per-step log lines
    read back from its output. Returns (losses, launches)."""
    import contextlib
    import io

    text = io.StringIO()
    K.reset_launch_counts()
    with contextlib.redirect_stdout(text):
        lrn.run(iters)
    launches = dict(K.launch_counts)
    logs = [json.loads(ln) for ln in text.getvalue().splitlines() if ln.startswith("{")]
    check(len(logs) == iters, f"{what}: {len(logs)} log lines for {iters} steps")
    check(all(finite(lg) for lg in logs), f"{what}: a non-finite loss or grad_norm")
    layers = lrn.model_cfg.encoder.entity.layer_num
    want = {"masked_attention": layers * iters, "scatter_add_connection": iters,
            "scatter_add_onehot": 0}
    check(launches == want, f"{what} launches {launches}, want {want}")
    losses = [lg["total_loss"] for lg in logs]
    print(f"{what} (kernel overlay, f32, FakeRLDataloader, {iters} steps): total_loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; grad_norm {logs[0]['grad_norm']:.3f} -> {logs[-1]['grad_norm']:.3f}; "
          f"launches {launches}")
    return losses, launches


def loss_grads(loss_fn, lrn, batch):
    """(the loss's info as floats, the gradient of each parameter) of
    ``loss_fn(lrn, device batch)``, without an optimizer step."""
    import torch

    from distar_tpu_torch.actor.inference import to_device

    tb = to_device({k: v for k, v in batch.items() if k != "model_last_iter"}, lrn.device)
    total, info = loss_fn(lrn, tb)
    grads = torch.autograd.grad(total, list(lrn.model.parameters()), allow_unused=True,
                                materialize_grads=True)
    return {k: float(v.detach()) for k, v in info.items()}, grads


def crossed(batch):
    """``batch`` with its observations' time and batch axes crossed: row t*B
    + b of the flattened observations holds frame (b, t) read as [B, T+1],
    as a model that flattened them batch-major would see them."""
    import numpy as np

    def cross(x):
        if isinstance(x, dict):
            return {k: cross(v) for k, v in x.items()}
        x = np.asarray(x)
        return np.ascontiguousarray(np.swapaxes(x, 0, 1)).reshape(x.shape)

    obs = ("spatial_info", "entity_info", "scalar_info", "entity_num")
    return {k: cross(v) if k in obs else v for k, v in batch.items()}


def rl_faults(batch):
    """Wiring faults planted without touching the code, each a (loss
    function, batch, held) that the 'xla' learner runs in place of the
    sound one: the UPGO term dropped, the time and batch axes of the
    observations crossed, both held to move the gradient by more than
    GRAD_TOL; and the KL terms dropped, printed only: at weights 0.02 and
    0.1 they move the gradient about as far as the strings' rounding does
    on zero observations, and the info check (``kl/total``) is what catches
    their loss."""
    import dataclasses

    from distar_tpu_torch.learner import rl_loss

    def with_cfg(**change):
        return lambda lrn, tb: rl_loss(lrn.model, dataclasses.replace(lrn.loss_cfg, **change), tb,
                                       RL_B, RL_T)

    sound = with_cfg()
    return {"no upgo": (with_cfg(upgo_weight=0.0), batch, True),
            "crossed layout": (sound, crossed(batch), True),
            "no kl": (with_cfg(kl_weight=0.0, action_type_kl_weight=0.0), batch, False)}


def hold_strings(what, learners, batch, loss_fn, faults=None):
    """The loss and every info scalar of each config string within STEP_TOL
    of the 'xla' string's (``strings_agree``), each kernel string's whole
    gradient within GRAD_TOL of the 'xla' gradient's norm, and each planted
    fault of ``faults`` marked held moving the 'xla' gradient by more than
    GRAD_TOL, so that the tolerance is shown to catch it. Printed beside
    them, as the scale of what is held: the 'xla' string's distance from its
    own repeat on the same weights and batch, the parameter groups that
    carry the 'pallas' string's distance (share of its square, and the
    group's own |a - b| / |b|), and under each fault the strings' distance
    again."""
    import torch

    def rel(a, b):
        return float(torch.cat([(x - y).reshape(-1) for x, y in zip(a, b)]).norm()
                     / torch.cat([y.reshape(-1) for y in b]).norm())

    res = {impl: loss_grads(loss_fn, lrn, batch) for impl, lrn in learners.items()}
    worst = strings_agree({impl: info for impl, (info, _) in res.items()}, what)
    gx = res["xla"][1]
    dist = {impl: rel(res[impl][1], gx) for impl in ("pallas", "pallas_onehot")}
    repeat = rel(loss_grads(loss_fn, learners["xla"], batch)[1], gx)
    groups = {}  # first three name parts -> [|a - b|^2, |b|^2]
    for (name, _), a, b in zip(learners["xla"].model.named_parameters(), res["pallas"][1], gx):
        g = groups.setdefault(".".join(name.split(".")[:3]), [0.0, 0.0])
        g[0] += float((a - b).pow(2).sum())
        g[1] += float(b.pow(2).sum())
    total = sum(d for d, _ in groups.values()) or 1.0
    carry = {k: [round(d / total, 4), (d / n) ** 0.5 if n else None]
             for k, (d, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:6]}
    planted = {}
    for name, (fn, fb, held) in (faults or {}).items():
        fx = loss_grads(fn, learners["xla"], fb)[1]
        planted[name] = {"held": held, "moves_xla": rel(fx, gx),
                         "pallas_vs_xla": rel(loss_grads(fn, learners["pallas"], fb)[1], fx)}
    print(f"{what}, strings vs 'xla': loss and {len(res['xla'][0]) - 1} info scalars within {STEP_TOL} "
          f"(worst {worst}); gradient |a - b| / |b|: {json.dumps(dist)} (tol {GRAD_TOL}); 'xla' vs "
          f"its repeat {repeat:.3e}; groups carrying 'pallas' vs 'xla' ([share of |a - b|^2, the "
          f"group's |a - b| / |b|]) "
          f"{json.dumps(carry)}; planted faults {json.dumps(planted)}")
    for impl, d in dist.items():
        check(d <= GRAD_TOL, f"{what} {impl}: gradient {d:.4g} of its norm from 'xla'")
    for name, p in planted.items():
        check(not p["held"] or p["moves_xla"] > GRAD_TOL, f"{what}: fault '{name}' moves the gradient only "
              f"{p['moves_xla']:.4g}, within GRAD_TOL")
    return {"strings": dist, "xla_repeat": repeat, "carry": carry, "faults": planted}


def steps_agree(what, learners, batch):
    """One ``_train`` step per config string: the loss and every info scalar
    within STEP_TOL of the 'xla' string's, and each grad_norm within
    GRAD_TOL of it (the bound that ``hold_strings`` puts on the whole
    gradient). Returns the logs."""
    logs = {impl: lrn._train(batch) for impl, lrn in learners.items()}
    norms = {impl: lg.pop("grad_norm") for impl, lg in logs.items()}
    worst = strings_agree(logs, what)
    for impl in ("pallas", "pallas_onehot"):
        check(abs(norms[impl] - norms["xla"]) <= GRAD_TOL * norms["xla"],
              f"{what} {impl}: grad_norm {norms[impl]} vs {norms['xla']}")
    for impl, lg in logs.items():
        lg["grad_norm"] = norms[impl]
    print(f"{what} parity vs 'xla' (loss and {len(logs['xla']) - 2} info scalars, max |a - b| / "
          f"max(|b|, 1), tol {STEP_TOL}): {worst}; grad_norm {norms} (tol {GRAD_TOL} of 'xla'); "
          f"total_loss " + json.dumps({k: lg["total_loss"] for k, lg in logs.items()}))
    return logs


def gated_step(device, batch):
    """One step with ``value_pretrain_iters=1``: only ``td/total``'s
    gradient flows, so Adam (b1 = 0) leaves every policy-head parameter bit
    for bit as it was, while the winloss tower moves."""
    import torch

    lrn = rl_learner(device, value_pretrain_iters=1)
    before = {n: p.detach().clone() for n, p in lrn.model.named_parameters()}
    log = lrn._train(batch)
    check(finite(log), "gated step: a non-finite loss or grad_norm")
    moved = {n for n, p in lrn.model.named_parameters() if not torch.equal(p, before[n])}
    policy = [n for n in before if n.startswith("policy.")]
    check(not moved & set(policy), f"gated step moved policy parameters {sorted(moved & set(policy))[:4]}")
    check("value_winloss.Dense_0.weight" in moved, "gated step: the winloss tower did not move")
    groups = sorted({n.split(".")[0] for n in moved})
    print(f"rl gated step (value_pretrain_iters=1): {len(policy)} policy-head parameters bit-equal, "
          f"moved {groups}; td/total {log['td/total']:.4f} total_loss {log['total_loss']:.4f}")
    return groups


def phase_rl(device, rng):
    """The RL and distillation learners on the card (module docstring,
    phase 6). Returns the launch counts of their paths and the measurements."""
    import torch

    from distar_tpu_torch.learner import FakeRLDataloader, distill_loss, random_rl_batch, rl_loss
    from distar_tpu_torch.ops import kernels as K

    print(f"rl: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    # one fixed batch of random in-range observations, 68 observed frames
    batch = random_rl_batch(RL_B, RL_T, rng)
    entity_num = batch["entity_num"].reshape(-1)
    inputs, rl_err = train_kernel_grads(K, rng, device, entity_num)
    rl_kernel_ms = train_kernel_times(K, inputs, "rl")
    del inputs
    inputs, student_err = train_kernel_grads(K, rng, device, entity_num, Dh=64, D=16)
    student_kernel_ms = train_kernel_times(K, inputs, "student")
    del inputs

    K.reset_launch_counts()
    learners = {impl: rl_learner(device, impl) for impl in STRINGS}
    rl_fn = lambda lrn, tb: rl_loss(lrn.model, lrn.loss_cfg, tb, RL_B, RL_T)  # noqa: E731
    grads = {"rl_zero_obs": hold_strings("rl loss on a FakeRLDataloader batch (zero observations)",
                                         learners, next(FakeRLDataloader(RL_B, RL_T)), rl_fn),
             "rl_random": hold_strings("rl loss on the random batch", learners, batch, rl_fn,
                                       rl_faults(batch))}
    steps_agree("rl step", learners, batch)
    gated = gated_step(device, batch)
    launches = dict(K.launch_counts)  # the strings' steps and the gated step

    lrn = rl_learner(device, log_freq=1)
    losses, rl_launches = entry_point(K, lrn, RL_ITERS, "rl entry point (RLLearner.run, flagship)")
    stale = {k: v for k, v in lrn.last_log.items() if k.startswith("staleness/")}
    print(f"rl entry point: staleness after the last step {stale}")
    del lrn
    step_ms, all_ms = step_times(learners, batch)
    memory = {impl: step_memory(lrn, batch)[0] for impl, lrn in learners.items()}
    profiles = {impl: profile_call(lambda: lrn._train(batch)) for impl, lrn in learners.items()}
    del learners

    lrn16 = rl_learner(device, dtype="bfloat16")
    log16 = lrn16._train(batch)
    check(finite(log16), f"bf16 RL step: loss {log16['total_loss']} grad_norm {log16['grad_norm']}")
    print(f"rl bf16 step (kernel overlay): total_loss {log16['total_loss']:.4f} "
          f"grad_norm {log16['grad_norm']:.3f}")
    del lrn16

    # the reference's per-GPU shape: 6 trajectories x 64 steps (390 frames)
    big_batch = next(FakeRLDataloader(RL_BIG_B, RL_BIG_T, seed=1))
    big = rl_learner(device, B=RL_BIG_B, T=RL_BIG_T)
    big_ms, big_all = step_times({"pallas": big}, big_batch, rounds=3, warmup=1)
    big_memory, big_log = step_memory(big, big_batch)
    check(finite(big_log), "6 x 64 RL step: a non-finite loss or grad_norm")
    print(f"rl 6 x 64 step (kernel overlay, f32): ms {big_all['pallas']} total_loss "
          f"{big_log['total_loss']:.4f} memory {big_memory}")
    del big, big_batch

    # the distillation student, one step per string from the same weights
    students = {impl: distill_learner(device, impl) for impl in STRINGS}
    d_fn = lambda lrn, tb: distill_loss(lrn.model, lrn.loss_cfg, tb, RL_B, RL_T)  # noqa: E731
    K.reset_launch_counts()
    grads["distill_random"] = hold_strings("distill loss on the random batch", students, batch, d_fn,
                                           {"crossed layout": (d_fn, crossed(batch), True)})
    steps_agree("distill step", students, batch)
    d_strings = dict(K.launch_counts)
    lrn = distill_learner(device, log_freq=1)
    d_losses, d_launches = entry_point(K, lrn, DISTILL_ITERS,
                                       "distill entry point (DistillLearner.run, student)")
    del lrn
    d_ms, d_all = step_times(students, batch)
    d_profile = profile_call(lambda: students["pallas"]._train(batch))
    del students

    paths = {"rl strings": launches, "rl entry point": rl_launches,
             "distill strings": d_strings, "distill entry point": d_launches}
    launches = {name: sum(p[name] for p in paths.values()) for name in launches}
    print(f"rl phase launches, each read from zero around its run: {json.dumps(paths)}")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the RL path")
    frames = RL_T * RL_B
    result = {"step_ms": step_ms, "step_ms_all": all_ms,
              "rl_frames_per_s": {impl: frames / (ms / 1e3) for impl, ms in step_ms.items()},
              "memory": memory, "step_profile": profiles, "gated_moved": gated,
              "entry_point_losses": losses, "staleness": stale, "gradients": grads,
              "distill_entry_point_losses": d_losses,
              "big_step_ms": big_ms["pallas"], "big_step_ms_all": big_all["pallas"],
              "big_frames_per_s": RL_BIG_T * RL_BIG_B / (big_ms["pallas"] / 1e3), "big_memory": big_memory,
              "distill_step_ms": d_ms, "distill_step_ms_all": d_all, "distill_profile": d_profile,
              "rl_kernel_ms": rl_kernel_ms, "student_kernel_ms": student_kernel_ms,
              "rl_kernel_max_abs_err": rl_err, "student_kernel_max_abs_err": student_err,
              "launches": launches, "launches_by_path": paths}
    print(json.dumps({"rl": result}))
    return launches, result


def smi_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from distar_tpu_torch.ops import build, kernels
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port package is not beside this script ({e})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    try:
        # 1. device
        device = torch.device("cuda")
        print(smi_line())
        kind = torch.cuda.get_device_name(0)
        print(f"device {kind}, torch {torch.__version__}, cuda {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        # 2. build
        t0 = time.perf_counter()
        per = build.build()
        print(f"build: {time.perf_counter() - t0:.1f} s wall, per source {per}")
        for name in build.KERNELS:
            for ln in build.build_log(name).splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"ptxas {name}: {ln.strip()}")

        # 3. kernels
        rng = np.random.default_rng(0)
        records = phase_kernels(device, rng)
        for name, rec in records.items():
            print(f"kernel {name}: ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
                  f"library_ms {rec['library_ms']:.4f} bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})")

        # 4. serve
        launches, flush_ms = phase_serve(device, rng)
        for name in build.KERNELS:
            check(launches.get(name, 0) > 0, f"{name} never launched on the serve path")

        # 5. train
        train_launches, train = phase_train(device, rng)

        # 6. RL and distillation
        rl_launches, rl = phase_rl(device, rng)
        print(f"launches: serve {launches}, train {train_launches}, rl and distill {rl_launches}")
        launches = {name: launches[name] + train_launches[name] + rl_launches[name]
                    for name in build.KERNELS}

        # 7. the kernels line; max_abs_err over the serve shapes and the f32
        # SL, RL and student training shapes
        errs = {**train["train_kernel_max_abs_err"],
                **{f"rl {k}": v for k, v in rl["rl_kernel_max_abs_err"].items()},
                **{f"student {k}": v for k, v in rl["student_kernel_max_abs_err"].items()}}
        for name, rec in records.items():
            rec["max_abs_err"] = max([rec["max_abs_err"]] + [
                err for key, err in errs.items()
                if key.split(" ")[-1].startswith(name) and not key.endswith("bfloat16")])
        line = {"kernels": [
            {"name": name, "route": "cuda", "source": rec["source"], "replaces": rec["replaces"],
             "launches": launches[name], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
             "library_ms": rec["library_ms"]}
            for name, rec in records.items()]}
        print(json.dumps({"serve_flush_ms": flush_ms, "train_step_ms": train["step_ms"],
                          "sl_frames_per_s": train["sl_frames_per_s"], "rl_step_ms": rl["step_ms"],
                          "rl_frames_per_s": rl["rl_frames_per_s"],
                          "distill_step_ms": rl["distill_step_ms"],
                          "seconds": time.perf_counter() - t_start}))
        print(json.dumps(line))
    except Exception as e:  # every phase failure fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        kernels.reset_launch_counts()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
