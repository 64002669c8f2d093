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
5. serve_process — the serving process, flagship with the kernel overlay,
             f32, 32 slots, observations from a generator of its own:
             seeded weights written by the port's
             ``save_checkpoint`` as a learner checkpoint (v1, and v2 from
             another seed), verified, a byte-flipped and a truncated copy
             refused; the stack as ``bin/serve.py`` builds it (registry from
             the checkpoint, HTTP and TCP frontends): 8 sessions x 3 steps
             through ``ServeClient.act_many``, the teacher (v2) installed over
             TCP and asked for by half the lanes, one HTTP act, status and
             ``/metrics``; every output bit-equal to an in-process gateway
             given the same weights, seed and request order, teacher logits
             against ``teacher_step``, launches equal to the flushes derived
             from the script, ``/metrics`` counting the requests; a TCP hot
             swap to v2 and a swap under traffic; the wire's timings, with
             the serialization of one 32-lane request and answer; then
             ``python -m distar_tpu_torch.bin.serve`` as a process, one act,
             SIGTERM, exit 0. The wire is TCP only here.
6. serve_fleet — the serving fleet on the same model and checkpoints,
             observations from a generator of its own: a ``CoordinatorServer``
             in process; gateway A, the stack ``bin/serve.py`` builds, in
             process and registered with a deregister hook (its launches are
             read from zero around the fleet script); gateway B,
             ``python -m distar_tpu_torch.bin.serve --coordinator-addr`` as a
             process on the same card. a. the native shuttle: crc32 against
             zlib, the LZ4 codec round-tripping a 32-lane answer, the plain
             decoder on its stream, the native decoder on ``lz4_block``'s. c. a
             ``FleetClient`` discovers both and runs ``serve_script``: each
             session on its ``HashRing`` owner, every answer bit-equal to an
             in-process gateway fed that gateway's sessions in order. d.
             ``FleetRollout``: a canary of v2 on B (new sessions split by the
             hash, existing ones unmoved), promote, then a rollout of a
             missing checkpoint that NACKs and changes nothing. e. SIGTERM to
             B under traffic: it leaves discovery within one refresh, exits 0,
             its sessions migrate to A (counted), no request fails. f. a
             32-lane ``act_many`` against A in process, over TCP (``DTL0``) and
             over shared-memory rings sized from the answer, median of 8 in
             turns, the shm row failing on any fallback to TCP; the
             encode/decode split.
7. train   — the SL train step at flagship width and depth, f32, batch 2 x
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
8. rl      — the RL learner (``RL_LEARNER_DEFAULTS``, 4 x 16: 68 observed
             frames) and the distillation student at flagship width, f32:
             each kernel's Function at the RL shapes [68, 2, 512, 128] /
             [68, 512, 32] and the student's [68, 2, 512, 64] / [68, 512,
             16], held as in phase 6 and timed beside the library calls; the
             readings of the strings' gradient gap (``rl_gap``: repeat,
             mixed strings, intermediates, an f64 yardstick, the ReLU and
             max-pool kinks and UPGO's step) on the phase's batch and a
             seed-0 batch, held, and on zero observations, printed; the
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

The line before the last is the ``kernels`` JSON (launches: the serve,
serve-process, fleet (gateway A), SL, RL and distillation paths together,
each read from zero around its run);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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


# ---------------------------------------------------------- serve process
SERVE_LAYERS = 3  # default_model_config's entity transformer layers
SERVE_SESSIONS, SERVE_STEPS = 8, 3
WIRE_ROUNDS = 8


def lz4_block(data: bytes) -> bytes:
    """A greedy LZ4-block compressor in plain Python (4-byte hash table, the
    format's end rules: the last 5 bytes literals, no match starting in the
    last 12): the plain encoder the native codec's decoder
    (``comm/native/shuttle.cpp``) is held against. Its streams differ from
    the native encoder's, which matches greedily over a hash table of
    other width, and must decode all the same."""
    import struct

    out = bytearray()

    def length(v):
        while v >= 255:
            out.append(255)
            v -= 255
        out.append(v)

    def emit(lit, offset=None, mlen=0):
        ml = mlen - 4
        out.append((min(len(lit), 15) << 4) | (min(ml, 15) if offset else 0))
        if len(lit) >= 15:
            length(len(lit) - 15)
        out.extend(lit)
        if offset:
            out.extend(struct.pack("<H", offset))
            if ml >= 15:
                length(ml - 15)

    n, table, anchor, i = len(data), {}, 0, 0
    while i < n - 12:
        key = data[i:i + 4]
        j = table.get(key)
        table[key] = i
        if j is None or i - j > 0xFFFF:
            i += 1
            continue
        m, end = 4, n - 5
        while i + m + 64 <= end and data[j + m:j + m + 64] == data[i + m:i + m + 64]:
            m += 64
        while i + m < end and data[j + m] == data[i + m]:
            m += 1
        emit(data[anchor:i], i - j, m)
        i = anchor = i + m
    emit(data[anchor:])
    return bytes(out)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def learner_checkpoint(model):
    """A learner checkpoint of ``model``, as the JAX learners write them:
    ``{"params": flax params, "opt_state": optax's adam chain state}`` (the
    moments zero, the count 0)."""
    import numpy as np

    from distar_tpu_torch.model.convert import params_to_flax

    params = params_to_flax(model)

    def zeros(tree):
        return {k: zeros(v) for k, v in tree.items()} if isinstance(tree, dict) else np.zeros_like(tree)

    return {"params": params, "opt_state": ((), (np.int32(0), zeros(params), zeros(params)), ())}


def checkpoint_files(tmp, model, model_v2):
    """v1 and v2 written by the port's ``save_checkpoint``, v1 verified and
    a byte-flipped and a truncated copy of it refused. Returns (v1 path, v2
    path, readings)."""
    from distar_tpu_torch.utils import checkpoint as C

    v1, v2 = os.path.join(tmp, "v1.ckpt"), os.path.join(tmp, "v2.ckpt")
    t0 = time.perf_counter()
    C.save_checkpoint(v1, learner_checkpoint(model), metadata={"iter": 1, "player": "MP0"})
    write_s = time.perf_counter() - t0
    C.save_checkpoint(v2, learner_checkpoint(model_v2), metadata={"iter": 2, "player": "MP0"})
    check(C.verify_checkpoint(v1) and C.verify_checkpoint(v2), "checkpoint: verify_checkpoint failed")
    t0 = time.perf_counter()
    loaded = C.load_checkpoint(v1)
    read_s = time.perf_counter() - t0
    check(loaded["metadata"] == {"iter": 1, "player": "MP0"}, f"checkpoint metadata {loaded['metadata']}")
    blob = open(v1, "rb").read()
    refused = {}
    for name, bad in (("flipped", blob[:len(blob) // 2] + bytes([blob[len(blob) // 2] ^ 0x40])
                       + blob[len(blob) // 2 + 1:]), ("truncated", blob[:-1000])):
        path = os.path.join(tmp, f"v1_{name}.ckpt")
        with open(path, "wb") as f:
            f.write(bad)
        with open(path + ".manifest", "wb") as f:
            f.write(open(v1 + ".manifest", "rb").read())
        check(not C.verify_checkpoint(path), f"checkpoint: the {name} copy verifies")
        try:
            C.load_checkpoint(path)
        except C.CheckpointCorruptError as e:
            refused[name] = str(e)[:90]
        else:
            raise SmokeFailure(f"checkpoint: the {name} copy loaded")
        os.unlink(path)
    return v1, v2, {"bytes": len(blob), "write_s": write_s, "read_s": read_s, "refused": refused}


def stop_all(stack):
    """Stop the frontends and gateways of ``stack``, last started first,
    and empty it."""
    while stack:
        part = stack.pop()
        if hasattr(part, "drain_and_stop"):
            part.drain_and_stop()
        else:
            part.stop()


def same_outputs(got, want, what):
    """Served outputs bit-equal to the in-process gateway's: every action,
    logit and log-prob, and the version and step fields."""
    import numpy as np

    for g, w in zip(got, want):
        check(isinstance(g, dict) and isinstance(w, dict), f"{what}: an error {g!r} / {w!r}")
        for key in ("model_version", "session_step"):
            check(g[key] == w[key], f"{what}: {key} {g[key]} vs {w[key]}")
        for part in ("action_info", "action_logp", "logit") + (("teacher_logit",) if "teacher_logit" in w
                                                              else ()):
            check(part in g, f"{what}: no {part} in the served output")
            for k, v in w[part].items():
                check(np.array_equal(g[part][k], v), f"{what}: {part}[{k}] differs from the in-process "
                      f"gateway's (max abs {np.abs(np.asarray(g[part][k], float) - v).max()})")


def serve_script(act_many, set_teacher, act, obs, teacher, sids=None):
    """The served request script, run on the served stack and on the
    in-process gateway alike: SERVE_SESSIONS sessions (``sids``, by default
    s0, s1, ...) x SERVE_STEPS steps, one ``act_many`` a step; the
    ``teacher`` weights installed after the first step and asked for by the
    even sessions from then on; one more ``act`` for the first session
    (over HTTP on the served stack). Returns every output, in order."""
    sids = sids or [f"s{i}" for i in range(SERVE_SESSIONS)]
    outs = []
    for step in range(SERVE_STEPS):
        if step == 1:
            set_teacher(teacher)
        outs.append(act_many([{"session_id": sids[i], "obs": obs[i][step],
                               **({"want_teacher": True} if step and i % 2 == 0 else {})}
                              for i in range(SERVE_SESSIONS)]))
    outs.append([act(sids[0], obs[0][SERVE_STEPS])])
    return outs


def phase_serve_process(device, rng, smi, tmp):
    """The serving process on the card (module docstring, phase 5). The
    checkpoints v1 and v2 stay in ``tmp`` for the fleet phase. Returns the
    launch counts of its served requests and its readings."""
    import signal
    import threading
    import urllib.request

    import numpy as np

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.bin import serve as serve_bin
    from distar_tpu_torch.comm import serializer, shuttle
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.obs import MetricsRegistry, set_registry
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.serve import (BatchedInferenceEngine, InferenceGateway, ServeClient,
                                        ServeHTTPServer, ServeTCPServer)
    from distar_tpu_torch.serve.http_frontend import jsonable

    cfg = overlay("pallas", "pallas")
    model, model_v2 = build_model(cfg, 0), build_model(cfg, 1)
    v1_state = {k: v.cpu() for k, v in model.state_dict().items()}
    v2_state = {k: v.cpu() for k, v in model_v2.state_dict().items()}
    proc, stack = None, []
    try:
        v1, v2, ckpt = checkpoint_files(tmp, model, model_v2)
        del model, model_v2
        obs = [[F.random_step_data(rng) for _ in range(SERVE_STEPS + 1)] for _ in range(SERVE_SESSIONS)]

        # the stack as bin/serve.py builds it, on a registry of its own
        set_registry(MetricsRegistry())
        args = serve_bin.parser().parse_args([
            "--checkpoint", v1, "--slots", str(SLOTS), "--max-delay-ms", "50", "--device", device.type,
            "--config", json.dumps({"model": cfg})])
        gw = serve_bin.build_gateway(args)
        gw.start()
        stack.append(gw)
        http = ServeHTTPServer(gw, port=0).start()
        stack.append(http)
        # this phase's wire is TCP: the fleet phase holds the rings
        tcp = ServeTCPServer(gw, port=0, transport="tcp").start()
        stack.append(tcp)
        client = ServeClient(tcp.host, tcp.port, timeout_s=60.0, transport="tcp")
        status = gw.registry.status()["versions"]["v1"]
        url = f"http://{http.host}:{http.port}"

        def post(route, body):
            req = urllib.request.Request(url + route, json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        http_ms = []

        def served_http(session, o):
            t0 = time.perf_counter()
            resp = post("/serve/act", {"session_id": session, "obs": jsonable(o)})
            http_ms.append((time.perf_counter() - t0) * 1e3)
            check(resp["code"] == 0, f"HTTP act: {resp}")
            return {part: ({k: np.asarray(v) for k, v in val.items()} if isinstance(val, dict) else val)
                    for part, val in resp["info"].items()}

        K.reset_launch_counts()
        served = serve_script(client.act_many, client.set_teacher, served_http, obs, v2_state)
        launches = dict(K.launch_counts)
        flushes, teacher_flushes = gw.flushes, gw.teacher_flushes
        metrics = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
        http_status = post("/serve/status", {})
        want_flushes = SERVE_STEPS + 1  # one flush a step, one for the HTTP act
        want_teacher = SERVE_STEPS - 1  # the steps whose lanes asked for teacher logits
        check((flushes, teacher_flushes) == (want_flushes, want_teacher),
              f"served flushes {flushes} and teacher flushes {teacher_flushes}, want {want_flushes} "
              f"and {want_teacher}")
        want = {"masked_attention": SERVE_LAYERS * (want_flushes + want_teacher),
                "scatter_add_connection": want_flushes + want_teacher, "scatter_add_onehot": 0}
        check(launches == want, f"served launches {launches}, want {want}")
        sent = SERVE_SESSIONS * SERVE_STEPS + 1
        line = f'distar_serve_requests_total{{outcome="ok"}} {sent}'
        check(line in metrics.splitlines(), f"/metrics does not count {sent} ok requests: "
              + " | ".join(ln for ln in metrics.splitlines() if ln.startswith("distar_serve_requests")))
        flush_lines = [ln.split() for ln in metrics.splitlines() if ln.startswith("distar_serve_flush_total{")]
        check(sum(float(v) for _, v in flush_lines) == want_flushes, f"/metrics flushes {flush_lines}")
        check(http_status["code"] == 0 and http_status["info"]["generation"] == 1, f"/serve/status {http_status}")

        # the in-process gateway: the same weights as params, seed, order
        set_registry(MetricsRegistry())
        ref_infer = BatchedInference(build_model(cfg, 0, v1_state), SLOTS, seed=args.seed, device=device)
        ref = InferenceGateway(BatchedInferenceEngine(ref_infer), max_delay_s=0.05).start()
        stack.append(ref)
        ref.load_version("v1", params=v1_state, activate=True)

        want_out = serve_script(ref.act_many, ref.set_teacher, ref.act, obs, v2_state)
        for step, (g, w) in enumerate(zip(served, want_out)):
            same_outputs(g, w, f"served step {step}")
        check(all("teacher_logit" in served[s][i] for s in (1, 2) for i in range(0, SERVE_SESSIONS, 2)),
              "teacher logits missing")
        # teacher logits against teacher_step on an in-process engine (the
        # lanes that did not ask hold other actions here than in the served
        # flush; each lane's logits depend on its own inputs only)
        t_infer = BatchedInference(build_model(cfg, 0, v1_state), SLOTS, seed=args.seed, device=device)
        t_infer.set_teacher_params(v2_state)
        teacher_err = 0.0
        for step in (1, 2):
            active = [i < SERVE_SESSIONS and i % 2 == 0 for i in range(SLOTS)]
            prepared = [obs[i][step] if i < SERVE_SESSIONS else ref._template for i in range(SLOTS)]
            outs = [served[step][i if i < SERVE_SESSIONS else 0] for i in range(SLOTS)]
            t_out = t_infer.teacher_step(prepared, outs, active)
            for i in range(0, SERVE_SESSIONS, 2):
                for k, v in t_out[i].items():
                    got, live = served[step][i]["teacher_logit"][k], v > -1e8
                    check(np.array_equal(got > -1e8, live), f"teacher logit {k} masks differ")
                    teacher_err = max(teacher_err, float(np.abs(got[live] - v[live]).max(initial=0.0)))
        check(teacher_err <= LOGIT_TOL, f"teacher logits vs teacher_step: max abs err {teacher_err}")
        del t_infer
        print(f"serve_process outputs: {len(served) - 1} act_many frames x {SERVE_SESSIONS} sessions and "
              f"one HTTP act bit-equal to the in-process gateway (actions, logits, log-probs, teacher "
              f"logits on {SERVE_SESSIONS // 2} lanes x 2 steps); teacher logits vs teacher_step max abs err "
              f"{teacher_err:.3e} (tol {LOGIT_TOL}); launches {launches} "
              f"= {SERVE_LAYERS} x ({want_flushes} + {want_teacher}) flushes; /metrics ok requests {sent}")

        # hot swap: TCP load of v2, swap; the next flush serves v2 on both
        info = client.load("v2", source=v2)
        gen = client.swap("v2")
        ref.load_version("v2", params=v2_state, activate=True)
        req = [{"session_id": f"s{i}", "obs": obs[i][SERVE_STEPS]} for i in range(SERVE_SESSIONS)]
        after, after_ref = client.act_many(req), ref.act_many(req)
        check(all(o["model_version"] == "v2" for o in after), "hot swap: not serving v2")
        same_outputs(after, after_ref, "after the swap")
        for i in range(SERVE_SESSIONS):
            client.end(f"s{i}")
            ref.end_session(f"s{i}")
        # and no request fails across a swap under traffic
        errors, done = [], threading.Event()

        def traffic():
            c = ServeClient(tcp.host, tcp.port, timeout_s=60.0, transport="tcp")
            while not done.is_set():
                for o in c.act_many([{"session_id": f"t{i}", "obs": obs[i][0]} for i in range(4)]):
                    if not isinstance(o, dict):
                        errors.append(repr(o))
            c.close()

        th = threading.Thread(target=traffic)
        th.start()
        client.load("v3", source=v1)
        client.swap("v3")
        time.sleep(0.5)
        done.set()
        th.join(120)
        check(not errors, f"requests failed across the swap: {errors[:3]}")
        check(client.status()["served_version"] == "v3", "the swap under traffic did not land")
        print(f"serve_process hot swap: TCP load v2 ({info['load_s']:.3f} s load, {info['warmup_s']:.3f} s "
              f"warm-up), swap to generation {gen}: the next flush served v2, bit-equal to the in-process "
              f"gateway; a swap under traffic failed no request")

        # the wire: act_many at 32 lanes, HTTP act, a DTL0 frame's decode
        for i in range(4):
            client.end(f"t{i}")
        lanes = [{"session_id": f"w{i}", "obs": obs[i % SERVE_SESSIONS][0]} for i in range(SLOTS)]
        wire_ms, flush_ms = [], []
        for _ in range(WIRE_ROUNDS):
            t0 = time.perf_counter()
            check(all(isinstance(o, dict) for o in client.act_many(lanes)), "a 32-lane act_many failed")
            wire_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            outputs = ref.act_many(lanes)
            flush_ms.append((time.perf_counter() - t0) * 1e3)
            check(all(isinstance(o, dict) for o in outputs), "an in-process act_many failed")
        # the serialization inside that overhead: the 32-lane request and
        # its answer, each encoded and decoded as the client and server do
        split = {}
        for leg, msg in (("request", {"op": "act_many", "requests": lanes}),
                         ("response", {"code": 0, "results": [{"ok": o} for o in outputs]})):
            enc, dec = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                blob = serializer.dumps(msg)
                enc.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                serializer.loads(blob)
                dec.append((time.perf_counter() - t0) * 1e3)
            split[leg] = {"bytes": len(blob), "encode_ms": statistics.median(enc),
                          "decode_ms": statistics.median(dec)}
        raw = serializer.dumps({"op": "act", "session_id": "s0", "obs": obs[0][0]}, compress=False)[4:]
        frame = serializer.MAGIC_LZ + len(raw).to_bytes(8, "little") + lz4_block(raw)
        check(shuttle.lz_decompress(frame[12:], len(raw)) == raw,
              "the DTL0 frame does not decode to its payload")
        decode = []
        for _ in range(3):
            t0 = time.perf_counter()
            serializer.loads(frame)
            decode.append((time.perf_counter() - t0) * 1e3)
        wire = {"tcp_act_many_32_ms": statistics.median(wire_ms), "in_process_act_many_32_ms":
                statistics.median(flush_ms), "http_act_ms": http_ms[0],
                "dtl0_act_frame": {"bytes": len(frame), "raw_bytes": len(raw),
                                   "decode_ms": statistics.median(decode)}}
        wire["wire_overhead_ms"] = wire["tcp_act_many_32_ms"] - wire["in_process_act_many_32_ms"]
        wire["serialization"] = split
        wire["serialization_ms"] = sum(leg["encode_ms"] + leg["decode_ms"] for leg in split.values())
        print(f"serve_process wire split ({smi}): overhead {wire['wire_overhead_ms']:.2f} ms of which "
              f"serialization {wire['serialization_ms']:.2f} ms {json.dumps(split)}; the rest "
              f"(sockets, loopback, frontend threads) {wire['wire_overhead_ms'] - wire['serialization_ms']:.2f} ms")
        client.close()
        stop_all(stack)

        # the process: bin/serve.py on free ports, one act, SIGTERM
        http_port, tcp_port = free_port(), free_port()
        log_path = os.path.join(tmp, "serve.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "distar_tpu_torch.bin.serve", "--checkpoint", v1, "--slots", "8",
                 "--host", "127.0.0.1", "--http-port", str(http_port), "--tcp-port", str(tcp_port),
                 "--drain-timeout-s", "20", "--device", device.type, "--config", json.dumps({"model": cfg})],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        c = None
        while c is None:
            check(proc.poll() is None and time.perf_counter() - t0 < 300,
                  f"bin/serve.py did not answer: {open(log_path).read()[-2000:]}")
            try:
                c = ServeClient("127.0.0.1", tcp_port, timeout_s=60.0)
                c.ping()
            except OSError:
                c = None
                time.sleep(0.5)
        startup_s = time.perf_counter() - t0
        boot = c.status()["registry"]["versions"]["v1"]
        out = c.act("p0", obs[0][0])
        check(out["session_step"] == 1 and out["model_version"] == "v1", f"process act: {out.keys()}")
        c.close()
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        exit_s = time.perf_counter() - t1
        check(rc == 0, f"bin/serve.py exited {rc} on SIGTERM: {open(log_path).read()[-2000:]}")
        check(exit_s < 20, f"bin/serve.py took {exit_s:.1f} s to drain")
        proc = None
        result = {"checkpoint": ckpt, "registry": {"load_s": status["load_s"], "warmup_s": status["warmup_s"]},
                  "wire": wire, "process": {"startup_s": startup_s, "load_s": boot["load_s"],
                                            "warmup_s": boot["warmup_s"], "sigterm_exit_s": exit_s},
                  "launches": launches, "checkpoints": (v1, v2)}
        print(f"serve_process ({smi}): checkpoint {ckpt['bytes']} bytes, write {ckpt['write_s']:.3f} s, "
              f"read {ckpt['read_s']:.3f} s, flipped and truncated copies refused; registry load_s "
              f"{status['load_s']:.3f} warmup_s {status['warmup_s']:.3f}; TCP act_many at {SLOTS} lanes "
              f"{wire['tcp_act_many_32_ms']:.2f} ms (median of {WIRE_ROUNDS}) vs in-process "
              f"{wire['in_process_act_many_32_ms']:.2f} ms; HTTP act {wire['http_act_ms']:.2f} ms; DTL0 act "
              f"frame {len(frame)} bytes decoded in {wire['dtl0_act_frame']['decode_ms']:.2f} ms; "
              f"bin/serve.py up in {startup_s:.2f} s (load {boot['load_s']:.3f} s, warm-up "
              f"{boot['warmup_s']:.3f} s), exit 0 {exit_s:.2f} s after SIGTERM")
        print(json.dumps({"serve_process": result}))
        return launches, result
    finally:
        stop_all(stack)
        if proc is not None:
            proc.kill()
            proc.wait()
        set_registry(None)


# ------------------------------------------------------------- serve fleet
FLEET_LEASE_S = 30.0  # the gateways' registration lease
FLEET_REFRESH_S = 2.0  # FleetClient's re-discovery cadence
FLEET_CANARY_PCT = 50.0
FLEET_CANARY_SESSIONS = 8


def counter_sum(prefix):
    """The sum of the process registry's series whose name starts with
    ``prefix``, over every label set."""
    from distar_tpu_torch.obs import get_registry

    return sum(v for k, v in get_registry().snapshot().items() if k.startswith(prefix))


def split_sessions(ring, addrs):
    """SERVE_SESSIONS session ids that the ring spreads over every gateway
    of ``addrs``, two at least on each: those of the first prefix that
    does, so the choice depends on the addresses alone."""
    for prefix in "stuvwxyz":
        sids = [f"{prefix}{i}" for i in range(SERVE_SESSIONS)]
        owners = [ring.lookup(s) for s in sids]
        if all(owners.count(a) >= 2 for a in addrs):
            return sids
    raise SmokeFailure(f"no session prefix spreads over {addrs}")


def timed(fn, what):
    """(ms, result) of one call whose every answer must be an output."""
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    check(all(isinstance(o, dict) for o in out), f"{what}: {[o for o in out if not isinstance(o, dict)][:2]}")
    return ms, out


def phase_serve_fleet(device, rng, smi, v1, v2):
    """The serving fleet on the card (module docstring, phase 6). Returns the
    launch counts of gateway A's served requests and the readings."""
    import io
    import pickle
    import signal
    import threading
    import zlib

    import torch

    from distar_tpu_torch.actor import BatchedInference
    from distar_tpu_torch.bin import serve as serve_bin
    from distar_tpu_torch.comm import serializer, shuttle
    from distar_tpu_torch.comm.coordinator import CoordinatorServer
    from distar_tpu_torch.lib import features as F
    from distar_tpu_torch.obs import MetricsRegistry, set_registry
    from distar_tpu_torch.ops import kernels as K
    from distar_tpu_torch.replay.sharding import HashRing
    from distar_tpu_torch.serve import (BatchedInferenceEngine, InferenceGateway, ServeClient,
                                        ServeHTTPServer, ServeTCPServer)
    from distar_tpu_torch.serve.fleet import (FleetClient, FleetRollout, GatewayMap, fetch_canary,
                                              register_gateway)

    t_phase = time.perf_counter()
    cfg = overlay("pallas", "pallas")
    v1_state = {k: v.cpu() for k, v in build_model(cfg, 0).state_dict().items()}
    v2_state = {k: v.cpu() for k, v in build_model(cfg, 1).state_dict().items()}
    obs = [[F.random_step_data(rng) for _ in range(SERVE_STEPS + 1)] for _ in range(SERVE_SESSIONS)]
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    log_b = os.path.join(log_dir, "gateway_b.log")
    set_registry(MetricsRegistry())  # the phase's series, fleet and shm included
    stack, proc, fc, ctl, clients = [], None, None, None, []
    result = {}
    try:
        coord_srv = CoordinatorServer(port=0)
        coord_srv.start()
        stack.append(coord_srv)
        coord = (coord_srv.host, coord_srv.port)
        serve_flags = ["--slots", str(SLOTS), "--max-delay-ms", "50", "--device", device.type,
                       "--config", json.dumps({"model": cfg})]

        # b. gateway B, bin/serve.py as a process on this card, starts while
        # gateway A (the stack bin/serve.py builds, in process) is built.
        # Both hold float32 as float32: the port's device rule turns TF32
        # off (actor.inference.resolve_device)
        t0 = time.perf_counter()
        with open(log_b, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "distar_tpu_torch.bin.serve", "--checkpoint", v1, "--host", "127.0.0.1",
                 "--http-port", "0", "--tcp-port", "0", "--drain-timeout-s", "20", "--coordinator-addr",
                 f"{coord_srv.host}:{coord_srv.port}", "--lease-s", str(FLEET_LEASE_S), *serve_flags],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        args = serve_bin.parser().parse_args(["--checkpoint", v1, *serve_flags])
        gw_a = serve_bin.build_gateway(args).start()
        stack.append(gw_a)
        http_a = ServeHTTPServer(gw_a, host="127.0.0.1", port=0).start()
        stack.append(http_a)
        tcp_a = ServeTCPServer(gw_a, host="127.0.0.1", port=0).start()
        stack.append(tcp_a)
        addr_a = f"{tcp_a.host}:{tcp_a.port}"
        register_gateway(coord, tcp_a.host, tcp_a.port,
                         meta={"players": [], "slots": SLOTS, "http_port": http_a.port, "version": "v1",
                               "mock": False}, lease_s=FLEET_LEASE_S, target=gw_a)
        while True:
            check(proc.poll() is None and time.perf_counter() - t0 < 300,
                  f"gateway B did not register: {open(log_b).read()[-2000:]}")
            gmap = GatewayMap.discover(coord)
            if len(gmap) == 2:
                break
            time.sleep(0.5)
        startup_b = time.perf_counter() - t0
        addr_b = next(a for a in gmap.addrs if a != addr_a)
        check(gmap.meta[addr_b]["slots"] == SLOTS and gmap.meta[addr_a]["http_port"] == http_a.port,
              f"registration meta {gmap.meta}")

        # c. affinity: serve_script through a FleetClient that discovered
        # both; each answer bit-equal to an in-process gateway fed what the
        # ring sent that gateway, in the same order
        fc = FleetClient(coordinator_addr=coord, timeout_s=120.0, refresh_s=FLEET_REFRESH_S)
        ring = HashRing(sorted(gmap.addrs))
        sids = split_sessions(ring, gmap.addrs)
        owner = {s: ring.lookup(s) for s in sids}
        flushes0, teacher0 = gw_a.flushes, gw_a.teacher_flushes
        K.reset_launch_counts()
        served = serve_script(fc.act_many, fc.set_teacher, fc.act, obs, v2_state, sids=sids)
        launches = dict(K.launch_counts)
        flushes, teacher_flushes = gw_a.flushes - flushes0, gw_a.teacher_flushes - teacher0
        check({s: fc.router.gateway_for(s) for s in sids} == owner,
              f"pins {fc.router.stats()['pins_per_gateway']} are not the ring's owners")
        want = {"masked_attention": SERVE_LAYERS * (flushes + teacher_flushes),
                "scatter_add_connection": flushes + teacher_flushes, "scatter_add_onehot": 0}
        want_flushes = SERVE_STEPS + (owner[sids[0]] == addr_a)
        check(launches == want and flushes == want_flushes and teacher_flushes == SERVE_STEPS - 1,
              f"gateway A launches {launches} for {flushes} + {teacher_flushes} flushes, want {want} "
              f"and {want_flushes} + {SERVE_STEPS - 1}")
        for addr in gmap.addrs:
            ref = InferenceGateway(BatchedInferenceEngine(BatchedInference(
                build_model(cfg, 0, v1_state), SLOTS, seed=args.seed, device=device)), max_delay_s=0.05).start()
            ref.load_version("v1", params=v1_state, activate=True)

            def act_many(reqs, ref=ref, addr=addr):
                outs = iter(ref.act_many([r for r in reqs if owner[r["session_id"]] == addr]))
                return [next(outs) if owner[r["session_id"]] == addr else None for r in reqs]

            def act(s, o, ref=ref, addr=addr):
                return ref.act(s, o) if owner[s] == addr else None

            try:
                want_out = serve_script(act_many, ref.set_teacher, act, obs, v2_state, sids=sids)
            finally:
                ref.drain_and_stop()
            del ref
            for step, (g, w) in enumerate(zip(served, want_out)):
                kept = [(gi, wi) for gi, wi in zip(g, w) if wi is not None]
                same_outputs([k[0] for k in kept], [k[1] for k in kept],
                             f"fleet step {step}, gateway {'A' if addr == addr_a else 'B'}")
        torch.cuda.empty_cache()
        on_b = [s for s in sids if owner[s] == addr_b]
        result["affinity"] = {"sessions_on_a": len(sids) - len(on_b), "sessions_on_b": len(on_b),
                              "gateway_b_startup_s": startup_b, "gateway_a_launches": launches}
        print(f"serve_fleet affinity: {len(sids)} sessions x {SERVE_STEPS} act_many steps + 1 act through "
              f"FleetClient, {len(sids) - len(on_b)} on A (in process) and {len(on_b)} on B (bin/serve.py "
              f"process, registered {startup_b:.2f} s after its start), each on its HashRing owner; every "
              f"answer bit-equal to an in-process gateway fed its gateway's sessions in order (teacher logits "
              f"on the even sessions); gateway A launches {launches} = {SERVE_LAYERS} x ({flushes} + "
              f"{teacher_flushes} teacher) flushes")

        # d. rollout: a canary on B, promote, then a rollout whose load NACKs
        ctl = FleetRollout(GatewayMap.discover(coord), timeout_s=300.0, coordinator_addr=coord)
        t0 = time.perf_counter()
        verdict = ctl.canary_start("v2", [addr_b], FLEET_CANARY_PCT, source=v2, router=fc.router)
        canary_s = time.perf_counter() - t0
        check(verdict["ok"], f"canary_start: {verdict}")
        check(fetch_canary(coord) == {"addrs": [addr_b], "pct": FLEET_CANARY_PCT, "version": "v2"},
              f"published canary {fetch_canary(coord)}")
        canary_sids = [f"c{i}" for i in range(FLEET_CANARY_SESSIONS)]
        _, outs = timed(lambda: fc.act_many([{"session_id": c, "obs": obs[i % SERVE_SESSIONS][0]}
                                             for i, c in enumerate(canary_sids)]), "canary sessions")
        to_b = [fc.router.is_canary_session(c) for c in canary_sids]
        check(0 < sum(to_b) < len(canary_sids), f"the canary split put {sum(to_b)} of {len(canary_sids)} on B")
        for c, b, o in zip(canary_sids, to_b, outs):
            check(fc.router.gateway_for(c) == (addr_b if b else addr_a), f"canary session {c} misrouted")
            check(o["model_version"] == ("v2" if b else "v1"), f"canary session {c}: {o['model_version']}")
        _, outs = timed(lambda: fc.act_many([{"session_id": s, "obs": obs[i][0]} for i, s in enumerate(sids)]),
                        "existing sessions under the canary")
        for s, o in zip(sids, outs):
            check(fc.router.gateway_for(s) == owner[s], f"session {s} moved for the canary")
            check(o["model_version"] == ("v2" if owner[s] == addr_b else "v1"), f"session {s}: {o['model_version']}")
        t0 = time.perf_counter()
        verdict = ctl.promote("v2", source=v2, router=fc.router)
        promote_s = time.perf_counter() - t0
        check(verdict["ok"] and fc.router.canary_config() == ([], 0.0) and fetch_canary(coord)["pct"] == 0.0,
              f"promote: {verdict}")
        every = sids + canary_sids
        lanes_every = [{"session_id": s, "obs": obs[i % SERVE_SESSIONS][1]} for i, s in enumerate(every)]
        _, outs = timed(lambda: fc.act_many(lanes_every), "after promote")
        check(all(o["model_version"] == "v2" for o in outs), "promote: not every gateway serves v2")
        nack = ctl.rollout("v3", source=os.path.join(log_dir, "missing.ckpt"))
        current = {a: st.get("registry", {}).get("current") for a, st in ctl.fleet_status().items()}
        check(not nack["ok"] and nack["outcome"] == "load_nack", f"rollout of a missing checkpoint: {nack}")
        check(current == {addr_a: "v2", addr_b: "v2"}, f"after the NACKed rollout: {current}")
        _, outs = timed(lambda: fc.act_many(lanes_every), "after the NACKed rollout")
        check(all(o["model_version"] == "v2" for o in outs), "the NACKed rollout changed a served version")
        result["rollout"] = {"canary_start_s": canary_s, "promote_s": promote_s, "canary_on_b": sum(to_b),
                             "canary_sessions": len(canary_sids), "nack": nack["outcome"]}
        print(f"serve_fleet rollout: canary v2 on B at {FLEET_CANARY_PCT:g}% ({canary_s:.2f} s): "
              f"{sum(to_b)} of {len(canary_sids)} new sessions on B answering v2, the rest on A answering v1, "
              f"existing sessions unmoved; promote ({promote_s:.2f} s): every gateway v2; a rollout of a "
              f"missing checkpoint answered {nack['outcome']} and left {current}")

        # e. drain: SIGTERM B under traffic
        steps = {s: [] for s in every}
        untyped, rounds, stop_traffic = [], [0], threading.Event()
        migrations0 = counter_sum("distar_fleet_session_migrations_total")
        reroutes0 = counter_sum("distar_fleet_reroutes_total")
        on_b = [s for s in every if fc.router.gateway_for(s) == addr_b]

        def traffic():
            while not stop_traffic.is_set():
                for s, o in zip(every, fc.act_many(lanes_every)):
                    if isinstance(o, dict):
                        steps[s].append(o["session_step"])
                    else:
                        untyped.append(repr(o))
                rounds[0] += 1

        th = threading.Thread(target=traffic, name="fleet-traffic")
        th.start()
        try:
            while rounds[0] < 1:
                check(th.is_alive(), "the traffic thread died")
                time.sleep(0.01)
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            while addr_b in GatewayMap.discover(coord):
                check(time.perf_counter() - t0 < FLEET_LEASE_S, "B stayed in discovery for its whole lease")
                time.sleep(0.02)
            left_s = time.perf_counter() - t0
            rc = proc.wait(timeout=120)
            exit_s = time.perf_counter() - t0
            r0 = rounds[0]
            while rounds[0] < r0 + 2 and th.is_alive():
                time.sleep(0.01)
        finally:
            stop_traffic.set()
            th.join(300)
        log_tail = open(log_b).read()[-2000:]
        check(rc == 0 and "drained; bye" in log_tail, f"gateway B exited {rc}: {log_tail}")
        proc = None
        check(left_s < FLEET_REFRESH_S, f"B left discovery {left_s:.2f} s after SIGTERM, past one refresh")
        check(not untyped, f"requests failed untyped in the drain: {untyped[:3]}")
        check(all(fc.router.gateway_for(s) == addr_a for s in every), "a session was left on B")
        migrations = counter_sum("distar_fleet_session_migrations_total") - migrations0
        reroutes = counter_sum("distar_fleet_reroutes_total") - reroutes0
        check(migrations == len(on_b) and reroutes >= len(on_b),
              f"{len(on_b)} sessions on B: {migrations} migrations, {reroutes} reroutes")
        for s in every:
            seq = steps[s]
            drops = [k for k in range(1, len(seq)) if seq[k] != seq[k - 1] + 1]
            if s in on_b:
                check(len(drops) == 1 and seq[drops[0]] == 1, f"migrated session {s} steps {seq}")
            else:
                check(not drops, f"session {s} on A restarted: {seq}")
        result["drain"] = {"left_discovery_s": left_s, "exit_s": exit_s, "sessions_migrated": len(on_b),
                           "migrations": migrations, "reroutes": reroutes, "traffic_rounds": rounds[0]}
        print(f"serve_fleet drain: SIGTERM to B under traffic; B left discovery after {left_s:.3f} s (lease "
              f"{FLEET_LEASE_S:g} s, refresh {FLEET_REFRESH_S:g} s), finished its admitted requests and exited 0 "
              f"{exit_s:.2f} s after the signal; its {len(on_b)} sessions moved to A (migrations {migrations:g}, "
              f"reroutes {reroutes:g}), session_step restarting at 1, in {rounds[0]} rounds no request failed")

        # f. the wire at 32 lanes against A: in process, TCP (DTL0), shm
        for s in every:
            fc.end(s)
        lanes = [{"session_id": f"w{i}", "obs": obs[i % SERVE_SESSIONS][0]} for i in range(SLOTS)]
        _, outputs = timed(lambda: gw_a.act_many(lanes), "a 32-lane act_many in process")
        request = {"op": "act_many", "requests": lanes}
        answer = {"code": 0, "results": [{"ok": o} for o in outputs]}
        raw_bytes = {leg: len(serializer.dumps(msg, compress=False)) for leg, msg in
                     (("request", request), ("response", answer))}
        ring_bytes = -(-(int(1.25 * max(raw_bytes.values())) + (1 << 16)) // 4096) * 4096
        try:
            shm_free = shutil.disk_usage("/dev/shm").free
        except OSError:
            shm_free = None
        print(f"serve_fleet wire: ring_bytes {ring_bytes} (raw request {raw_bytes['request']} and answer "
              f"{raw_bytes['response']} bytes; the default ring is 4 MiB), /dev/shm free {shm_free} bytes")
        check(shm_free is None or shm_free >= 2 * ring_bytes, f"/dev/shm has {shm_free} bytes free, two rings "
              f"need {2 * ring_bytes}")

        # a. the native shuttle on the 32-lane answer
        t0 = time.perf_counter()
        shuttle.build()
        build_s = time.perf_counter() - t0
        raw = pickle.dumps(answer, protocol=5)
        check(shuttle.crc32(raw) == zlib.crc32(raw), "native crc32 differs from zlib.crc32")
        t0 = time.perf_counter()
        stream = shuttle.lz_compress(raw)
        lz_enc = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        check(shuttle.lz_decompress(stream, len(raw)) == raw, "the native LZ4 does not round-trip the answer")
        lz_dec = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        check(shuttle.py_lz_decompress(stream, len(raw)) == raw,
              "the plain decoder reads the native stream otherwise")
        plain_dec = (time.perf_counter() - t0) * 1e3
        act_raw = serializer.dumps({"op": "act", "session_id": "w0", "obs": obs[0][0]}, compress=False)[4:]
        block = lz4_block(act_raw)
        check(shuttle.lz_decompress(block, len(act_raw)) == act_raw,
              "the native decoder reads lz4_block's stream otherwise")
        result["shuttle"] = {"library_build_or_load_s": build_s, "answer_bytes": len(raw),
                             "lz4_bytes": len(stream), "encode_ms": lz_enc, "decode_ms": lz_dec,
                             "plain_decode_ms": plain_dec, "lz4_block_frame_bytes": len(block)}
        print(f"serve_fleet shuttle: crc32 = zlib.crc32; the 32-lane answer ({len(raw)} bytes) LZ4 {len(stream)} "
              f"bytes, native encode {lz_enc:.2f} ms / decode {lz_dec:.2f} ms, round trip exact; the plain "
              f"decoder reads it to the same bytes in {plain_dec:.1f} ms; the native decoder reads lz4_block's "
              f"act frame ({len(block)} of {len(act_raw)} bytes)")

        tcp_client = ServeClient(tcp_a.host, tcp_a.port, timeout_s=120.0, transport="tcp")
        clients.append(tcp_client)
        wire_srv = ServeTCPServer(gw_a, host="127.0.0.1", port=0, ring_bytes=ring_bytes).start()
        stack.append(wire_srv)
        shm_client = ServeClient(wire_srv.host, wire_srv.port, timeout_s=120.0, transport="shm")
        clients.append(shm_client)
        check(shm_client.transport_active == "shm", "the shm client got no rings")
        fallbacks0 = counter_sum("distar_shm_fallbacks_total")
        frames0 = counter_sum("distar_shm_tx_frames_total")
        routes = {"in_process": lambda: gw_a.act_many(lanes), "tcp": lambda: tcp_client.act_many(lanes),
                  "shm": lambda: shm_client.act_many(lanes)}
        ms = {name: [] for name in routes}
        for _ in range(WIRE_ROUNDS):  # the three routes in turns
            for name, fn in routes.items():
                ms[name].append(timed(fn, f"a 32-lane act_many ({name})")[0])
        fallbacks = counter_sum("distar_shm_fallbacks_total") - fallbacks0
        frames = counter_sum("distar_shm_tx_frames_total") - frames0
        # A's status sums its two TCP frontends: tcp_a (the fleet's and the
        # TCP row's connections) and wire_srv (the shm row's alone)
        transports = gw_a.status()["transports"]
        on_wire, on_tcp_a = wire_srv.transport_counts(), tcp_a.transport_counts()
        check(fallbacks == 0 and shm_client.transport_active == "shm",
              f"the shm row fell back to TCP ({fallbacks:g} fallbacks): not a ring measurement")
        check(on_wire == {"tcp": 0, "shm": 1} and on_tcp_a["tcp"] >= 1
              and transports == {k: on_wire[k] + on_tcp_a[k] for k in on_wire} and frames == 2 * WIRE_ROUNDS,
              f"status transports {transports} (ring server {on_wire}, A's server {on_tcp_a}), {frames:g} ring "
              f"frames for {WIRE_ROUNDS} rounds")
        split = {}
        for leg, msg in (("request", request), ("response", answer)):
            enc, dec, enc_raw, dec_raw = [], [], [], []
            for _ in range(3):
                t0 = time.perf_counter()
                blob = serializer.dumps(msg)
                enc.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                serializer.loads(blob)
                dec.append((time.perf_counter() - t0) * 1e3)
                buf = io.BytesIO()
                t0 = time.perf_counter()
                serializer.dump_stream(msg, buf)
                enc_raw.append((time.perf_counter() - t0) * 1e3)
                view = buf.getbuffer()
                t0 = time.perf_counter()
                serializer.loads(view)
                dec_raw.append((time.perf_counter() - t0) * 1e3)
                view.release()
            split[leg] = {"dtl0_bytes": len(blob), "dtl0_encode_ms": statistics.median(enc),
                          "dtl0_decode_ms": statistics.median(dec), "raw_bytes": raw_bytes[leg],
                          "raw_stream_ms": statistics.median(enc_raw), "raw_decode_ms": statistics.median(dec_raw)}
        wire = {name: statistics.median(v) for name, v in ms.items()}
        wire.update({"tcp_overhead_ms": wire["tcp"] - wire["in_process"],
                     "shm_overhead_ms": wire["shm"] - wire["in_process"], "ring_bytes": ring_bytes,
                     "dev_shm_free_bytes": shm_free, "shm_fallbacks": fallbacks, "transports": transports,
                     "ring_server_transports": on_wire, "serialization": split, "rounds": WIRE_ROUNDS})
        result["wire"] = wire
        print(f"serve_fleet wire ({smi}): 32-lane act_many, median of {WIRE_ROUNDS} in turns: in process "
              f"{wire['in_process']:.2f} ms, TCP (DTL0) {wire['tcp']:.2f} ms (+{wire['tcp_overhead_ms']:.2f}), shm "
              f"{wire['shm']:.2f} ms (+{wire['shm_overhead_ms']:.2f}) over {frames:g} ring frames, 0 fallbacks, "
              f"status transports {transports}; serialization {json.dumps(split)}")
        result["seconds"] = time.perf_counter() - t_phase
        print(f"serve_fleet: {result['seconds']:.1f} s")
        print(json.dumps({"serve_fleet": result}))
        return launches, result
    finally:
        for c in clients:
            c.close()
        if fc is not None:
            fc.close()
        if ctl is not None:
            ctl.close()
        stop_all(stack)
        if proc is not None:
            proc.kill()
            proc.wait()
        shutil.rmtree(log_dir, ignore_errors=True)
        set_registry(None)


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
# from it than that (``hold_strings``). The sound strings part by the
# reference model's own kinks, not by a fault of the port (``rl_gap``): of
# about 4e8 ReLU and max-pool decisions in an RL step, 40-260 sit within
# f32 rounding (inputs 1e-8 to 1e-5 against a row scale of 0.1-6) and fall
# on either side in any two f32 runs, and one that carries a large gradient
# moves the whole gradient (UPGO's test never flipped). On an H100, f32
# 'xla' itself lies 2.0e-3 from an f64 yardstick on one batch while
# 'pallas' lies 2.9e-5 from it. With every decision pinned to the f64
# run's, or in a smooth copy (GELU, average pool), the strings lie 5e-6 to
# 8e-6 apart on random batches; on zero observations pinning takes 3.1e-3
# to 6.4e-5, the rest being rounding that the LSTM amplifies there (f32
# 'xla' alone 3.8e-5 from f64). So the sound gap is set by which kinks a
# batch puts near zero: 9.1e-5 to 2.2e-3 on random batches, 3.1e-3 on zero
# observations. Dropping UPGO moves the gradient 2.4e-2 to 5.5e-2, crossing
# the time and batch axes 0.9 to 1.2. 1e-2 lies between.
GRAD_TOL = 1e-2
# the RL gap readings (``rl_gap``): the first intermediate whose max |a - b| /
# max |b| exceeds this names the layer where two strings part
GAP_TOL = 1e-5
# the smooth copy's UPGO step, sigmoid(margin / T): the winloss values are
# 0.01-1, so f32 rounding of a margin (1e-7) moves a lambda by 1e-6
UPGO_SMOOTH_T = 0.1
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
    """The SL train step on the card (module docstring, phase 6). Returns
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


def grad_dist(a, b):
    """|a - b| / |b| over two whole gradients (lists of tensors), in f64."""
    import torch

    return float(torch.cat([(x.double() - y.double()).reshape(-1) for x, y in zip(a, b)]).norm()
                 / torch.cat([y.double().reshape(-1) for y in b]).norm())


def set_string(model, scatter, attn):
    """Switch a built model's scatter and entity-attention routes in place:
    the same weights under another config string (``overlay`` sets the
    entity encoder's attention only; the build-order transformer stays
    plain)."""
    from distar_tpu_torch.ops.transformer import Attention

    model.encoder.scatter_impl = scatter
    for m in model.encoder.entity_encoder.modules():
        if isinstance(m, Attention):
            m.impl = attn


def tapped_loss(loss_fn, lrn, batch):
    """``loss_grads`` with the forward's intermediates tapped: each
    transformer layer's attention (the raw attention ``attention_raw_i``,
    before its output Dense, and the layer's attention block output
    ``attention_i``), the entity embeddings, the scatter map, the spatial
    embedding, the LSTM input and output, every head's logits and every
    value, in forward order. Returns (info, parameter gradients, {name:
    forward value}, {name: gradient of the loss at that tensor}, {layer:
    (attention input, mask)})."""
    import torch

    from distar_tpu_torch.actor.inference import to_device

    model = lrn.model
    taps, att_in = {}, {}
    put = taps.__setitem__
    ent = model.encoder.entity_encoder
    hooks = []
    for i in range(ent.layer_num):
        att = getattr(ent, f"TransformerLayer_{i}").Attention_0
        hooks += [att.register_forward_pre_hook(lambda m, a, i=i: att_in.__setitem__(i, a)),
                  att.Dense_1.register_forward_pre_hook(lambda m, a, i=i: put(f"attention_raw_{i}", a[0])),
                  att.register_forward_hook(lambda m, a, o, i=i: put(f"attention_{i}", o))]
    hooks += [ent.register_forward_hook(lambda m, a, o: put("entity_embeddings", o[0])),
              model.encoder.spatial_encoder.register_forward_pre_hook(lambda m, a: put("scatter_map", a[1])),
              model.encoder.spatial_encoder.register_forward_hook(lambda m, a, o: put("spatial_embedding", o[0])),
              model.core_lstm.register_forward_pre_hook(lambda m, a: put("lstm_input", a[0])),
              model.core_lstm.register_forward_hook(lambda m, a, o: put("lstm_output", o[0]))]
    rl_forward = model.rl_forward

    def record(*a, **kw):
        out = rl_forward(*a, **kw)
        for name, t in out["target_logit"].items():
            put(f"logit_{name}", t)
        for name, t in out["value"].items():
            put(f"value_{name}", t)
        return out

    model.rl_forward = record
    try:
        tb = to_device({k: v for k, v in batch.items() if k != "model_last_iter"}, lrn.device)
        total, info = loss_fn(lrn, tb)
        params = list(model.parameters())
        names = list(taps)
        grads = torch.autograd.grad(total, params + [taps[n] for n in names], allow_unused=True,
                                    materialize_grads=True)
    finally:
        del model.rl_forward
        for h in hooks:
            h.remove()
    return ({k: float(v.detach()) for k, v in info.items()}, grads[:len(params)],
            {n: taps[n].detach() for n in names}, dict(zip(names, grads[len(params):])), att_in)


def tensor_gap(a, b):
    """(max |a - b| / max |b|, the largest over rows (the last axis) of max
    |a - b| / max |b| within the row), in f64; entries where ``b`` is a
    -1e9 fill are left out."""
    import torch

    a, b = a.double(), b.double()
    keep = b.abs() < 1e8
    d = torch.where(keep, (a - b).abs(), 0.0)
    m = torch.where(keep, b.abs(), 0.0)
    whole = float(d.max() / m.max().clamp_min(1e-300))
    rows = d.reshape(-1, d.shape[-1]).amax(1) / m.reshape(-1, m.shape[-1]).amax(1).clamp_min(1e-300)
    return whole, float(rows.max())


def first_over(gaps, tol=GAP_TOL):
    """The first tensor, in the order given, whose gap exceeds ``tol``."""
    return next((name for name, (whole, _) in gaps.items() if whole > tol), None)


def plain_forward_formula_backward(q, k, v, mask):
    """Attention whose forward is the plain version (f32, the kernel's
    numerics) and whose backward is the kernel's formula
    (``masked_attention_backward``): the custom backward without the kernel."""
    import torch

    from distar_tpu_torch.ops import kernels as K

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask):
            ctx.save_for_backward(q, k, v, mask)
            return K.masked_attention_plain(q, k, v, mask)

        @staticmethod
        def backward(ctx, dout):
            return (*K.masked_attention_backward(*ctx.saved_tensors, dout.contiguous()), None)

    return Fn.apply(q, k, v, mask)


def kernel_forward_autograd_backward(q, k, v, mask):
    """The kernel's forward values with autograd through the plain
    version's graph as the backward: plain + (kernel - plain), the second
    term detached."""
    import torch

    from distar_tpu_torch.ops import kernels as K

    plain = K.masked_attention_plain(q, k, v, mask, upcast=False)
    with torch.no_grad():
        kern = K._masked_attention(q, k, v, mask)
    return plain + (kern - plain).detach()


@contextlib.contextmanager
def attention_route(fn):
    """Within the block, the 'pallas' attention route calls ``fn`` in place
    of ``kernels.masked_attention``."""
    from distar_tpu_torch.ops import kernels as K

    saved, K.masked_attention = K.masked_attention, fn
    try:
        yield
    finally:
        K.masked_attention = saved


@contextlib.contextmanager
def float64_model():
    """Within the block, every ``Tensor.float()`` gives float64 and new
    tensors default to float64, so a model moved to ``double()`` computes
    its forward, loss and backward in float64 throughout (the port's code
    casts to float32 with ``.float()`` at the heads, the loss and the
    encoders' inputs)."""
    import torch

    to_float, dtype = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda t, *a, **kw: t.double() if not t.is_complex() else to_float(t, *a, **kw)
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = to_float
        torch.set_default_dtype(dtype)


def float64_batch(batch):
    import numpy as np

    if isinstance(batch, dict):
        return {k: float64_batch(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(float64_batch(v) for v in batch)
    x = np.asarray(batch)
    return x.astype(np.float64) if x.dtype == np.float32 else x


def real_activation_attention(K, att_in, model):
    """The kernel against the plain version on the attention inputs that
    the 'xla' forward of the batch gave each transformer layer: max |a - b|
    over max |b| and its largest value per row, for the kernel and the f32
    plain version each against the plain version in f64; beside them the
    largest score over valid keys and the largest sum_d |q_d k_d| / sqrt(Dh)
    (the scale that the kernel's 3xTF32 error follows)."""
    import torch

    ent = model.encoder.entity_encoder
    out = {}
    with torch.no_grad():
        for i, (x, mask) in att_in.items():
            att = getattr(ent, f"TransformerLayer_{i}").Attention_0
            B, N, _ = x.shape
            q, k, v = (t.reshape(B, N, att.head_num, att.head_dim).transpose(1, 2).contiguous()
                       for t in att.Dense_0(x).chunk(3, dim=-1))
            want = K.masked_attention_plain(q.double(), k.double(), v.double(), mask, upcast=False)
            kern = K._masked_attention(q, k, v, mask)
            plain = K.masked_attention_plain(q, k, v, mask, upcast=False)
            valid = mask.bool()[:, None, None, :]
            scale = att.head_dim ** -0.5
            score = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
            abs_sum = torch.einsum("bhqd,bhkd->bhqk", q.abs(), k.abs()) * scale
            out[f"layer_{i}"] = {
                "kernel_vs_f64": tensor_gap(kern, want), "plain_f32_vs_f64": tensor_gap(plain, want),
                "max_score": float(score.masked_fill(~valid, 0).abs().max()),
                "max_abs_qk_sum": float(abs_sum.masked_fill(~valid, 0).max())}
    return out


class Kinks:
    """Every ReLU and 2x2 max-pool decision of the model's forward, and
    every trace-continues test of the RL loss's UPGO returns, for the RL
    gap readings (``rl_gap``). Within the block ``F.relu``, the blocks'
    ReLU, ``F.max_pool2d`` and the loss's ``upgo_returns`` go through this
    object (a model must be built inside the block for its blocks'
    activations to); ``mode``:

    * ``"pass"``: the plain functions;
    * ``"record"``: the plain functions, each call's decisions kept (which
      inputs are > 0; which element each window takes), in call order;
    * ``"compare"``: the plain functions, each call's decisions counted
      against the recorded ones by call site (``sites``: flips, elements)
      with the first few flipped inputs kept (``flipped``);
    * ``"pin"``: each call takes the recorded decisions (x * the recorded
      mask; the recorded window elements): the function without its kinks
      near this point, as the recording run crossed them;
    * ``"smooth"``: ReLU becomes GELU, the max-pool an average pool of the
      same windows and UPGO's step a sigmoid of its margin at temperature
      UPGO_SMOOTH_T: a copy of the model and loss without those kinks.

    The port's code is untouched: this only patches ``torch.nn.functional``,
    the blocks' activation table and the loss module's ``upgo_returns``
    inside the block."""

    def __init__(self, names=None):
        self.mode, self.ref, self.i = "pass", [], 0
        self.sites, self.flipped, self.names = {}, [], names or {}

    def __enter__(self):
        import torch.nn.functional as Fn

        from distar_tpu_torch.losses import rl_loss
        from distar_tpu_torch.ops import blocks

        self.saved = (Fn.relu, Fn.max_pool2d, blocks.ACTIVATIONS["relu"], rl_loss.upgo_returns)
        Fn.relu = blocks.ACTIVATIONS["relu"] = self.relu
        Fn.max_pool2d = self.max_pool2d
        rl_loss.upgo_returns = self.upgo_returns
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as Fn

        from distar_tpu_torch.losses import rl_loss
        from distar_tpu_torch.ops import blocks

        Fn.relu, Fn.max_pool2d, blocks.ACTIVATIONS["relu"], rl_loss.upgo_returns = self.saved

    def start(self, mode):
        self.mode, self.i, self.sites, self.flipped = mode, 0, {}, []
        if mode == "record":
            self.ref = []

    def _site(self, kind):
        frame = sys._getframe(3)  # _site <- _decide <- relu / max_pool2d / upgo_returns <- the caller
        owner = frame.f_locals.get("self")
        name = self.names.get(id(owner)) if owner is not None else None
        return f"{kind} {name if name is not None else frame.f_code.co_name}"

    def _decide(self, kind, x, got):
        """Keep, count or hand back the call's decisions ``got``."""
        if self.mode == "record":
            self.ref.append(got)
        elif self.mode in ("compare", "pin"):
            ref = self.ref[self.i]
            if self.mode == "pin":
                got = ref
            else:
                flips = got != ref
                n = int(flips.sum())
                site = self._site(kind)
                rec = self.sites.setdefault(site, [0, 0])
                rec[0] += n
                rec[1] += flips.numel()
                if n and kind in ("relu", "upgo") and len(self.flipped) < 16:
                    x = x.detach()
                    for pos in flips.nonzero()[:4].tolist():
                        row = x[tuple(pos[:-1])]
                        self.flipped.append({"site": site, "input": float(x[tuple(pos)]),
                                             "row_max_abs": float(row.abs().max())})
        self.i += 1
        return got

    def relu(self, x, inplace=False):
        import torch.nn.functional as Fn

        if self.mode == "smooth":
            return Fn.gelu(x)
        if self.mode == "pass":
            return self.saved[0](x)
        return x * self._decide("relu", x, x > 0).to(x.dtype)

    def max_pool2d(self, x, kernel_size, stride=None, *args, **kw):
        import torch.nn.functional as Fn

        if self.mode == "smooth":
            return Fn.avg_pool2d(x, kernel_size, stride, *args, **kw)
        if self.mode == "pass":
            return self.saved[1](x, kernel_size, stride, *args, **kw)
        y, idx = self.saved[1](x, kernel_size, stride, return_indices=True)
        idx = self._decide("maxpool", x, idx)
        return x.flatten(2).gather(2, idx.flatten(2)).view_as(y)

    def upgo_returns(self, rewards, bootstrap_values):
        """``ops.rl.upgo_returns`` with its test r_{t+1} + V_{t+2} >= V_{t+1}
        as a decision of this object (the flipped inputs are its margins)."""
        import torch

        from distar_tpu_torch.ops import generalized_lambda_returns

        margin = rewards + bootstrap_values[1:] - bootstrap_values[:-1]
        if self.mode == "smooth":
            lambdas = torch.sigmoid(margin / UPGO_SMOOTH_T)
        else:
            lambdas = (rewards + bootstrap_values[1:]) >= bootstrap_values[:-1]
            if self.mode != "pass":
                lambdas = self._decide("upgo", margin, lambdas)
        lambdas = torch.cat([lambdas[1:], torch.ones_like(lambdas[-1:])], dim=0)
        return generalized_lambda_returns(rewards, 1.0, bootstrap_values, lambdas.to(rewards.dtype))


def rl_gap(device, batch, loss_fn, what, held=True):
    """The RL strings' gradient gap (ROADMAP Queue 3 item 1), on the flagship
    with value towers, f32, TF32 off, one fixed batch; each reading on its
    own line:

    a. 'pallas' against its own repeat;
    b. the mixed strings, kernel attention with the 'xla' scatter and plain
       attention with the kernel scatter, against 'xla';
    c. the forward's intermediates of 'pallas' against 'xla' (``tapped_loss``:
       max |a - b| / max |b| and its largest value per row), the first over
       GAP_TOL named; the gradient of the loss at each of them, likewise;
       the kernel against the plain version on the real activations;
       then the kernel's forward with autograd through the plain version as
       its backward, and the plain forward with the kernel's backward
       formula, each against 'xla': the forward's share and the backward's;
    d. an f64 'xla' gradient as the yardstick, and each f32 string's
       distance from it (gradients, intermediates, gradients at them);
    k. the kinks (``Kinks``): every ReLU, max-pool and UPGO decision of each
       f32 string counted against the f64 run's by call site, with the
       inputs at the first flips beside their row's scale; then the strings
       with every decision pinned to the f64 run's, and a smooth copy (ReLU
       as GELU, max-pool as average pool, UPGO's step as a sigmoid), each
       held to put the strings within GAP_TOL.

    ``held=False`` prints k. without holding it to GAP_TOL. The launches of
    these calls are not the main path's: the caller sets the counts to 0
    after it."""
    from distar_tpu_torch.ops import kernels as K

    res = {}
    with Kinks() as kinks:
        lrn = rl_learner(device, "xla")
        lrn64 = rl_learner(device, "xla")
        lrn64.model.double()
        kinks.names = {id(m): n for n, m in lrn.model.named_modules()}
        model = lrn.model
        runs = {}

        def run(name, scatter, attn):
            set_string(model, scatter, attn)
            runs[name] = tapped_loss(loss_fn, lrn, batch)
            return runs[name]

        run("xla", "xla", "xla")
        run("pallas", "pallas", "pallas")
        gx = runs["xla"][1]

        # a. the kernel string against its own repeat
        again = tapped_loss(loss_fn, lrn, batch)
        res["a"] = {"pallas_repeat": grad_dist(again[1], runs["pallas"][1]),
                    "pallas_repeat_forward_equal": all(
                        bool((again[2][n] == t).all()) for n, t in runs["pallas"][2].items())}
        set_string(model, "xla", "xla")
        res["a"]["xla_repeat"] = grad_dist(tapped_loss(loss_fn, lrn, batch)[1], gx)
        print(f"rl gap ({what}) a. 'pallas' vs its repeat (gradient |a - b| / |b|): "
              f"{res['a']['pallas_repeat']:.3e}, forward intermediates bit-equal "
              f"{res['a']['pallas_repeat_forward_equal']}; 'xla' vs its repeat {res['a']['xla_repeat']:.3e}")

        # b. the mixed strings
        run("attn kernel, scatter xla", "xla", "pallas")
        run("attn xla, scatter kernel", "pallas", "xla")
        run("pallas_onehot", "pallas_onehot", "pallas")
        res["b"] = {name: grad_dist(runs[name][1], gx) for name in
                    ("pallas", "pallas_onehot", "attn kernel, scatter xla", "attn xla, scatter kernel")}
        print(f"rl gap ({what}) b. gradient |a - b| / |b| against 'xla': {json.dumps(res['b'])}")

        # c. intermediates, the gradients at them, the kernel on real activations
        fwd = {n: tensor_gap(t, runs["xla"][2][n]) for n, t in runs["pallas"][2].items()}
        bwd = {n: tensor_gap(t, runs["xla"][3][n]) for n, t in runs["pallas"][3].items()}
        real = real_activation_attention(K, runs["xla"][4], model)
        res["c"] = {"forward": fwd, "first_forward_over": first_over(fwd),
                    "grad_at": bwd, "first_grad_over_from_top": first_over(dict(reversed(bwd.items()))),
                    "kernel_on_real_activations": real}
        print(f"rl gap ({what}) c. 'pallas' vs 'xla' forward intermediates [max |a - b| / max |b|, worst row]: "
              f"{json.dumps(fwd)}; first over {GAP_TOL:.0e}: {res['c']['first_forward_over']}")
        print(f"rl gap ({what}) c. 'pallas' vs 'xla' gradient of the loss at each intermediate: {json.dumps(bwd)}; "
              f"first over {GAP_TOL:.0e} from the loss down: {res['c']['first_grad_over_from_top']}")
        print(f"rl gap ({what}) c. the kernel vs the plain version on the 'xla' forward's attention inputs "
              f"(each against the plain version in f64): {json.dumps(real)}")
        set_string(model, "xla", "pallas")
        with attention_route(kernel_forward_autograd_backward):
            split_fwd = tapped_loss(loss_fn, lrn, batch)
        with attention_route(plain_forward_formula_backward):
            split_bwd = tapped_loss(loss_fn, lrn, batch)
        res["c"]["split"] = {"kernel forward, autograd backward": grad_dist(split_fwd[1], gx),
                             "plain forward, formula backward": grad_dist(split_bwd[1], gx)}
        print(f"rl gap ({what}) c. attention split (scatter 'xla'), gradient against 'xla': "
              f"{json.dumps(res['c']['split'])}")
        del split_fwd, split_bwd

        # d. the f64 yardstick, its kink decisions recorded
        kinks.start("record")
        with float64_model():
            ref = tapped_loss(loss_fn, lrn64, float64_batch(batch))
        kinks.start("pass")
        strings = ("xla", "pallas", "attn kernel, scatter xla", "attn xla, scatter kernel")
        res["d"] = {name: {"gradient": grad_dist(runs[name][1], ref[1]),
                           "first_forward_over": first_over(
                               {n: tensor_gap(t, ref[2][n]) for n, t in runs[name][2].items()}),
                           "first_grad_over_from_top": first_over(
                               {n: tensor_gap(t, ref[3][n]) for n, t in reversed(runs[name][3].items())},
                               tol=1e-4)}
                    for name in strings}
        res["d"]["f64_loss_vs_xla"] = abs(ref[0]["total_loss"] - runs["xla"][0]["total_loss"])
        fwd64 = {name: {n: tensor_gap(t, ref[2][n])[0] for n, t in runs[name][2].items()}
                 for name in ("xla", "pallas")}
        bwd64 = {name: {n: tensor_gap(t, ref[3][n])[0] for n, t in runs[name][3].items()}
                 for name in ("xla", "pallas")}
        print(f"rl gap ({what}) d. f64 'xla' yardstick: each f32 string's gradient |a - b| / |b| from it, the first "
              f"forward tensor over {GAP_TOL:.0e} and the first gradient (from the loss down) over 1e-4: "
              + json.dumps(res["d"]))
        print(f"rl gap ({what}) d. forward intermediates vs f64 (max |a - b| / max |b|): {json.dumps(fwd64)}")
        print(f"rl gap ({what}) d. gradient at each intermediate vs f64: {json.dumps(bwd64)}")
        res["d"]["forward_vs_f64"], res["d"]["grad_at_vs_f64"] = fwd64, bwd64
        del runs

        # k. the kinks: census, then pinned to the f64 run's decisions, then smooth
        census, pinned = {}, {}
        for name, (scatter, attn) in (("xla", ("xla", "xla")), ("pallas", ("pallas", "pallas"))):
            set_string(model, scatter, attn)
            kinks.start("compare")
            loss_grads(loss_fn, lrn, batch)
            census[name] = {"flips": {k: v for k, v in kinks.sites.items() if v[0]},
                            "decisions": sum(v[1] for v in kinks.sites.values()),
                            "first_flipped_inputs": kinks.flipped}
            kinks.start("pin")
            pinned[name] = loss_grads(loss_fn, lrn, batch)[1]
        kinks.start("pin")
        with float64_model():
            pinned_ref = loss_grads(loss_fn, lrn64, float64_batch(batch))[1]
        del lrn64
        smooth = {}
        kinks.start("smooth")
        for name, (scatter, attn) in (("xla", ("xla", "xla")), ("pallas", ("pallas", "pallas"))):
            set_string(model, scatter, attn)
            smooth[name] = loss_grads(loss_fn, lrn, batch)[1]
        kinks.start("pass")
    res["k"] = {"census": census,
                "pinned": {"pallas_vs_xla": grad_dist(pinned["pallas"], pinned["xla"]),
                           "xla_vs_f64": grad_dist(pinned["xla"], pinned_ref),
                           "pallas_vs_f64": grad_dist(pinned["pallas"], pinned_ref)},
                "smooth_pallas_vs_xla": grad_dist(smooth["pallas"], smooth["xla"])}
    for name, c in census.items():
        print(f"rl gap ({what}) k. {name}: {sum(v[0] for v in c['flips'].values())} of {c['decisions']} ReLU, "
              f"max-pool and UPGO decisions on the other side from the f64 run's, by site [flips, decisions]: "
              f"{json.dumps(c['flips'])}; the first flipped ReLU and UPGO inputs beside their row's max |x|: "
              f"{json.dumps(c['first_flipped_inputs'])}")
    print(f"rl gap ({what}) k. every decision pinned to the f64 run's, gradient |a - b| / |b|: "
          f"{json.dumps(res['k']['pinned'])}; a smooth copy (ReLU as GELU, max-pool as average pool, UPGO's "
          f"step as a sigmoid), "
          f"'pallas' vs 'xla': "
          f"{res['k']['smooth_pallas_vs_xla']:.3e} ({f'tol {GAP_TOL:.0e} each' if held else 'printed only'})")
    check(not held or res["k"]["smooth_pallas_vs_xla"] <= GAP_TOL,
          f"rl gap ({what}): the smooth copy leaves the strings {res['k']['smooth_pallas_vs_xla']:.3e} apart")
    check(not held or res["k"]["pinned"]["pallas_vs_xla"] <= GAP_TOL,
          f"rl gap ({what}): with the kinks pinned the strings lie {res['k']['pinned']['pallas_vs_xla']:.3e} apart")
    del lrn
    return res


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
    phase 7). Returns the launch counts of their paths and the measurements."""
    import numpy as np
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

    rl_fn = lambda lrn, tb: rl_loss(lrn.model, lrn.loss_cfg, tb, RL_B, RL_T)  # noqa: E731
    zero_obs = next(FakeRLDataloader(RL_B, RL_T))
    # the gap on this phase's batch, on a second seeded apart, and on zero
    # observations: which kinks a batch puts near zero sets it. On zero
    # observations the LSTM amplifies f32 rounding (f32 'xla' lies 4e-5 from
    # f64 with every kink pinned), so GAP_TOL holds the random batches only
    gaps = {what: rl_gap(device, b, rl_fn, what, held) for what, b, held in (
        ("phase batch", batch, True),
        ("seed-0 batch", random_rl_batch(RL_B, RL_T, np.random.default_rng(0)), True),
        ("zero-observation batch", zero_obs, False))}

    K.reset_launch_counts()
    learners = {impl: rl_learner(device, impl) for impl in STRINGS}
    grads = {"rl_zero_obs": hold_strings("rl loss on a FakeRLDataloader batch (zero observations)",
                                         learners, zero_obs, rl_fn),
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
              "gap": {what: {"a": gap["a"], "b": gap["b"], "c_split": gap["c"]["split"],
                             "d": {k: v for k, v in gap["d"].items()
                                   if k not in ("forward_vs_f64", "grad_at_vs_f64")},
                             "k_pinned": gap["k"]["pinned"], "k_smooth": gap["k"]["smooth_pallas_vs_xla"]}
                      for what, gap in gaps.items()},
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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")  # the serving phases' checkpoints
    try:
        # 1. device
        device = torch.device("cuda")
        smi = smi_line()
        print(smi)
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

        # 5. the serving process
        # a generator of its own, so the phases after it draw what they drew
        # before it was added
        process_launches, process = phase_serve_process(device, np.random.default_rng(5), smi, tmp)

        # 6. the serving fleet, on the checkpoints phase 5 wrote
        fleet_launches, fleet = phase_serve_fleet(device, np.random.default_rng(6), smi,
                                                  *process["checkpoints"])

        # 7. train
        train_launches, train = phase_train(device, rng)

        # 8. RL and distillation
        rl_launches, rl = phase_rl(device, rng)
        print(f"launches: serve {launches}, serve process {process_launches}, serve fleet (gateway A) "
              f"{fleet_launches}, train {train_launches}, rl and distill {rl_launches}")
        launches = {name: launches[name] + process_launches[name] + fleet_launches[name] + train_launches[name]
                    + rl_launches[name] for name in build.KERNELS}

        # 9. the kernels line; max_abs_err over the serve shapes and the f32
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
        print(json.dumps({"serve_flush_ms": flush_ms, "serve_process_wire": process["wire"],
                          "serve_fleet_wire": {k: fleet["wire"][k] for k in ("in_process", "tcp", "shm")},
                          "train_step_ms": train["step_ms"],
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
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
