#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distar_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. device  — print the card's name and power limit; TF32 off for matmuls
             and cuDNN convolutions, so the parity phases compare f32.
2. build   — compile every CUDA kernel from ``distar_tpu_torch/ops/csrc``
             (one nvcc per source, in parallel) and print the seconds.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the flagship serve shapes (32 slots, 512 entities) and at the
             edge cases of the CPU tests; kernel, plain and library times.
4. serve   — the flagship model (``default_model_config`` with the kernel
             overlay, full width, seeded random weights) behind
             ``BatchedInference(32 slots) -> BatchedInferenceEngine ->
             InferenceGateway``: 8 sessions x 3 steps plus a reset, once per
             scatter kernel, with the launch counts read around each run;
             then the kernel-backed forward held against the 'xla' strings on
             the same weights and Gumbel noise, and the median flush time.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit); every timed
# kernel input is float32, whose non-tensor-core peak applies
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

SLOTS = 32
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # kernel vs plain, max abs
SCATTER_TOL = 1e-5  # the one-hot plain version sums in matmul order
LOGIT_TOL = 1e-3  # kernel-backed vs 'xla' forward, max abs on unmasked logits


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds of ``fn`` over ``iters`` launches (CUDA
    events around the whole run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- kernels
def attention_case(K, rng, B, H, N, Dh, lengths, dtype, device):
    import torch

    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, Dh)).astype("float32"))
               .to(device=device, dtype=dtype) for _ in range(3))
    mask = torch.arange(N)[None, :] < torch.as_tensor(lengths)[:, None]
    mask = mask.to(device)
    got = K.masked_attention(q, k, v, mask)
    want = K.masked_attention_plain(q, k, v, mask)
    err = float((got.float() - want.float()).abs().max())
    check(torch.isfinite(got.float()).all(), f"attention {dtype} {B}x{H}x{N}x{Dh}: non-finite output")
    return (q, k, v, mask), err


def scatter_case(K, rng, B, N, D, hw, device):
    import torch

    emb = torch.from_numpy(rng.standard_normal((B, N, D)).astype("float32")).to(device)
    idx = rng.integers(0, hw, (B, N))
    idx[:, :8] = idx[:, :1]  # forced collisions
    idx[:, 8] = -3  # out of range: clipped to 0
    idx[:, 9] = hw + 7  # out of range: clipped to hw-1
    idx = torch.from_numpy(idx).to(device)
    loop = K.scatter_add_connection(emb, idx, hw)
    onehot = K.scatter_add_onehot(emb, idx, hw)
    check(torch.equal(loop, onehot), f"scatter {B}x{N}x{D} hw={hw}: the two kernels differ")
    err_loop = float((loop - K.scatter_add_plain(emb, idx, hw)).abs().max())
    err_onehot = float((onehot - K.scatter_add_onehot_plain(emb, idx, hw)).abs().max())
    return (emb, idx), err_loop, err_onehot


def phase_kernels(device, rng):
    """Every kernel vs its plain version at the flagship serve shapes and the
    CPU tests' edge cases; returns per-kernel records (errors and times at
    the serve shapes)."""
    import torch
    import torch.nn.functional as Fn

    from distar_tpu_torch.ops import kernels as K

    B, H, N, Dh = SLOTS, 2, 512, 128
    lengths = rng.integers(1, N + 1, B)
    lengths[:3] = (1, N // 3, N)  # one valid key, partial, all
    records = {}
    # edge cases: ragged key tile, a row with no valid key, small heads
    for dt in (torch.float32, torch.bfloat16):
        _, err = attention_case(K, rng, 4, 2, 63, 8, [0, 1, 30, 63], dt, device)
        check(err <= ATTN_TOL[str(dt)[6:]], f"attention edge {dt}: max abs err {err}")
        print(f"kernel masked_attention edge N=63 Dh=8 {dt}: max_abs_err {err:.3e}")
    for dt in (torch.bfloat16, torch.float32):  # f32 last: its inputs are timed
        args, err = attention_case(K, rng, B, H, N, Dh, lengths, dt, device)
        name = str(dt)[6:]
        check(err <= ATTN_TOL[name], f"attention {name}: max abs err {err}")
        print(f"kernel masked_attention {B}x{H}x{N}x{Dh} {name}: max_abs_err {err:.3e}")
    q, k, v, mask = args
    valid_keys = int(mask.sum())
    nbytes = 4 * q.numel() * 4 + mask.numel()
    flops = 4 * H * Dh * N * valid_keys  # every query row against the valid keys
    add_mask = torch.zeros(B, 1, 1, N, device=device).masked_fill(~mask[:, None, None, :], -1e9)
    rec = {"max_abs_err": err, "replaces": "distar_tpu/ops/pallas_kernels.py:62",
           "source": "distar_tpu_torch/ops/csrc/masked_attention.cu",
           "ms": cuda_ms(lambda: K.masked_attention(q, k, v, mask)),
           "plain_ms": cuda_ms(lambda: K.masked_attention_plain(q, k, v, mask), iters=5),
           "library_ms": cuda_ms(lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=add_mask))}
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
    records["masked_attention"] = rec

    sB, sN, sD, hw = SLOTS, 512, 32, 152 * 160
    _, e1, e2 = scatter_case(K, rng, 2, 16, 4, 63, device)  # hw=63: ragged last chunk
    check(max(e1, e2) <= SCATTER_TOL, f"scatter edge hw=63: max abs err {e1}, {e2}")
    print(f"kernel scatter edge hw=63: max_abs_err loop {e1:.3e} onehot {e2:.3e}; kernels bit-equal")
    (emb, idx), e1, e2 = scatter_case(K, rng, sB, sN, sD, hw, device)
    check(max(e1, e2) <= SCATTER_TOL, f"scatter: max abs err {e1}, {e2}")
    print(f"kernel scatter {sB}x{sN}x{sD} hw={hw}: max_abs_err loop {e1:.3e} onehot {e2:.3e}; "
          "kernels bit-equal")
    nbytes = emb.numel() * 4 + idx.numel() * 4 + sB * hw * sD * 4
    b_ms, b_by = bound(nbytes, emb.numel())
    flat = (idx.clamp(0, hw - 1) + torch.arange(sB, device=device)[:, None] * hw).reshape(-1)
    for name, err, plain in (("scatter_add_connection", e1, K.scatter_add_plain),
                             ("scatter_add_onehot", e2, K.scatter_add_onehot_plain)):
        line = 156 if name == "scatter_add_connection" else 231
        fn = getattr(K, name)
        records[name] = {
            "max_abs_err": err, "replaces": f"distar_tpu/ops/pallas_kernels.py:{line}",
            "source": f"distar_tpu_torch/ops/csrc/{name}.cu", "bound_ms": b_ms, "bound_by": b_by,
            "ms": cuda_ms(lambda: fn(emb, idx, hw)),
            "plain_ms": cuda_ms(lambda: plain(emb, idx, hw), iters=3, warmup=1),
            "library_ms": cuda_ms(
                lambda: torch.zeros(sB * hw, sD, device=device).index_add_(0, flat, emb.view(-1, sD)))}
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

    def overlay(scatter_impl, attn_impl):
        return {"encoder": {"entity": {"attention_impl": attn_impl}, "scatter": {"impl": scatter_impl}}}

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
    profiles = {impl: profile_flush(infer, prepared) for impl, infer in infers.items()}
    print(json.dumps({"flush_profile": profiles}))
    return launches, flush_ms


def profile_flush(infer, prepared):
    """One flush under torch.profiler: wall ms, device-busy ms (the sum of
    device activity on the one stream), idle share, the number of device
    activities (kernels and copies) and those that take the most time.

    The flushes themselves run unguarded, so a kernel fault fails the run;
    only the profiler's own start, stop and event reading may fail softly,
    and then the profile reports why it was not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    infer.sample(prepared)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 - the profiler's own setup
        return {"not_measured": f"profiler start: {e!r}"}
    t0 = time.perf_counter()
    infer.sample(prepared)  # ends in the device->host copy
    wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    try:
        prof.stop()
        by_name = {}
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):  # device activity: kernels, copies
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    except Exception as e:  # noqa: BLE001 - the profiler's own teardown and event reading
        return {"not_measured": f"profiler events: {e!r}"}
    busy = sum(ms for ms, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "device_activities": sum(n for _, n in by_name.values()),
            "top": [{"name": k[:80], "ms": ms, "count": n} for k, (ms, n) in rows[:10]]}


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

        # 5. the kernels line
        line = {"kernels": [
            {"name": name, "route": "cuda", "source": rec["source"], "replaces": rec["replaces"],
             "launches": launches[name], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
             "library_ms": rec["library_ms"]}
            for name, rec in records.items()]}
        print(json.dumps({"serve_flush_ms": flush_ms, "seconds": time.perf_counter() - t_start}))
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
