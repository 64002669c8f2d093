"""The port's perf monitor, profiler and trace analyser against the JAX
package's, on the CPU.

* ``peak_flops``, ``estimate_collective_bytes`` and the ``PerfMonitor``'s
  gauges: equal to the JAX package's (the same host arithmetic; equal
  Prometheus text).
* the flop count: each hand-written kernel's own count equals what its
  plain version's ops count under ``count_flops``, exactly (integers), and
  a learner's step counts the same under every kernel string.
* ``ProfilerSession`` and ``ProfilerHook``: the JAX tests of
  tests/test_timing_hooks.py with the same stub profiler.
* the trace analyser: on ``torch.profiler`` rows equivalent to the JAX
  fixture's ``hlo_op`` rows (the same names, durations, scopes and
  modules), the same report as the JAX analyser's.
"""
import gzip
import json
import os
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu.obs import MetricsRegistry as JRegistry
from distar_tpu.obs import perf as jperf
from distar_tpu.obs import render_prometheus as jax_prometheus
from distar_tpu.obs import traceview as jtv
from distar_tpu_torch.learner import DistillLearner, RLLearner, SLLearner
from distar_tpu_torch.learner.hooks import ProfilerHook
from distar_tpu_torch.obs import MetricsRegistry, ProfilerSession, render_prometheus, set_registry
from distar_tpu_torch.obs import perf, traceview
from distar_tpu_torch.obs.perf import PerfMonitor, count_flops, to_meta
from distar_tpu_torch.ops import kernels
from distar_tpu_torch.ops.scatter import scatter_connection
from distar_tpu_torch.utils import deep_merge_dicts
from distar_tpu_torch.utils.checkpoint import CountVar

torch.set_num_threads(1)

B, T = 2, 3
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "mini.trace.json")
OVERLAYS = {
    "xla": {},
    "pallas": {"encoder": {"entity": {"attention_impl": "pallas"}, "scatter": {"impl": "pallas"}}},
    "pallas_onehot": {"encoder": {"entity": {"attention_impl": "pallas"}, "scatter": {"impl": "pallas_onehot"}}},
}


# ------------------------------------------------------------------ peaks
def test_peak_flops_table_keeps_the_jax_entries_and_adds_the_h100():
    for name, peak in jperf.PEAK_FLOPS.items():
        assert perf.PEAK_FLOPS[name] == peak
    assert set(perf.PEAK_FLOPS) - set(jperf.PEAK_FLOPS) == {"h100"}
    for kind in ("TPU v5 lite", "TPU v5p", "TPU v4", "cpu", ""):
        assert perf.peak_flops(kind) == jperf.peak_flops(kind)
    assert perf.peak_flops("NVIDIA H100 80GB HBM3") == 989e12


# ------------------------------------------------------------- flop count
def _meta(*shape, dtype=torch.float32, grad=True):
    return torch.empty(*shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("backward", [False, True])
def test_attention_kernel_count_equals_its_plain_version(backward):
    Bn, H, N, Dh = 3, 2, 17, 8
    q, k, v = (_meta(Bn, H, N, Dh) for _ in range(3))
    mask = torch.empty(Bn, N, dtype=torch.bool, device="meta")

    def run(fn):
        out = fn(q, k, v, mask)
        if backward:
            torch.autograd.grad(out.sum(), (q, k, v))

    own = count_flops(lambda: run(kernels.masked_attention))
    plain = count_flops(lambda: run(lambda *a: kernels.masked_attention_plain(*a, upcast=False)))
    assert own == plain == kernels.masked_attention_flops(Bn, H, N, Dh) + (
        kernels.masked_attention_flops(Bn, H, N, Dh, backward=True) if backward else 0)


@pytest.mark.parametrize("impl", ["pallas", "pallas_onehot"])
@pytest.mark.parametrize("backward", [False, True])
def test_scatter_kernel_count_equals_the_model_path(impl, backward):
    Bn, N, D, hw = 2, 11, 4, (5, 6)
    emb = _meta(Bn, N, D)
    loc = torch.empty(Bn, N, 2, dtype=torch.int64, device="meta")

    def run(impl):
        out = scatter_connection(emb, loc, hw, impl=impl)
        if backward:
            torch.autograd.grad(out.sum(), emb)

    assert count_flops(lambda: run(impl)) == count_flops(lambda: run("xla")) == \
        kernels.scatter_add_flops(Bn, N, D)


def _learner(cls, overlay, **learner):
    return cls({"learner": {"batch_size": B, "unroll_len": T, **learner},
                "model": deep_merge_dicts(SMALL_MODEL, OVERLAYS[overlay])}, device="cpu")


def _batch(lrn):
    from distar_tpu_torch.actor.inference import to_device
    from distar_tpu_torch.learner.data import as_float32

    batch = dict(next(lrn._dataloader))
    for k in ("model_last_iter", "trace_span_ids", "trace_age_s"):
        batch.pop(k, None)
    if isinstance(lrn, DistillLearner):
        batch = lrn._strip_batch(batch)
    return to_device(as_float32(lrn._cap(batch)), "cpu")


@pytest.mark.parametrize("cls", [SLLearner, RLLearner, DistillLearner])
def test_step_flop_count_is_the_same_under_every_kernel_string(cls):
    counts = {}
    for overlay in OVERLAYS:
        lrn = _learner(cls, overlay)
        counts[overlay] = count_flops(lrn._flop_counter(to_meta(_batch(lrn))))
    assert counts["xla"] > 1e8
    assert counts["pallas"] == counts["pallas_onehot"] == counts["xla"]


def test_distill_step_cost_ratio_gauge(monkeypatch):
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        lrn = _learner(DistillLearner, "pallas", teacher_flops_per_step=1e12)
        want = count_flops(lrn._flop_counter(to_meta(_batch(lrn))))
        assert reg.snapshot()["distar_distill_step_cost_ratio"] == pytest.approx(want / 1e12, rel=1e-12)
        lrn._train(next(lrn._dataloader))
        snap = reg.snapshot()
        assert snap["distar_distill_kl"] == pytest.approx(lrn.last_log.get("divergence", snap["distar_distill_kl"]))
        assert "distar_distill_head_kl{head=action_type}" in snap
    finally:
        set_registry(prev)


# ---------------------------------------------------------- the monitor
def test_perf_monitor_gauges_equal_jax():
    """The same flop count, peak and steps through both monitors: the same
    Prometheus text and snapshot (no memory gauges on a CPU host)."""
    jreg, preg = JRegistry(), MetricsRegistry()
    jm, pm = jperf.PerfMonitor("sllearner", registry=jreg), PerfMonitor("sllearner", registry=preg,
                                                                         device="cpu")
    for m in (jm, pm):
        m.flops_per_step, m.peak = 3.5e12, 989e12
    for dt, frames in ((0.5, 64), (0.25, 64), (0.0, 64), (0.4, 0)):
        jm.on_step(dt, frames)
        pm.on_step(dt, frames)
    assert pm.snapshot() == jm.snapshot()
    text = render_prometheus(preg)
    assert "distar_perf_mfu" in text and "distar_perf_hbm" not in text
    assert text == jax_prometheus(jreg)


def test_estimate_collective_bytes_matches_jax():
    params = {"a": np.zeros((4, 8), np.float32), "b": {"c": np.zeros(10, np.float32)}}
    for shape in ({}, {"dp": 4}, {"fsdp": 2}, {"dp": 2, "fsdp": 4}):
        mesh = types.SimpleNamespace(shape=shape) if shape else None
        assert perf.estimate_collective_bytes(mesh, params) == jperf.estimate_collective_bytes(mesh, params)
    tensors = [torch.zeros(4, 8), torch.zeros(10)]
    mesh = types.SimpleNamespace(shape={"dp": 4})
    assert perf.estimate_collective_bytes(mesh, tensors) == jperf.estimate_collective_bytes(mesh, params)
    jreg, preg = JRegistry(), MetricsRegistry()
    jperf.PerfMonitor("t", registry=jreg).set_collectives(None, params)
    PerfMonitor("t", registry=preg).set_collectives(None, tensors)
    assert render_prometheus(preg) == jax_prometheus(jreg)  # no mesh: no collective gauge


def test_perf_monitor_background_count_and_failure():
    reg = MetricsRegistry()
    mon = PerfMonitor("t", registry=reg, device="cpu")
    x = _meta(4, 5, grad=False)
    mon.note_step(lambda: torch.mm(x, x.t()))
    mon.analysis.join()
    assert mon.flops_per_step == 2 * 4 * 5 * 4 and mon.counting
    mon.note_step(lambda: None)  # idempotent: no second count
    assert mon.analysis.is_alive() is False
    assert reg.snapshot()["distar_perf_flops_per_step{token=t}"] == 160.0
    failing = PerfMonitor("f", registry=reg)

    def boom():
        raise RuntimeError("no count")

    failing.note_step(boom)
    failing.analysis.join()
    assert failing.flops_per_step == 0.0
    assert reg.snapshot()["distar_perf_analysis_failures_total{token=f}"] == 1.0


def test_memory_report_and_gauges_are_empty_on_the_cpu():
    reg = MetricsRegistry()
    mon = PerfMonitor("t", registry=reg, device="cpu")
    mon.sample_memory()
    assert perf.memory_report("cpu") == {}
    assert not any("hbm" in k for k in reg.snapshot())


def test_learner_run_publishes_perf_phases_and_flops(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    monkeypatch.setenv("DISTAR_PERF_AOT", "1")
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        lrn = _learner(RLLearner, "pallas", log_freq=10)
        lrn.run(2)
        lrn._perf.analysis.join()
        lrn._perf.on_step(0.5, B * T)
        snap = reg.snapshot()
        assert snap["distar_perf_flops_per_step{token=rllearner}"] == lrn._perf.flops_per_step > 1e8
        assert snap["distar_perf_frames_per_s{token=rllearner}"] == B * T / 0.5
        assert snap["distar_perf_mfu{token=rllearner}"] == 0.0  # never set: no peak on a CPU host
        text = render_prometheus(reg)
        for phase in ("data_wait", "device_step", "host_callback"):
            assert f'distar_learner_step_phase_seconds_count{{phase="{phase}"}} 2' in text
        assert {"step_seconds", "flops_per_step"} <= set(lrn._perf.snapshot())
    finally:
        set_registry(prev)


# -------------------------------------------------------------- profiler
class _FakeProfiler:
    """A profiler stand-in recording start/stop edges."""

    def __init__(self, fail=False):
        self.events = []
        self.fail = fail

    def start_trace(self, logdir):
        if self.fail:
            raise RuntimeError("no profiler backend")
        self.events.append(("start", logdir))

    def stop_trace(self):
        self.events.append(("stop",))


def _profiled_learner(rank=0):
    return types.SimpleNamespace(last_iter=CountVar(0), rank=rank,
                                 logger=types.SimpleNamespace(info=lambda *a, **k: None))


def test_profiler_hook_freq_gated_capture_window(tmp_path):
    prof = _FakeProfiler()
    hook = ProfilerHook(str(tmp_path), freq=4, duration=2, profiler=prof)
    learner = _profiled_learner()
    for it in range(1, 11):
        learner.last_iter.update(it)
        hook(learner)
    assert prof.events == [("start", str(tmp_path)), ("stop",), ("start", str(tmp_path)), ("stop",)]
    assert not hook.session.active


def test_profiler_hook_rank_gated(tmp_path):
    prof = _FakeProfiler()
    hook = ProfilerHook(str(tmp_path), freq=1, duration=1, profiler=prof)
    learner = _profiled_learner(rank=1)
    for it in range(1, 5):
        learner.last_iter.update(it)
        hook(learner)
    assert prof.events == []


def test_profiler_hook_survives_a_broken_profiler(tmp_path):
    hook = ProfilerHook(str(tmp_path), freq=2, duration=1, profiler=_FakeProfiler(fail=True))
    learner = _profiled_learner()
    for it in range(1, 7):
        learner.last_iter.update(it)
        hook(learner)
    assert not hook.session.active


def test_profiler_sessions_and_failures_counted_and_hook_self_disables(tmp_path):
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        hook = ProfilerHook(str(tmp_path), freq=3, duration=1, profiler=_FakeProfiler())
        learner = _profiled_learner()
        for it in range(1, 8):
            learner.last_iter.update(it)
            hook(learner)
        assert reg.counter("distar_profiler_sessions_total").value == 2
        hook = ProfilerHook(str(tmp_path), freq=1, duration=1, profiler=_FakeProfiler(fail=True))
        for it in range(1, 10):
            learner.last_iter.update(it)
            hook(learner)
        assert hook.disabled
        assert reg.counter("distar_profiler_failures_total",
                           stage="start").value == ProfilerHook.MAX_CONSECUTIVE_FAILURES
    finally:
        set_registry(prev)


def test_profiler_session_records_last_profile_path(tmp_path):
    stamp = tmp_path / "plugins" / "profile" / "2026_01_02"

    class WritingProfiler(_FakeProfiler):
        def stop_trace(self):
            os.makedirs(stamp)
            super().stop_trace()

    sess = ProfilerSession(str(tmp_path), profiler=WritingProfiler(), registry=MetricsRegistry())
    assert sess.start() and sess.stop()
    assert sess.last_profile_path == str(stamp)
    failing = ProfilerSession(str(tmp_path), profiler=_FakeProfiler(fail=True), registry=MetricsRegistry())
    assert not failing.start() and failing.failures == 1


def test_torch_profiler_session_writes_the_jax_layout_and_analyses(tmp_path):
    """The default profiler (``torch.profiler``) writes
    ``plugins/profile/<stamp>/<host>.trace.json``; on the CPU the analyser
    ranks its top-level ``cpu_op`` rows and the shares partition them."""
    sess = ProfilerSession(str(tmp_path), registry=MetricsRegistry())
    x = torch.randn(32, 32)
    assert sess.start()
    for _ in range(3):
        torch.softmax(x @ x, dim=-1).sum()
    assert sess.stop()
    assert os.path.dirname(sess.last_profile_path) == str(tmp_path / "plugins" / "profile")
    report = traceview.analyze_trace(sess.last_profile_path, steps=3)
    assert set(report) == {"total_device_us", "device_op_events", "malformed_events", "steps",
                           "steps_inferred", "dominant_module", "modules", "step_time_device_us",
                           "buckets", "trace_path"}
    buckets = {b["bucket"]: b for b in report["buckets"]}
    assert {"matmul/MXU", "entity-attention"} <= set(buckets)  # aten::mm, aten::softmax
    assert buckets["matmul/MXU"]["events"] == 3
    assert abs(sum(b["share"] for b in report["buckets"]) - 1.0) < 1e-5


# ---------------------------------------------------------- the analyser
@pytest.mark.parametrize("name,scope,bucket", [
    ("dot.3", "", "matmul/MXU"),
    ("convolution.12", "", "matmul/MXU"),
    ("custom-call.1", "jit(train)/EntityEncoder/attention/softmax", "entity-attention"),
    ("scatter.2", "", "scatter"),
    ("while.9", "", "lstm-scan"),
    ("all-reduce.5", "", "collectives"),
    ("infeed.1", "", "host/infeed"),
    ("broadcast.8", "", "other"),
    # the port's kernels and the card's library kernels
    ("void masked_attention_kernel<float>(float const*, float const*, float const*, "
     "unsigned char const*, int const*, float*, int, int, int, int, float)", "", "entity-attention"),
    ("void scatter_owner_kernel<float>(float const*, int const*, float*, int, int, int, int)", "",
     "scatter"),
    ("void scatter_add_onehot_kernel<float>(float const*, int const*, float*, int, int, int, int)", "",
     "scatter"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize128x128x32_warpgroupsize1x1x1", "aten::mm",
     "matmul/MXU"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(Params)", "aten::addmm",
     "matmul/MXU"),
    ("ampere_sgemm_128x64_nn", "", "matmul/MXU"),
    ("Memcpy HtoD (Pinned -> Device)", "h2d", "host/infeed"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "aten::add_", "other"),
])
def test_classify(name, scope, bucket):
    assert traceview.classify(name, scope) == bucket
    assert traceview.classify(name, scope) == jtv.classify(name, scope)


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)["traceEvents"]


def _as_streams(events):
    """The JAX fixture with each module renamed ``stream <n>``: the module
    the port's analyser gives a device row."""
    streams = {}
    out = []
    for e in events:
        if isinstance(e, dict) and isinstance(e.get("args"), dict) and "hlo_module" in e["args"]:
            e = json.loads(json.dumps(e))
            m = e["args"]["hlo_module"]
            e["args"]["hlo_module"] = f"stream {streams.setdefault(m, 7 + len(streams))}"
        out.append(e)
    return out


def _as_torch(events):
    """The same ops as ``torch.profiler`` rows: a ``kernel`` row per device
    op on its module's stream, its scope a ``cpu_op`` with the same
    ``External id``; noise rows as ``python_function``."""
    out = []
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            out.append(e)
            continue
        args = e.get("args") or {}
        if e.get("ph") != "X" or "hlo_op" not in args:
            if e.get("ph") == "X":
                out.append({**e, "cat": "python_function"})
            continue
        stream = int(args["hlo_module"].split()[1]) if "hlo_module" in args else 0
        out.append({**{k: v for k, v in e.items() if k != "args"}, "cat": "kernel",
                    "args": {"stream": stream, "External id": 1000 + i, "device": 0}})
        if args.get("tf_op"):
            out.append({"ph": "X", "cat": "cpu_op", "name": args["tf_op"], "pid": 9, "tid": 2,
                        "ts": 0, "dur": 1.0, "args": {"External id": 1000 + i}})
    return out


def test_analyser_on_equivalent_torch_rows_gives_the_jax_report():
    jax_events = _as_streams(_fixture())
    for steps in (None, 4):
        want = jtv.analyze_events(jax_events, steps=steps)
        got = traceview.analyze_events(_as_torch(jax_events), steps=steps)
        assert got == want
    assert want["malformed_events"] == 3
    assert traceview.render_markdown(got) == jtv.render_markdown(want)


def test_analyse_shares_sum_to_one_within_the_reference_rounding():
    """Shares are rounded to 6 decimals as in the JAX report, so their sum
    is 1 within about 1e-6 (not exactly; ROADMAP Queue 3)."""
    report = traceview.analyze_events(_as_torch(_as_streams(_fixture())))
    shares = [b["share"] for b in report["buckets"]]
    assert abs(sum(shares) - 1.0) < 1e-5
    times = [b["time_us"] for b in report["buckets"]]
    assert times == sorted(times, reverse=True)
    assert report["steps_inferred"] == 2


def test_analyse_empty_trace_degrades():
    report = traceview.analyze_events([])
    assert report["total_device_us"] == 0.0 and report["buckets"] == [] and report["steps"] == 1


def test_find_analyse_and_cli_on_the_logdir_layout(tmp_path, capsys):
    old = tmp_path / "plugins" / "profile" / "2026_01_01" / "host.trace.json.gz"
    new = tmp_path / "plugins" / "profile" / "2026_01_02" / "host.trace.json"
    for i, p in enumerate((old, new)):
        p.parent.mkdir(parents=True)
        doc = {"traceEvents": [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 0, "dur": 10.0 + i,
                                "name": "ampere_sgemm_128x64_nn", "args": {"stream": 7}}]}
        with (gzip.open(p, "wt") if str(p).endswith(".gz") else open(p, "w")) as f:
            json.dump(doc, f)
    os.utime(old, (1, 1))
    assert traceview.find_trace_files(str(tmp_path))[0] == str(new)
    report = traceview.analyze_trace(str(tmp_path))
    assert report["trace_path"] == str(new) and report["total_device_us"] == pytest.approx(11.0)
    with pytest.raises(FileNotFoundError):
        traceview.analyze_trace(str(tmp_path / "none"))
    out = tmp_path / "r.json"
    assert traceview.main([str(tmp_path), "--steps", "1", "--json", str(out)]) == 0
    assert "matmul/MXU" in capsys.readouterr().out
    assert json.loads(out.read_text())["steps"] == 1


# ---------------------------------------------------- on-demand profiles
def test_admin_profile_route_returns_the_ranked_report(tmp_path, monkeypatch):
    """``POST /learner/profile?steps=2`` on a running CPU learner: the run
    loop starts and stops the capture at iteration boundaries and the
    route answers the ranked buckets; ``status`` carries the perf view."""
    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    lrn = _learner(SLLearner, "pallas", log_freq=100)
    admin = lrn.start_admin(port=0)
    loop = threading.Thread(target=lambda: lrn.run(10 ** 6), daemon=True)
    loop.start()
    try:
        def post(route):
            req = urllib.request.Request(f"http://{admin.host}:{admin.port}/learner/{route}", data=b"{}",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        reply = post("profile?steps=2")
        assert reply["code"] == 0, reply
        report = reply["info"]
        assert report["captured_steps"] == 2 and report["steps"] == 2
        assert report["buckets"] and abs(sum(b["share"] for b in report["buckets"]) - 1.0) < 1e-5
        assert report["markdown"].startswith("| bucket |")
        assert os.path.isfile(report["trace_path"])
        status = post("status")["info"]
        assert "step_seconds" in status["perf"]
    finally:
        lrn.request_stop()
        loop.join(60)
        admin.stop()
    assert not loop.is_alive()


def test_an_armed_profile_is_released_when_the_run_ends(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTAR_EXPERIMENTS_ROOT", str(tmp_path))
    lrn = _learner(RLLearner, "xla", log_freq=100)
    errors = []

    def ask():
        try:
            lrn.request_profile(steps=50, timeout_s=120)
        except RuntimeError as e:
            errors.append(str(e))

    waiter = threading.Thread(target=ask)
    waiter.start()
    while lrn._profile_req is None:
        threading.Event().wait(0.01)
    lrn.run(2)
    waiter.join(60)
    assert errors == ["learner run ended before the capture completed"]
