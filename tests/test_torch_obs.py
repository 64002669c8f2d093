"""The port's telemetry against the JAX package's, on the CPU: one script of
metric operations rendered by both registries gives the same Prometheus
text and snapshot; ``traceparent`` headers format and parse alike; the
tail-sampled trace buffer keeps the same spans; trace spans publish the
same series."""
import math

import pytest

from distar_tpu import obs as jobs
from distar_tpu_torch import obs


def script(reg):
    """Counters, gauges and histograms with labels, help text and label
    values that need escaping, and non-finite values."""
    reg.counter("distar_serve_requests_total", "requests by outcome", outcome="ok").inc(3)
    reg.counter("distar_serve_requests_total", "requests by outcome", outcome="shed").inc()
    reg.counter("distar_plain_total").inc(2.5)
    g = reg.gauge("distar_serve_inflight", "requests admitted\nand not yet completed")
    g.set(7)
    g.inc(2)
    g.dec(0.5)
    reg.gauge("distar_weird", 'a "quoted" \\ help', label='x"y\nz\\').set(math.inf)
    reg.gauge("distar_nan").set(math.nan)
    reg.gauge("distar_big").set(3e20)
    h = reg.histogram("distar_serve_request_latency_seconds", "submit-to-response latency", reservoir=8)
    for i in range(20):
        h.observe(0.001 * i * i)
    reg.histogram("distar_serve_batch_occupancy", "requests per flushed batch", phase="a").observe(5)
    return reg


def test_prometheus_text_and_snapshot_are_the_jax_packages():
    port, jax_ = script(obs.MetricsRegistry()), script(jobs.MetricsRegistry())
    assert obs.render_prometheus(port) == jobs.render_prometheus(jax_)
    assert obs.PROMETHEUS_CONTENT_TYPE == jobs.PROMETHEUS_CONTENT_TYPE
    snap, want = port.snapshot(), jax_.snapshot()
    assert set(snap) == set(want)
    for k, v in want.items():
        assert (math.isnan(v) and math.isnan(snap[k])) or snap[k] == v, k


def test_registry_refuses_what_the_jax_one_refuses():
    for lib in (obs, jobs):
        reg = lib.MetricsRegistry()
        reg.counter("distar_x_total")
        with pytest.raises(ValueError):
            reg.gauge("distar_x_total")
        with pytest.raises(ValueError):
            reg.counter("bad name")
        with pytest.raises(ValueError):
            reg.counter("distar_y_total").inc(-1)


@pytest.mark.parametrize("header", [
    None, "", "garbage", "00-abc-def-01", "00-" + "0" * 16 + "1" * 16 + "-" + "a" * 16 + "-01",
    "00-" + "f" * 32 + "-" + "0123456789abcdef-01", "00-" + "g" * 32 + "-" + "a" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01"])
def test_traceparent_parses_alike(header):
    assert obs.parse_traceparent(header) == jobs.parse_traceparent(header)


def test_traceparent_formats_alike_and_round_trips():
    ctx = obs.start_trace("serve_client", session="s0")
    wire = obs.wire_ctx(ctx)
    assert obs.format_traceparent(ctx) == jobs.format_traceparent(ctx) == jobs.format_traceparent(wire)
    assert jobs.parse_traceparent(obs.format_traceparent(ctx)) == wire
    child = obs.join_trace(jobs.parse_traceparent(obs.format_traceparent(ctx)), "http_act")
    assert child["trace_id"] == ctx["trace_id"] and child["parent_span_id"] == ctx["span_id"]
    assert obs.join_trace({"bad": 1}, "x")["trace_id"] != ctx["trace_id"]
    assert obs.format_traceparent(None) is None and jobs.format_traceparent(None) is None


def test_tail_sampler_keeps_the_same_spans():
    """Same names, durations and outcomes offered: the same keep reasons."""
    port, jax_ = obs.TraceBuffer(maxlen=16, random_one_in=4), jobs.TraceBuffer(maxlen=16, random_one_in=4)
    got, want = [], []
    for i in range(80):
        name = "serve_request" if i % 3 else "serve_client"
        dur = (i * 37 % 11) * 1e-3 + (0.5 if i in (40, 61) else 0.0)
        outcome = "shed" if i % 17 == 0 else "ok"
        got.append(port.offer(name, dur, outcome, lambda: {"trace_id": str(i), "name": name}))
        want.append(jax_.offer(name, dur, outcome, lambda: {"trace_id": str(i), "name": name}))
    assert got == want
    assert [r["trace_id"] for r in port.records()] == [r["trace_id"] for r in jax_.records()]


def test_finish_trace_and_span_publish_the_jax_series():
    regs = (obs.MetricsRegistry(), jobs.MetricsRegistry())
    for lib, reg in zip((obs, jobs), regs):
        ctx = lib.start_trace("serve_request")
        lib.mark_hop(ctx, "serve_flush", registry=reg)
        lib.annotate(ctx, "queue_s", 0.25)
        lib.finish_trace(ctx, "serve_done", registry=reg)
        assert ctx["annot"] == {"queue_s": 0.25}
        with lib.Span("serve_forward", registry=reg):
            pass
        with pytest.raises(KeyError):
            with lib.Span("serve_teacher_forward", registry=reg):
                raise KeyError
    names = [sorted((f["name"], tuple(k for k, _ in f["series"])) for f in r.collect()) for r in regs]
    assert names[0] == names[1]
    assert regs[0].counter("distar_span_errors_total", span="serve_teacher_forward").value == 1
