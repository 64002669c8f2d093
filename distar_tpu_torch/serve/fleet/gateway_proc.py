"""Standalone mock gateway: ``python -m distar_tpu_torch.serve.fleet.gateway_proc``.

Counterpart of ``distar_tpu.serve.fleet.gateway_proc``: ``bin/serve.py
--mock`` without a model, so fleet members are real processes (their own
GIL, real sockets) that start in well under a second. Prints one parseable
``SERVE-GATEWAY <host> <tcp_port> <http_port>`` line once serving, then
runs until SIGTERM/SIGINT or stdin EOF (a dying parent reaps the fleet),
or, after a drain, until every resident session has left.

``--players MP0,MP1`` serves several mock models behind the one address
(``GatewayMux``); ``--coordinator host:port`` registers the data-plane
endpoint under ``serve_gateway`` with a lease and heartbeats, and a drain
unregisters it first.

``--telemetry-interval-s`` defaults to 0 here (2.0 in the JAX package) and
raises above 0: the telemetry shipper comes with ROADMAP Queue 1 item 9, as
for ``bin/serve.py``.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import time


def main(argv=None) -> int:
    from ..engine import MockModelEngine
    from ..gateway import InferenceGateway
    from ..http_frontend import ServeHTTPServer
    from ..mux import GatewayMux
    from ..tcp_frontend import ServeTCPServer
    from .discovery import register_gateway

    p = argparse.ArgumentParser(description="standalone mock serve gateway")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="TCP data plane")
    p.add_argument("--http-port", type=int, default=0)
    p.add_argument("--slots", type=int, default=32)
    p.add_argument("--players", default="",
                   help="comma list -> multiplexed gateway (default: one "
                        "anonymous player)")
    p.add_argument("--version", default="v1", help="boot model version name")
    p.add_argument("--mock-delay-s", type=float, default=0.0)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--queue-capacity", type=int, default=1024)
    p.add_argument("--idle-ttl-s", type=float, default=300.0)
    p.add_argument("--coordinator", default="",
                   help="coordinator host:port to register under serve_gateway")
    p.add_argument("--lease-s", type=float, default=10.0)
    p.add_argument("--telemetry-interval-s", type=float, default=0.0,
                   help="telemetry shipping to the coordinator: not ported yet "
                        "(obs/shipper.py, ROADMAP Queue 1 item 9); only 0 is accepted")
    p.add_argument("--no-trace", action="store_true",
                   help="disable request-span minting")
    p.add_argument("--trace-keep-one-in", type=int, default=0,
                   help="override the tail sampler's random 1-in-N keep "
                        "rate (1 = retain every span; 0 = the default)")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="graceful-retirement budget: after POST /drain, exit "
                        "once every resident session migrated off, or when "
                        "this many seconds passed — whichever comes first")
    p.add_argument("--transport", default="auto", choices=("auto", "shm", "tcp"),
                   help="TCP-frontend transport policy (auto/shm negotiate "
                        "shared-memory rings with colocated clients)")
    args = p.parse_args(argv)
    if args.telemetry_interval_s > 0:
        raise NotImplementedError("--telemetry-interval-s: the telemetry shipper (obs/shipper.py) "
                                  "is not ported yet (ROADMAP Queue 1 item 9)")

    if args.no_trace:
        from ...obs import set_tracing

        set_tracing(False)
    if args.trace_keep_one_in > 0:
        from ...obs import TraceBuffer, set_trace_buffer

        set_trace_buffer(TraceBuffer(random_one_in=args.trace_keep_one_in))

    players = [s.strip() for s in args.players.split(",") if s.strip()]

    def build_gateway(player: str) -> InferenceGateway:
        params = {"version": args.version, "bias": 0.0, "player": player}
        gw = InferenceGateway(
            MockModelEngine(args.slots, params=params, delay_s=args.mock_delay_s),
            max_batch=args.slots,
            max_delay_s=args.max_delay_ms / 1000.0,
            queue_capacity=args.queue_capacity,
            idle_ttl_s=args.idle_ttl_s,
        )
        gw.load_version(args.version, params=params, activate=True)
        return gw

    if players:
        target = GatewayMux({pl: build_gateway(pl) for pl in players}).start()
    else:
        target = build_gateway("").start()

    tcp = ServeTCPServer(target, host=args.host, port=args.port,
                         transport=args.transport).start()
    http = ServeHTTPServer(target, host=args.host, port=args.http_port).start()

    beat = None
    if args.coordinator:
        chost, _, cport = args.coordinator.rpartition(":")
        # target: drain's step 1 leaves discovery now, not a lease TTL later
        beat = register_gateway(
            (chost or "127.0.0.1", int(cport)), tcp.host, tcp.port,
            meta={"players": players, "slots": args.slots,
                  "http_port": http.port, "version": args.version,
                  "mock": True},
            lease_s=args.lease_s, target=target,
        )

    # the parseable serving line callers wait for
    print(f"SERVE-GATEWAY {tcp.host} {tcp.port} {http.port}", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    drain_deadline = [None]
    try:
        import select

        while not stop.is_set():
            ready, _, _ = select.select([sys.stdin], [], [], 0.5)
            if ready and not sys.stdin.buffer.read(1):
                break
            # graceful retirement: once a POST /drain (or the TCP drain op)
            # set draining, run until every resident session has migrated
            # off (the router ends them here as it re-pins), bounded by
            # --drain-timeout-s so a client that never migrates cannot pin
            # a retiring process
            if getattr(target, "draining", False):
                if drain_deadline[0] is None:
                    drain_deadline[0] = time.monotonic() + args.drain_timeout_s
                if (target.resident_sessions() == 0
                        or time.monotonic() > drain_deadline[0]):
                    break
    except (OSError, ValueError, KeyboardInterrupt):
        pass
    if beat is not None:
        beat.stop_event.set()
    tcp.stop()
    http.stop()
    target.drain_and_stop(5.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
