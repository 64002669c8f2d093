"""Serve entry point: the inference gateway behind both frontends.

    python -m distar_tpu_torch.bin.serve --mock
    python -m distar_tpu_torch.bin.serve --checkpoint <path> [--config <yaml|json>] [--device cpu]

Counterpart of ``distar_tpu.bin.serve``. ``--mock`` runs the serving stack
on the CPU mock engine; ``--checkpoint <storage url>`` serves a model: the
checkpoint (the JAX package's format, ``utils.checkpoint``) loads through
the versioned registry, warms up on a zero observation, and activates
before the frontends accept traffic. New versions hot-swap at runtime
through ``POST /serve/load`` + ``/serve/swap`` or the TCP ``load`` and
``swap`` ops. ``--device`` is CUDA by default and raises where there is
none unless given ``cpu``. ``--players MP0,MP1`` (mock) or repeated
``--player-checkpoint PLAYER=URL`` serve several players behind this one
address (``GatewayMux``).

``--transport`` (default ``auto``) lets the TCP frontend negotiate
shared-memory rings with clients on the same host (``shm`` too; ``tcp``
refuses rings). ``--coordinator-addr host:port`` registers the TCP
address under the ``serve_gateway`` token with a ``--lease-s`` lease kept
alive by heartbeats, so a ``serve.fleet`` router or ``FleetClient``
discovers the gateway.

Shutdown (SIGTERM or SIGINT) is drain-then-stop: the gateway leaves
discovery first (it unregisters from the coordinator), sheds new requests
with the typed ``DrainingError``, flushes those it admitted, stops its
frontends and exits 0.

Not ported yet: ``--telemetry-interval-s`` above 0 raises
``NotImplementedError`` (the telemetry shipper, ``obs/shipper.py``;
ROADMAP Queue 1 item 9). Fleet health (``obs/health.py``, item 9) is not
ported: ``--no-health`` is accepted and the start-up line says so.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time
from typing import Optional, Sequence


def log(msg: str) -> None:
    print(f"[serve {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def build_engine(args, checkpoint: Optional[str] = None):
    """The engine and the registry's load function for the chosen model."""
    from ..serve import BatchedInferenceEngine, MockModelEngine

    if args.mock:
        return MockModelEngine(args.slots, delay_s=args.mock_delay_s), None

    from ..actor.inference import BatchedInference
    from ..model import Model, default_model_config
    from ..serve.registry import default_load_fn
    from ..utils import deep_merge_dicts, read_config

    model_cfg = default_model_config()
    if args.config:
        model_cfg = deep_merge_dicts(model_cfg, read_config(args.config).get("model", {}))
    # the weights come from the checkpoint: the registry installs them at
    # the first flush, after warming them up off the serving path
    infer = BatchedInference(Model(model_cfg), args.slots, seed=args.seed, device=args.device)
    return BatchedInferenceEngine(infer), default_load_fn


def build_gateway(args, checkpoint: Optional[str] = None):
    """One ``InferenceGateway`` serving one model (the per-player unit)."""
    from ..lib import features as F
    from ..serve import InferenceGateway, ModelRegistry

    engine, load_fn = build_engine(args, checkpoint=checkpoint)
    gateway = InferenceGateway(
        engine,
        max_batch=args.slots,
        max_delay_s=args.max_delay_ms / 1000.0,
        queue_capacity=args.queue_capacity,
        idle_ttl_s=args.idle_ttl_s,
    )
    if load_fn is not None:
        gateway.registry = ModelRegistry(load_fn=load_fn, warmup_fn=gateway._warmup)
        gateway.set_template(F.fake_step_data())
        gateway.load_version(args.version, source=checkpoint or args.checkpoint, activate=True)
    else:
        # mock: a boot version too, so status shows a real generation
        gateway.load_version(args.version, params={"version": args.version, "bias": 0.0},
                             activate=True)
    return gateway


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8000)
    p.add_argument("--tcp-port", type=int, default=8001)
    p.add_argument("--slots", type=int, default=32, help="batch lanes = max live sessions")
    p.add_argument("--max-delay-ms", type=float, default=5.0, help="flush deadline")
    p.add_argument("--queue-capacity", type=int, default=256)
    p.add_argument("--idle-ttl-s", type=float, default=300.0, help="session idle eviction")
    p.add_argument("--checkpoint", help="storage URL of the checkpoint to serve")
    p.add_argument("--version", default="v1", help="registry name for --checkpoint")
    p.add_argument("--config", help="YAML or JSON file, or inline JSON, with a model: section "
                                    "(must match the checkpoint)")
    p.add_argument("--mock", action="store_true", help="CPU mock engine (no model)")
    p.add_argument("--mock-delay-s", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--drain-timeout-s", type=float, default=30.0)
    p.add_argument("--players", default="",
                   help="mock multiplexing: comma list of player ids served behind this one "
                        "address (each gets its own mock engine and registry)")
    p.add_argument("--player-checkpoint", action="append", default=[], metavar="PLAYER=URL",
                   help="serve PLAYER from URL behind this one address (repeatable; the first "
                        "named player is the default for clients that name none)")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default cuda; raises without CUDA unless 'cpu')")
    p.add_argument("--coordinator-addr", default="",
                   help="register this gateway under the serve_gateway token at host:port "
                        "(lease and heartbeats; routers discover the fleet there)")
    p.add_argument("--lease-s", type=float, default=10.0,
                   help="registration lease (a gateway that stops heartbeating leaves the map)")
    p.add_argument("--no-health", action="store_true",
                   help="accepted; fleet health is not ported yet (ROADMAP Queue 1 item 9)")
    p.add_argument("--no-trace", action="store_true",
                   help="disable trace-span minting on the request path")
    p.add_argument("--telemetry-interval-s", type=float, default=0.0,
                   help="telemetry shipping to the coordinator: not ported yet (obs/shipper.py, "
                        "ROADMAP Queue 1 item 9); only 0 is accepted")
    p.add_argument("--transport", default="auto", choices=("auto", "shm", "tcp"),
                   help="TCP-frontend transport: auto and shm negotiate shared-memory rings with "
                        "clients on this host (the socket stays as control channel and fallback); "
                        "tcp refuses rings")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = parser()
    args = p.parse_args(argv)
    player_ckpts = dict(s.split("=", 1) for s in args.player_checkpoint)
    if not args.mock and not args.checkpoint and not player_ckpts:
        p.error("--checkpoint (or --player-checkpoint) is required unless --mock")
    if args.players and not args.mock:
        p.error("--players is the mock multiplexer; use --player-checkpoint PLAYER=URL for models")
    if args.telemetry_interval_s > 0:
        raise NotImplementedError("--telemetry-interval-s: the telemetry shipper (obs/shipper.py) "
                                  "is not ported yet (ROADMAP Queue 1 item 9)")
    if args.no_trace:
        from ..obs import set_tracing

        set_tracing(False)

    from ..serve import GatewayMux, ServeHTTPServer, ServeTCPServer

    t0 = time.perf_counter()
    players = [s.strip() for s in args.players.split(",") if s.strip()]
    if player_ckpts:
        target = GatewayMux({pl: build_gateway(args, checkpoint=url)
                             for pl, url in player_ckpts.items()})
        players = list(player_ckpts)
    elif players:
        target = GatewayMux({pl: build_gateway(args) for pl in players})
    else:
        target = build_gateway(args)
    target.start()
    http = ServeHTTPServer(target, host=args.host, port=args.http_port).start()
    tcp = ServeTCPServer(target, host=args.host, port=args.tcp_port, transport=args.transport).start()

    beat = None
    if args.coordinator_addr:
        from ..serve.fleet import register_gateway

        chost, _, cport = args.coordinator_addr.rpartition(":")
        # target: a drain's first step (begin_drain) leaves discovery now,
        # so routers stop pinning sessions here, not a lease later
        beat = register_gateway(
            (chost or "127.0.0.1", int(cport)), tcp.host, tcp.port,
            meta={"players": players, "slots": args.slots, "http_port": http.port,
                  "version": args.version, "mock": bool(args.mock)},
            lease_s=args.lease_s or None, target=target)
    log(f"serving: http={http.host}:{http.port} tcp={tcp.host}:{tcp.port} slots={args.slots} "
        f"max_delay={args.max_delay_ms}ms players={players or ['<single>']} "
        f"{'mock' if args.mock else (args.checkpoint or player_ckpts)} "
        f"device={'cpu (mock)' if args.mock else (args.device or 'cuda')} "
        f"transport={args.transport}"
        + (f" registered@{args.coordinator_addr}" if beat else "")
        + f" startup_s={time.perf_counter() - t0:.3f}; fleet health not ported "
        f"(ROADMAP Queue 1 item 9)")

    done = threading.Event()

    def _shutdown(sig, frame):
        log(f"signal {sig}: draining")
        done.set()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    done.wait()
    # leave discovery (the deregister hook), shed new requests typed while
    # the admitted ones flush, then stop the frontends
    target.drain_and_stop(args.drain_timeout_s)
    http.stop()
    tcp.stop()
    log("drained; bye")


if __name__ == "__main__":
    main()
