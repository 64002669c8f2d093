"""chaos: seeded fault-injection CLI for resilience drills (docs/resilience.md).

Counterpart of the JAX package's ``tools/chaos.py``, over the port: every
drill spawns ``python -m distar_tpu_torch...`` where the JAX one spawns
``distar_tpu...``, and prints the JAX drill's verdict JSON as the line
before its last, with the same keys, then a ``verdict:`` line; a failed
verdict exits non-zero. It operates on the port's deterministic injector
(``distar_tpu_torch/resilience/chaos.py``), so a drill run on a live fleet
replays the faults the tests prove survivable. The drills that run a model
(``dynamics-drill``, ``arena-drill``, ``multichip-drill``) take
``--device``: CUDA by default, and they raise without CUDA unless given
``--device cpu``. ``multichip-drill`` runs the port's executor
(``parallel/executor.py``): ``--host-devices N`` runs N gloo ranks on the
CPU (with ``--device cpu``), ``--host-devices 0`` one process on
``--device``, a world of one on a card:

  python -m distar_tpu_torch.tools.chaos corrupt --path exp/checkpoints/iteration_40.ckpt \\
        --mode truncate [--seed 0] [--frac 0.5] [--flips 8]
  python -m distar_tpu_torch.tools.chaos kill --pid 12345 [--signal TERM|KILL]
  python -m distar_tpu_torch.tools.chaos reset --addr 127.0.0.1:8423 [--count 4]
  python -m distar_tpu_torch.tools.chaos latest --dir exp/checkpoints
  python -m distar_tpu_torch.tools.chaos replay-drill --dir /tmp/replay_spill [--items 50] \\
        [--no-spill] [--seed 0]
  python -m distar_tpu_torch.tools.chaos multichip-drill --dir /tmp/mc_drill \\
        [--mesh dp=4,fsdp=2] [--resume-mesh dp=8] [--host-devices 8] \\
        [--kill-after 2] [--iters 5] [--device cpu]
  python -m distar_tpu_torch.tools.chaos serve-drill --gateways 3 [--sessions 48] [--steps 8]
  python -m distar_tpu_torch.tools.chaos shm-drill --dir /tmp/shm_drill [--items 60] [--seed 0]
  python -m distar_tpu_torch.tools.chaos dynamics-drill --dir /tmp/dyn_drill \\
        [--module encoder] [--pre-steps 3] [--post-steps 3] [--device cpu]
  python -m distar_tpu_torch.tools.chaos elastic-drill --dir /tmp/el_drill [--sessions 14] \\
        [--slots 8] [--items 60]
  python -m distar_tpu_torch.tools.chaos arena-drill --dir /tmp/arena_drill [--batches 4] \\
        [--episodes 6] [--kill-after 1] [--device cpu]
  python -m distar_tpu_torch.tools.chaos coordinator-drill --dir /tmp/coord_drill \\
        [--items 30] [--post-items 15] [--lease-s 8] [--grace-s 1.5] \\
        [--no-ha]
  python -m distar_tpu_torch.tools.chaos league-drill --dir /tmp/league_drill \\
        [--rounds 40] [--lease-s 2] [--job-ttl-s 5] [--no-journal]

``corrupt`` damages a checkpoint in place (the resume path must fall back);
``kill`` sends a signal to a role process (the supervisor/orchestrator must
restart it); ``reset`` opens connections to an endpoint and aborts them with
RST (read paths must survive hard resets); ``latest`` prints the durable
pointer's generations with per-generation verification status — run it after
a drill to see the fallback the fleet actually took; ``replay-drill`` stands
up a real replay store + clients on loopback, kills the store mid-run
(``ChaosInjector.kill_role`` with the replay role), restarts it from the
spill directory and reports whether every acked insert survived (exit 0
only when nothing was lost — or, with ``--no-spill``, when the expected
loss was demonstrated: the counter-example the durability contract is
measured against); ``multichip-drill`` kills a sharded-training learner
right after a sharded checkpoint save and supervises restarts on a
DIFFERENT mesh shape until the run finishes unassisted (the resharding
restore under fire).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from ..resilience.chaos import ChaosInjector
from ..utils.checkpoint import CheckpointManager, verify_checkpoint

#: the checkout's root: children start there, and the ``-c`` children put
#: it on their path
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cmd_corrupt(args) -> int:
    inj = ChaosInjector(seed=args.seed)
    if args.mode == "truncate":
        new_size = inj.truncate(args.path, keep_frac=args.frac)
        print(f"truncated {args.path} -> {new_size} bytes")
    else:
        offsets = inj.bitflip(args.path, flips=args.flips)
        print(f"bit-flipped {args.path} at byte offsets {offsets}")
    print(f"verify_checkpoint: {verify_checkpoint(args.path)}")
    return 0


def cmd_kill(args) -> int:
    sig = getattr(signal, f"SIG{args.signal.upper()}")
    os.kill(args.pid, sig)
    print(f"sent SIG{args.signal.upper()} to pid {args.pid}")
    return 0


def cmd_reset(args) -> int:
    host, _, port = args.addr.rpartition(":")
    inj = ChaosInjector(seed=args.seed)
    n = inj.reset_connection(host or "127.0.0.1", int(port), count=args.count)
    print(f"aborted {n}/{args.count} connections to {args.addr} with RST")
    return 0 if n else 1


def _sharded_replay_drill(args) -> int:
    """Shard-loss drill: N consistent-hash shards, one killed mid-run.

    Proves the fleet contract the single-store drill cannot: (a) the
    learner-side fan-in rides through the kill on the surviving shards
    without assistance, (b) ONLY the killed shard's unsampled tail goes
    missing while it is down (every surviving item is attributable to a
    live shard by the routing function), and (c) restarting the shard over
    its own spill directory restores exactly that tail — zero items lost
    fleet-wide. Consume-once (fifo) tables make the ledger exact: each key
    is sampleable exactly once, so set arithmetic is the whole proof."""
    from ..replay import (
        ReplayServer, ReplayStore, ShardMap, ShardedInsertClient,
        ShardedSampleClient, SpillRing, TableConfig,
    )

    def table_cfg(_name):
        return TableConfig(max_size=max(args.items * 2, 8), sampler="fifo",
                           samples_per_insert=None, min_size_to_sample=1)

    def build_store(i):
        spill = None if args.no_spill else SpillRing(
            os.path.join(args.dir, f"s{i}"), max_items=args.items * 2)
        store = ReplayStore(table_factory=table_cfg, spill=spill,
                            shard_id=f"s{i}", recover_encoded=True)
        return store, store.recover()

    inj = ChaosInjector(seed=args.seed)
    servers = [ReplayServer(build_store(i)[0], port=0).start()
               for i in range(args.shards)]
    addrs = [f"{s.host}:{s.port}" for s in servers]
    shard_map = ShardMap(addrs)
    inserter = ShardedInsertClient(shard_map)

    keys = [f"k{i}" for i in range(args.items)]
    owner = {k: inserter.shard_for("drill", k) for k in keys}
    for k in keys:
        inserter.insert("drill", {"k": k}, key=k, timeout_s=10.0)

    sampler = ShardedSampleClient(shard_map)

    def drain(budget_s: float, want=None) -> set:
        """Fan-in sample until ``want`` is fully seen or the budget lapses.
        A timeout is NOT terminal: a restarted shard sits behind an open
        circuit breaker for a few seconds, so the loop keeps offering until
        the budget says the remainder is genuinely unreachable."""
        got, deadline = set(), time.monotonic() + budget_s
        while time.monotonic() < deadline:
            if want is not None and want <= got:
                break
            try:
                items, _info = sampler.sample(
                    "drill", batch_size=1,
                    timeout_s=min(1.0, max(0.1, deadline - time.monotonic())))
            except Exception:
                time.sleep(0.2)
                continue
            got.update(it["k"] for it in items)
        return got

    # phase 1: train a while, then the chaos moment — kill shard 0 with
    # part of its table acked and unsampled
    pre = drain_n(sampler, keys, args.items // 4)
    victim = addrs[0]
    inj.kill_role(servers[0], name=f"replay:{victim}")

    # phase 2: the learner keeps sampling unassisted; everything still
    # reachable must come from surviving shards
    survivors = {k for k in keys if owner[k] != victim}
    mid = drain(15.0, want=survivors - pre)
    assert all(owner[k] != victim for k in mid), \
        "sampled a key from the dead shard?!"
    missing = set(keys) - pre - mid
    wrong = [k for k in missing if owner[k] != victim]

    # phase 3: restart the killed shard over its spill; its tail comes back
    store2, recovered = build_store(0)
    host, port = victim.rsplit(":", 1)
    server2 = ReplayServer(store2, host=host, port=int(port)).start()
    servers[0] = server2
    post = drain(20.0, want=missing)
    lost = set(keys) - pre - mid - post
    for s in servers:
        s.stop()

    verdict = {
        "shards": args.shards, "items": args.items, "killed": victim,
        "sampled_pre_kill": len(pre), "sampled_during_outage": len(mid),
        "unreachable_during_outage": len(missing),
        "unreachable_not_owned_by_victim": len(wrong),
        "recovered_from_spill": recovered,
        "sampled_after_restart": len(post), "lost_fleet_wide": len(lost),
        "spill": not args.no_spill, "events": [e["kind"] for e in inj.events],
    }
    print(json.dumps(verdict))
    if args.no_spill:
        ok = len(lost) == len(missing) and len(missing) > 0
        print("verdict: shard loss demonstrated without spill"
              if ok else "verdict: UNEXPECTED — nothing lost?")
        return 0 if ok else 1
    ok = (not wrong and not lost and recovered == len(missing)
          and len(missing) > 0 and len(mid) > 0)
    print("verdict: learner rode through the shard kill; the killed shard's "
          "tail recovered from spill; zero items lost fleet-wide"
          if ok else "verdict: DRILL FAILED")
    return 0 if ok else 1


def drain_n(sampler, keys, n: int) -> set:
    """Sample until ``n`` unique keys were consumed (pre-kill warmup)."""
    got = set()
    while len(got) < n:
        items, _info = sampler.sample("drill", batch_size=1, timeout_s=10.0)
        got.update(it["k"] for it in items)
    return got


def cmd_replay_drill(args) -> int:
    """Kill-the-store-mid-run drill on a real server + real clients.
    ``--shards N`` (N > 1) runs the shard-loss variant instead; ``--shards
    1`` is the original whole-store kill — the counter-demo that a single
    store loses its entire unsampled tail where the fleet loses 1/N."""
    from ..replay import (
        InsertClient, ReplayServer, ReplayStore, SampleClient, SpillRing,
        TableConfig,
    )
    from ..resilience import RetryPolicy

    if args.shards > 1:
        return _sharded_replay_drill(args)

    def table_cfg(_name):
        return TableConfig(max_size=max(args.items * 2, 8),
                           samples_per_insert=None, min_size_to_sample=1)

    def build_store():
        spill = None if args.no_spill else SpillRing(args.dir, max_items=args.items * 2)
        store = ReplayStore(table_factory=table_cfg, spill=spill)
        return store, store.recover()

    inj = ChaosInjector(seed=args.seed)
    store, _ = build_store()
    server = ReplayServer(store, port=0).start()
    inserter = InsertClient(server.host, server.port)
    acked = [inserter.insert("drill", {"i": i}) for i in range(args.items)]
    port = server.port
    # the chaos moment: the store dies with every insert acked, none sampled
    inj.kill_role(server, name="replay")
    store2, recovered = build_store()
    server2 = ReplayServer(store2, host=server.host, port=port).start()
    sampler = SampleClient(server2.host, server2.port,
                           retry_policy=RetryPolicy(max_attempts=2, deadline_s=5.0))
    sampled = 0
    try:
        while sampled < len(acked):
            items, _info = sampler.sample("drill", batch_size=1, timeout_s=0.5)
            sampled += len(items)
    except Exception:
        pass  # a drained (or lossy) store times out — that IS the measurement
    server2.stop()
    lost = len(acked) - sampled
    verdict = {
        "acked": len(acked), "recovered_from_spill": recovered,
        "sampled_after_restart": sampled, "lost": lost,
        "spill": not args.no_spill, "events": [e["kind"] for e in inj.events],
    }
    print(json.dumps(verdict))
    if args.no_spill:
        # counter-demo: without the spill, acked data MUST be lost — if it
        # isn't, the drill didn't actually kill anything
        print("verdict: data loss demonstrated without spill"
              if lost == len(acked) else "verdict: UNEXPECTED — nothing lost?")
        return 0 if lost == len(acked) else 1
    print("verdict: every acked insert survived the kill"
          if lost == 0 else f"verdict: LOST {lost} acked trajectories")
    return 0 if lost == 0 else 1


def cmd_multichip_drill(args) -> int:
    """Kill-the-learner-mid-multichip-run drill with a mesh-shape change.

    Phase 1: a child trains on ``--mesh`` (``--host-devices`` gloo ranks,
    or one process on ``--device``) with
    per-iteration SHARDED checkpoints and kills itself (``os._exit``) right
    after the save at ``--kill-after`` — a preempted pod worker. Then the
    drill supervises restarts (RestartPolicy semantics, applied
    cross-process) on ``--resume-mesh`` — a DIFFERENT topology — until the
    run reaches ``--iters`` unassisted. Exit 0 only when the resumed run
    (a) restored from the generation the kill left behind (resharding
    restore) and (b) finished without human help."""
    import subprocess
    import time

    from ..actor.inference import resolve_device

    if args.host_devices and args.device != "cpu":
        raise SystemExit("--host-devices runs gloo ranks on the CPU: give --device cpu "
                         "(or --host-devices 0 for one process on the card)")
    device = resolve_device(args.device).type
    exp_dir = os.path.join(args.dir, "exp")
    target = args.iters

    def child(mesh, extra):
        cmd = [
            sys.executable, "-m", "distar_tpu_torch.parallel.executor",
            "--mesh", mesh, "--host-devices", str(args.host_devices),
            "--device", device,
            "--iters", str(target), "--save-dir", exp_dir,
            "--experiment-name", "chaos_multichip",
        ] + extra
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=args.timeout_s, cwd=_REPO)
        report = None
        for line in proc.stdout.splitlines():
            if line.startswith("REPORT "):
                report = json.loads(line[len("REPORT "):])
        return proc.returncode, report, proc

    print(f"phase 1: train on --mesh {args.mesh}, kill after iter "
          f"{args.kill_after} (post-save)")
    rc, report, proc = child(args.mesh, ["--save-freq", "1",
                                         "--kill-after", str(args.kill_after)])
    if rc != 137:
        print(f"UNEXPECTED: phase-1 child exited {rc} (wanted the 137 kill)\n"
              f"{proc.stderr[-2000:]}")
        return 1

    # phase 2: supervised restarts on the OTHER mesh shape until done
    restarts, resumed_from, final = 0, None, None
    while restarts < args.restart_max:
        restarts += 1
        print(f"phase 2 (attempt {restarts}): resume on --resume-mesh "
              f"{args.resume_mesh}")
        rc, report, proc = child(args.resume_mesh, ["--resume"])
        if rc == 0 and report is not None:
            resumed_from = report.get("resumed_from")
            final = report
            break
        print(f"restart attempt {restarts} died rc={rc}; retrying\n"
              f"{proc.stderr[-500:]}")
        time.sleep(1.0)
    verdict = {
        "target_iters": target,
        "killed_after": args.kill_after,
        "restarts": restarts,
        "resumed_from": resumed_from,
        "final_iters": final and final.get("iters"),
        "resume_start_iter": final and final.get("start_iter"),
        "mesh_killed": args.mesh,
        "mesh_resumed": final and final.get("mesh"),
    }
    print(json.dumps(verdict))
    ok = (
        final is not None
        and final.get("iters") == target
        and final.get("start_iter", 0) >= args.kill_after
        and resumed_from is not None
    )
    print("verdict: resumed on a different mesh and finished unassisted"
          if ok else "verdict: DRILL FAILED")
    return 0 if ok else 1


def cmd_serve_drill(args) -> int:
    """Gateway-loss drill on the serving fleet: N real gateway processes
    behind the session-affinity router, one killed mid-episode under load.

    The contract being proven (docs/serving.md fleet section): (a) every
    session — including every session pinned to the victim — finishes its
    episode; (b) the router re-routes the victim's sessions to survivors
    within one retry budget, and each re-routed session's carry
    re-materializes from zero, counted EXACTLY (migrations ==
    victim-pinned sessions, detected via session_step running backwards);
    (c) callers see ZERO typed-error leakage beyond shed accounting — a
    dead gateway surfaces as transparent failover, never as an error
    return. Exit 0 only when all three hold."""
    import subprocess
    import threading

    import numpy as np

    from ..obs import get_registry
    from ..serve import ShedError
    from ..serve.fleet import FleetClient, GatewayMap

    def spawn():
        cmd = [sys.executable, "-m", "distar_tpu_torch.serve.fleet.gateway_proc",
               "--port", "0", "--http-port", "0", "--slots", str(args.slots)]
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        parts = proc.stdout.readline().split()
        if len(parts) < 4 or parts[0] != "SERVE-GATEWAY":
            raise RuntimeError(f"gateway failed to start: {parts}")
        return proc, f"{parts[1]}:{parts[2]}"

    from ..fleet import pinning

    inj = ChaosInjector(seed=args.seed)
    spawned = [spawn() for _ in range(args.gateways)]
    procs = [p for p, _ in spawned]
    addrs = [a for _, a in spawned]
    pin_prov = pinning.pin_fleet([p.pid for p in procs], reserve_client=1)
    fc = FleetClient(gateway_map=GatewayMap(addrs), timeout_s=10.0,
                     down_ttl_s=60.0)
    obs = {"x": np.ones((4, 4), dtype=np.float32)}
    sids = [f"drill-{i}" for i in range(args.sessions)]
    completed = {sid: 0 for sid in sids}
    sheds = [0]
    errors = []
    lock = threading.Lock()
    kill_at = max(1, args.steps // 2)
    killed = [None]

    def step_all(step: int) -> None:
        """One fleet cycle: every session steps once (sheds retried within
        the cycle — they are backpressure, not loss)."""
        pending = list(sids)
        deadline = time.monotonic() + 30.0
        while pending and time.monotonic() < deadline:
            results = fc.act_many(
                [{"session_id": s, "obs": obs} for s in pending], timeout_s=10.0)
            nxt = []
            for s, r in zip(pending, results):
                if isinstance(r, ShedError):
                    with lock:
                        sheds[0] += 1
                    nxt.append(s)
                elif isinstance(r, Exception):
                    with lock:
                        errors.append((s, step, repr(r)))
                else:
                    completed[s] += 1
            pending = nxt
            if pending:
                time.sleep(0.05)
        for s in pending:
            with lock:
                errors.append((s, step, "cycle budget exhausted"))

    migrations0 = get_registry().snapshot().get(
        "distar_fleet_session_migrations_total", 0.0)
    for step in range(args.steps):
        step_all(step)
        if step + 1 == kill_at:
            # the chaos moment: kill the gateway holding the most sessions
            pins = fc.router.stats()["pins_per_gateway"]
            victim = max(pins, key=lambda a: pins[a])
            killed[0] = {"addr": victim, "pinned": pins[victim]}
            inj.kill_role(procs[addrs.index(victim)], name=f"serve:{victim}")
            procs[addrs.index(victim)].wait(timeout=10)
    migrations = get_registry().snapshot().get(
        "distar_fleet_session_migrations_total", 0.0) - migrations0

    finished = sum(1 for s in sids if completed[s] == args.steps)
    fc.close()
    for proc in procs:
        try:
            proc.stdin.close()
            proc.wait(timeout=10)
        except Exception:
            proc.kill()
    verdict = {
        "gateways": args.gateways, "sessions": args.sessions,
        "steps": args.steps, "pinning": pin_prov, "killed": killed[0],
        "finished_sessions": finished,
        "migrations": migrations,
        "sheds_retried": sheds[0],
        "error_leaks": len(errors),
        "events": [e["kind"] for e in inj.events],
    }
    print(json.dumps(verdict))
    ok = (
        finished == args.sessions
        and killed[0] is not None
        and migrations == killed[0]["pinned"]
        and not errors
    )
    print("verdict: gateway killed under load; every session re-routed and "
          "finished; migrations counted exactly; zero error leakage"
          if ok else f"verdict: DRILL FAILED {errors[:5]}")
    return 0 if ok else 1


def cmd_shm_drill(args) -> int:
    """Kill the shm-transport peer mid-frame; prove typed detection + TCP
    fallback with zero acked-item loss.

    A real replay shard subprocess serves the drill over negotiated shm
    rings (tiny rings forced via DISTAR_SHM_RING_BYTES, so the writer is
    usually mid-frame, blocked for space). Mid-traffic the shard is
    SIGKILL'd — no close flags, no unlink, only the heartbeat going
    stale: the drill's writer sees its dead ring *reader* typed
    (ShmPeerDeadError within the heartbeat window) and the drill's
    sampler, parked in recv, sees the dead ring *writer* the same way —
    both directions of the failure model. The counted fallback then rides
    the resilience retry policy onto a restarted shard that only speaks
    TCP (same port, same spill directory), and the run completes there:
    every acked insert must be sampleable afterwards (spill recovery for
    the committed tail + idempotent retries for the in-flight one), the
    replay-drill accounting. Exit 0 only when shm was genuinely active
    before the kill, the fallback was typed+counted, the finish leg is
    tcp, and zero acked items are lost."""
    import subprocess
    import threading

    from ..obs import get_registry
    from ..replay import InsertClient, SampleClient

    def spawn(port: int, transport: str):
        env = dict(os.environ)
        env["DISTAR_SHM_RING_BYTES"] = str(args.ring_bytes)
        cmd = [sys.executable, "-m", "distar_tpu_torch.replay.server",
               "--port", str(port), "--transport", transport,
               "--spill-dir", args.dir, "--sampler", "fifo",
               "--min-size", "1", "--max-size", str(max(args.items * 2, 64)),
               "--spill-max", str(max(args.items * 2, 64))]
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        parts = proc.stdout.readline().split()
        if len(parts) < 3 or parts[0] != "REPLAY-SHARD":
            raise RuntimeError(f"shard failed to start: {parts}")
        return proc, parts[1], int(parts[2])

    from ..fleet import pinning

    inj = ChaosInjector(seed=args.seed)
    proc, host, port = spawn(0, "shm")
    pin_prov = pinning.pin_fleet([proc.pid], reserve_client=1)
    payload = os.urandom(args.ring_bytes // 2 + 512)  # frames span the ring
    inserter = InsertClient(host, port, timeout_s=10.0)
    acked, dup, lock = set(), [0], threading.Lock()

    def fallbacks() -> float:
        return sum(v for k, v in get_registry().snapshot().items()
                   if k.startswith("distar_shm_fallbacks_total"))

    # phase 1: half the items acked over live rings
    half = args.items // 2
    for i in range(half):
        inserter.insert("drill", {"k": f"k{i}", "b": payload}, timeout_s=10.0)
        with lock:
            acked.add(f"k{i}")
    transport_before = inserter.transport_active
    fallbacks_before = fallbacks()

    # phase 2: continuous traffic from BOTH seats, then the chaos moment.
    # The sampler parks in a blocking sample (its ring *writer* is the
    # server); the inserter streams frames (its ring *reader* is the
    # server) — the SIGKILL is seen typed from both directions.
    sampler = SampleClient(host, port, timeout_s=10.0)
    sampled, stop = set(), threading.Event()

    def insert_rest():
        # paced so the SIGKILL lands mid-stream (an idle writer would
        # finish before the chaos moment and dodge the drill)
        for i in range(half, args.items):
            while True:
                try:
                    inserter.insert("drill", {"k": f"k{i}", "b": payload},
                                    timeout_s=10.0)
                    with lock:
                        acked.add(f"k{i}")
                    break
                except Exception:
                    if stop.is_set():
                        return
                    time.sleep(0.2)
            time.sleep(0.05)

    def sample_some():
        while not stop.is_set():
            try:
                items, _ = sampler.sample("drill", batch_size=1, timeout_s=5.0)
            except Exception:
                time.sleep(0.2)
                continue
            with lock:
                for it in items:
                    if it["k"] in sampled:
                        dup[0] += 1
                    sampled.add(it["k"])

    threads = [threading.Thread(target=insert_rest, daemon=True),
               threading.Thread(target=sample_some, daemon=True)]
    for t in threads:
        t.start()
    time.sleep(0.5)  # traffic in flight on the rings
    inj.kill_role(proc.pid, sig=signal.SIGKILL, name=f"replay-shm:{host}:{port}")
    proc.wait(timeout=10)
    time.sleep(1.0)  # inside the retry budget: clients are detecting/backing off

    # phase 3: restart on the SAME port, TCP-only, over the same spill dir —
    # the fallback leg must complete the run unassisted
    proc2, host, port = spawn(port, "tcp")
    threads[0].join(60.0)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        with lock:
            if acked <= sampled:
                break
        time.sleep(0.2)
    stop.set()
    threads[1].join(10.0)
    lost = sorted(acked - sampled)
    # read BEFORE close() (close drops the rings and would fake a "tcp")
    transport_after = {"insert": inserter.transport_active,
                       "sample": sampler.transport_active}
    verdict = {
        "items": args.items,
        "pinning": pin_prov,
        "acked": len(acked),
        "sampled_unique": len(sampled),
        "duplicates_after_restart": dup[0],
        "lost_acked": len(lost),
        "transport_before_kill": transport_before,
        "transport_after_fallback": transport_after,
        "typed_fallbacks_counted": fallbacks() - fallbacks_before,
        "events": [e["kind"] for e in inj.events],
    }
    inserter.close()
    sampler.close()
    try:
        proc2.stdin.close()
        proc2.wait(timeout=10)
    except Exception:
        proc2.kill()
    print(json.dumps(verdict))
    ok = (transport_before == "shm"
          and transport_after == {"insert": "tcp", "sample": "tcp"}
          and verdict["typed_fallbacks_counted"] >= 2  # both client seats
          and len(acked) == args.items
          and not lost)
    print("verdict: peer killed mid-frame detected typed on both ring "
          "directions; clients fell back to the TCP leg and finished with "
          "zero acked-item loss"
          if ok else f"verdict: DRILL FAILED {verdict}")
    return 0 if ok else 1


def cmd_elastic_drill(args) -> int:
    """The elastic-fleet acceptance drill: load spike ->
    autoscaler scale-up observed LIVE by clients -> graceful cooldown drain
    with exact migration accounting -> SIGKILL a replay member MID-DRAIN
    with zero acked-item loss.

    Phase A (serve): one mock gateway under the coordinator + autoscaler;
    more sessions than its slots arrive (typed capacity sheds = the load
    spike). The gateway-residency policy breaches, the autoscaler spawns a
    second gateway, and the drill's FleetClient — running the live
    membership refresher, never reconstructed — observes the join and its
    shed sessions land on the new member (capacity spill-over). Load then
    drops; after hysteresis + cooldown the autoscaler drains the newest
    gateway gracefully: every session resident there is ended-and-re-pinned
    by the client (DrainingError handoff), counted EXACTLY (migrations ==
    the victim's pinned sessions at decision time), with zero non-shed
    errors, and the victim process exits on its own.

    Phase B (replay): a 3-shard spill-backed fleet under the same
    coordinator; keyed acked inserts spread over the ring. One shard is
    drained (deregister-then-refuse) and — before its resident tail can
    drain — SIGKILL'd mid-drain. Survivors absorb the insert stream (the
    draining overlay + membership refresh re-route keys), a replacement
    over the victim's spill directory on the SAME port recovers exactly its
    tail, and the fan-in sampler accounts for every acked key. Exit 0 only
    when every contract holds. Core pinning is attempted via the
    tools/pin.py harness and reported in-band (refused on small hosts)."""
    import threading

    import numpy as np

    from ..comm.coordinator import Coordinator, CoordinatorServer
    from ..fleet import (
        Autoscaler, FleetSupervisor, MemberProbe, ScalePolicy, SubprocessFleet,
        gateway_cmd, pinning, replay_cmd,
    )
    from ..obs import TimeSeriesStore, get_registry
    from ..replay import ShardMap, ShardedInsertClient, ShardedSampleClient
    from ..serve import ShedError
    from ..serve.fleet import FleetClient

    slots = args.slots
    sessions = args.sessions
    verdict = {"phase_a": {}, "phase_b": {}}
    failures = []

    coordinator = CoordinatorServer(Coordinator(default_lease_s=10.0))
    coordinator.start()
    coord_addr = f"{coordinator.host}:{coordinator.port}"

    supervisor = FleetSupervisor()
    gw_fleet = SubprocessFleet(
        "gateway", "gateway",
        gateway_cmd(slots=slots, coordinator=coord_addr,
                    extra=["--drain-timeout-s", "20"]),
        drain_timeout_s=25.0)
    rp_fleet = SubprocessFleet(
        "replay", "replay",
        replay_cmd(spill_root=args.dir, coordinator=coord_addr,
                   extra=["--drain-timeout-s", "20",
                          "--max-size", str(max(args.items * 2, 64)),
                          "--spill-max", str(max(args.items * 2, 64))]),
        drain_timeout_s=25.0)
    supervisor.add_fleet(gw_fleet).add_fleet(rp_fleet).start()

    store = TimeSeriesStore()
    probe = MemberProbe(store, supervisor)
    scaler = Autoscaler(
        store, supervisor,
        policies=[ScalePolicy(
            name="gateway_residency", fleet="gateway",
            signal="distar_serve_sessions_active",
            divide_by="distar_serve_session_slots",
            up_when=0.85, down_when=0.30, window_s=6.0, for_count=2)],
        limits={"gateway": (1, 2), "replay": (3, 4)},
        cooldown_s=4.0, interval_s=0.5, probe=probe)

    try:
        # ---------------- phase A: spike -> scale-up -> graceful drain
        supervisor.scale_up("gateway", 1)
        for _ in range(3):
            supervisor.scale_up("replay", 1)
        pin_prov = pinning.pin_fleet(gw_fleet.pids() + rp_fleet.pids(),
                                     reserve_client=1)
        verdict["pinning"] = pin_prov
        scaler.start()

        fc = FleetClient(coordinator_addr=(coordinator.host, coordinator.port),
                         timeout_s=10.0, refresh_s=0.5)
        obs = {"x": np.ones((4, 4), dtype=np.float32)}
        sids = [f"el-{i}" for i in range(sessions)]
        errors, live = [], set()

        def step_all(rounds: int, budget_s: float, want_all: bool) -> None:
            deadline = time.monotonic() + budget_s
            for _ in range(rounds):
                pending = [s for s in sids if s in live or want_all]
                while pending and time.monotonic() < deadline:
                    results = fc.act_many(
                        [{"session_id": s, "obs": obs} for s in pending],
                        timeout_s=8.0)
                    nxt = []
                    for s, r in zip(pending, results):
                        if isinstance(r, ShedError):
                            nxt.append(s)  # spike backpressure: retry
                        elif isinstance(r, Exception):
                            errors.append((s, repr(r)))
                        else:
                            live.add(s)
                    pending = nxt
                    if pending:
                        time.sleep(0.2)

        # the spike: more sessions than the 1-gateway fleet can hold; shed
        # lanes keep retrying while residency pins the policy at 1.0
        spike = threading.Thread(target=step_all, args=(60, 60.0, True),
                                 daemon=True)
        spike.start()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 45.0:
            if len(fc.router.map) >= 2 and len(live) == sessions:
                break
            time.sleep(0.5)
        spike.join(30.0)
        scaled_to = len(fc.router.map.addrs)
        verdict["phase_a"]["scaled_to_gateways"] = scaled_to
        verdict["phase_a"]["sessions_live_after_join"] = len(live)
        verdict["phase_a"]["scale_up_decision"] = next(
            (d for d in scaler.status()["decisions"] if d["direction"] == "up"),
            None)
        if scaled_to < 2 or len(live) != sessions:
            failures.append(
                f"scale-up not observed live: {scaled_to} gateways, "
                f"{len(live)}/{sessions} sessions")

        # load drop: end sessions, preferring the OLDEST gateway's, so the
        # newest (the scale-down victim) keeps residents to migrate
        pins = fc.router.stats()["pins_per_gateway"]
        newest = supervisor.fleet("gateway").active_members()[-1].addr
        keep = [s for s in sids if fc.router._pins.get(s) == newest][:4]
        for s in sids:
            if s not in keep:
                try:
                    fc.end(s)
                except Exception:  # noqa: BLE001 - counted via errors below
                    errors.append((s, "end failed"))
                live.discard(s)

        # baseline counters BEFORE the decision can land: the refresher's
        # drain handoff fires within one refresh tick of the drain
        snap0 = get_registry().snapshot()
        mig0 = snap0.get("distar_fleet_session_migrations_total", 0.0)
        hand0 = snap0.get("distar_fleet_drain_handoff_sessions_total", 0.0)
        # wait for the cooldown scale-down decision (stepping paused, so
        # the victim's pin count is exact at decision time — the handoff
        # ends sessions on the victim but never unpins)
        down = None
        t0 = time.monotonic()
        while time.monotonic() - t0 < 45.0 and down is None:
            down = next((d for d in scaler.status()["decisions"]
                         if d["direction"] == "down"), None)
            time.sleep(0.3)
        if down is None:
            failures.append("no scale-down decision within budget")
            victim, victim_pins = None, 0
        else:
            victim = down["members"][0]
            victim_pins = len(fc.router.pins_on(victim))

        # resume stepping the survivors: their next act on the draining
        # gateway hands off (end-there + re-pin), carries re-materialize
        step_all(6, 40.0, False)
        snap1 = get_registry().snapshot()
        migrations = snap1.get("distar_fleet_session_migrations_total", 0.0) - mig0
        handoffs = snap1.get("distar_fleet_drain_handoff_sessions_total", 0.0) - hand0
        # the victim must exit on its own once drained
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30.0 and victim is not None:
            if victim not in [m.addr for m in gw_fleet.members()]:
                break
            time.sleep(0.3)
        victim_gone = victim is not None and \
            victim not in [m.addr for m in gw_fleet.members()]
        verdict["phase_a"].update({
            "pins_before_drain": pins, "drain_victim": victim,
            "victim_resident_at_decision": victim_pins,
            "migrations": migrations, "drain_handoffs": handoffs,
            "victim_exited": victim_gone,
            "non_shed_errors": len(errors),
        })
        if errors:
            failures.append(f"non-shed errors leaked: {errors[:5]}")
        if down is not None and not (
                migrations == handoffs == victim_pins and victim_pins > 0):
            failures.append(
                f"migration accounting inexact: migrations={migrations} "
                f"handoffs={handoffs} resident={victim_pins}")
        if down is not None and not victim_gone:
            failures.append("drained gateway did not exit")
        for s in keep:
            try:
                fc.end(s)
            except Exception:  # noqa: BLE001 - teardown
                pass
        fc.close()

        # ---------------- phase B: SIGKILL a replay member MID-DRAIN
        inj = ChaosInjector(seed=args.seed)
        inserter = ShardedInsertClient(
            ShardMap.discover((coordinator.host, coordinator.port)))
        inserter.start_refresh((coordinator.host, coordinator.port),
                               interval_s=0.5)
        keys = [f"k{i}" for i in range(args.items)]
        owner = {k: inserter.shard_for("drill", k) for k in keys}
        half = args.items // 2
        for k in keys[:half]:
            inserter.insert("drill", {"k": k}, key=k, timeout_s=10.0)

        members = rp_fleet.active_members()
        victim_m = max(members,
                       key=lambda m: sum(1 for k in keys if owner[k] == m.addr))
        victim_addr, victim_pid = victim_m.addr, victim_m.proc.pid
        victim_port = int(victim_addr.rsplit(":", 1)[1])
        victim_dir = os.path.join(args.dir, f"s{victim_m.meta['index']}")
        victim_resident = sum(1 for k in keys[:half] if owner[k] == victim_addr)

        rp_fleet.drain(victim_m)  # deregister-then-refuse; tail stays (no sampler)
        # the insert stream keeps running THROUGH the drain: draining
        # answers re-route each key to a survivor (overlay), and the
        # membership refresh soon drops the victim from the map entirely
        for k in keys[half:]:
            inserter.insert("drill", {"k": k}, timeout_s=10.0, key=k)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10.0 and \
                victim_addr in inserter.shard_map.addrs:
            time.sleep(0.2)
        map_dropped = victim_addr not in inserter.shard_map.addrs

        # the chaos moment: SIGKILL mid-drain (resident tail NOT drained)
        inj.kill_role(victim_pid, sig=signal.SIGKILL,
                      name=f"replay-mid-drain:{victim_addr}")
        time.sleep(1.0)

        # replacement over the victim's spill on the SAME port (identity =
        # host:port, so its ring segment comes back with it)
        import subprocess
        cmd = replay_cmd(spill_root=args.dir, coordinator=coord_addr,
                         extra=["--max-size", str(max(args.items * 2, 64)),
                                "--spill-max", str(max(args.items * 2, 64))])(
            int(victim_m.meta["index"]))
        cmd[cmd.index("--port") + 1] = str(victim_port)
        proc2 = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL, text=True)
        parts = proc2.stdout.readline().split()
        recovered = int(dict(t.split("=", 1) for t in parts[3:]
                             if "=" in t).get("recovered", -1))

        sampler = ShardedSampleClient(
            ShardMap.discover((coordinator.host, coordinator.port)))
        sampler.start_refresh((coordinator.host, coordinator.port),
                              interval_s=0.5)
        got = set()
        deadline = time.monotonic() + 45.0
        while time.monotonic() < deadline and len(got) < len(keys):
            try:
                items, _info = sampler.sample("drill", batch_size=1,
                                              timeout_s=1.0)
            except Exception:
                time.sleep(0.2)
                continue
            got.update(it["k"] for it in items)
        lost = sorted(set(keys) - got)
        verdict["phase_b"] = {
            "items": args.items, "killed_mid_drain": victim_addr,
            "victim_resident_at_kill": victim_resident,
            "map_dropped_victim_before_kill": map_dropped,
            "recovered_from_spill": recovered,
            "sampled_unique": len(got), "lost_acked": len(lost),
        }
        if lost:
            failures.append(f"acked items lost: {lost[:10]}")
        if recovered < victim_resident:
            failures.append(
                f"spill recovered {recovered} < victim's resident tail "
                f"{victim_resident}")
        if not map_dropped:
            failures.append("live membership never dropped the draining shard")
        inserter.close()
        sampler.close()
        try:
            proc2.stdin.close()
            proc2.wait(timeout=10)
        except Exception:  # noqa: BLE001 - teardown
            proc2.kill()
    finally:
        scaler.stop()
        supervisor.stop()
        coordinator.stop()

    verdict["failures"] = failures
    print(json.dumps(verdict, default=str))
    print("verdict: load spike scaled the fleet up live, cooldown drained "
          "a member with exact migration accounting, and a mid-drain "
          "SIGKILL lost zero acked items"
          if not failures else f"verdict: DRILL FAILED {failures}")
    return 0 if not failures else 1


def cmd_dynamics_drill(args) -> int:
    """End-to-end drill for the training-dynamics observatory: poison one
    module's params with a NaN mid-run (``ChaosInjector.poison_module`` — a
    real numeric fault, pre-step) and prove the whole forensic chain:

      (a) the dynamics census localizes the fault to EXACTLY the poisoned
          module (provenance origin ``params``, narrowest family wins);
      (b) exactly ONE learner_grad_nonfinite alert fires, carrying a
          ``blackbox:<bundle>`` exemplar (debounce: one anomaly, one alert);
      (c) exactly one black-box bundle lands in the experiment's blackbox/
          directory;
      (d) ``python -m distar_tpu_torch.tools.stepreplay`` re-executes the
          step from the bundle ALONE (subprocess, fresh interpreter) and
          reproduces the non-finite step deterministically (exit 0).

    Runs the real SL learner (tiny flagship-shaped model) in process on
    ``--device``; health evaluation is driven deterministically once per
    step."""
    import copy
    import subprocess

    from ..actor.inference import resolve_device

    device = resolve_device(args.device)

    os.environ.setdefault("DISTAR_PERF_AOT", "0")
    os.environ["DISTAR_EXPERIMENTS_ROOT"] = args.dir

    from ..learner import SLLearner
    from ..model.convert import learner_state_to_flax, load_learner_state
    from .dynamics_overhead import SMALL_MODEL
    from ..obs import FleetHealth, default_rulebook, get_registry
    from ..obs.dynamics import list_bundles, load_bundle

    exp = os.path.join(args.dir, "exp")
    learner = SLLearner({
        "common": {"save_path": exp},
        "learner": {
            "batch_size": 2, "unroll_len": 2,
            "save_freq": 10 ** 6, "log_freq": 1,
            "dynamics": {"every_n": 1, "blackbox_cap": 4},
        },
        "model": SMALL_MODEL,
    }, device=device)
    fh = FleetHealth(rules=default_rulebook(roles=("learner",)),
                     registry=get_registry())  # driven manually, not started

    modules = sorted(name for name, _ in learner.model.named_children())
    module = args.module or modules[0]
    if module not in modules:
        print(f"module {module!r} not in model (choose from {modules})")
        return 2

    inj = ChaosInjector(seed=args.seed)
    total = args.pre_steps + 1 + args.post_steps

    def step_to(n: int) -> None:
        learner.run(max_iterations=n)
        fh.sampler.sample_once()
        fh.evaluator.evaluate_once()

    for i in range(args.pre_steps):
        step_to(i + 1)  # clean baseline: EMA + census gauges at healthy 0
    # pre-poison snapshot = the "restore from last good checkpoint" the
    # on-call would do; without it the NaN update poisons every later step
    snap_state = learner_state_to_flax(learner.model, learner.optimizer)
    snap_hidden = copy.deepcopy(learner.hidden)
    inj.poison_module(learner, module, n=1)
    print(f"poisoned module {module!r} params before step {args.pre_steps}")
    step_to(args.pre_steps + 1)  # the anomalous step
    inj.restore()
    load_learner_state(snap_state, learner.model, learner.optimizer)
    learner.hidden = snap_hidden
    for i in range(args.pre_steps + 1, total):
        step_to(i + 1)  # recovery: debounce must hold at one bundle

    failures = []
    bundles = list_bundles(os.path.join(exp, "blackbox"))
    if len(bundles) != 1:
        failures.append(f"expected exactly 1 black-box bundle, found "
                        f"{[b['id'] for b in bundles]}")
    provenance = None
    if bundles:
        bundle = load_bundle(bundles[0]["path"])
        provenance = bundle.get("provenance")
        if not provenance or provenance.get("origin") != "params" \
                or provenance.get("module") != module:
            failures.append(f"provenance did not name the poisoned module: "
                            f"{provenance}")
    alerts = fh.evaluator.alerts()
    rule = alerts["rules"].get("learner_grad_nonfinite", {})
    if rule.get("fired_count") != 1:
        failures.append(f"learner_grad_nonfinite fired_count="
                        f"{rule.get('fired_count')} (wanted exactly 1)")
    other_fired = [n for n in ("learner_loss_nonfinite",
                               "learner_grad_explosion",
                               "learner_entropy_collapse")
                   if alerts["rules"].get(n, {}).get("fired_count", 0) > 0]
    if other_fired:
        failures.append(f"other anomaly rules fired: {other_fired}")
    firing_events = [e for e in alerts["history"]
                     if e["rule"] == "learner_grad_nonfinite"
                     and e["state"] == "firing"]
    exemplar = firing_events[-1].get("exemplar_trace_id") if firing_events else None
    if not (exemplar or "").startswith("blackbox:"):
        failures.append(f"firing alert carries no blackbox exemplar: {exemplar!r}")
    elif bundles and exemplar != f"blackbox:{bundles[0]['id']}":
        failures.append(f"exemplar {exemplar!r} != bundle {bundles[0]['id']!r}")

    replay_verdict = None
    if bundles:
        proc = subprocess.run(
            [sys.executable, "-m", "distar_tpu_torch.tools.stepreplay",
             "--bundle", bundles[0]["path"], "--json", "--device", device.type,
             "--workdir", os.path.join(args.dir, "replay")],
            capture_output=True, text=True, timeout=1200, cwd=_REPO,
            env=dict(os.environ))
        try:
            replay_verdict = json.loads(proc.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            replay_verdict = None
        if proc.returncode != 0 or replay_verdict is None:
            failures.append(f"stepreplay exited {proc.returncode}: "
                            f"{proc.stderr[-800:]}")
        else:
            for want in ("nonfinite_reproduced", "deterministic"):
                if not replay_verdict.get(want):
                    failures.append(f"stepreplay verdict lacks {want}: "
                                    f"{replay_verdict}")

    verdict = {
        "module": module, "steps": total,
        "poisoned_at_step": args.pre_steps,
        "bundles": [b["id"] for b in bundles],
        "provenance": provenance,
        "anomaly_rule_fired_count": rule.get("fired_count"),
        "exemplar_trace_id": exemplar,
        "replay": replay_verdict,
        "events": [e["kind"] for e in inj.events],
        "failures": failures,
    }
    print(json.dumps(verdict, default=str))
    print("verdict: NaN localized to the poisoned module, one alert with a "
          "black-box exemplar, and stepreplay reproduced the step from the "
          "bundle alone"
          if not failures else f"verdict: DRILL FAILED {failures}")
    return 0 if not failures else 1


# evaluator child for the arena drill: a REAL subprocess speaking the real
# arena_next/arena_report wire plane, killable with SIGKILL mid-batch.
# Anchors-only roster (the checkpoint dir is empty) so no model compiles.
_ARENA_CHILD = r"""
import os, sys, time
repo = sys.argv[1]
if repo not in sys.path:
    sys.path.insert(0, repo)
host, port = sys.argv[2], int(sys.argv[3])
ckpt, batches, episodes = sys.argv[4], int(sys.argv[5]), int(sys.argv[6])
units, ep_len = int(sys.argv[7]), int(sys.argv[8])
device = sys.argv[9]
from distar_tpu_torch.arena import ArenaEvaluator
from distar_tpu_torch.envs.jaxenv import EnvConfig, ScenarioConfig
ev = ArenaEvaluator(
    ckpt, model_cfg={}, coordinator_addr=(host, port), episodes=episodes,
    env_cfg=EnvConfig(units_per_squad=units),
    scenario_cfg=ScenarioConfig(units_per_squad=units, max_units=units,
                                episode_len=ep_len), device=device)
done = 0
while done < batches:
    print("BATCH_START %d" % done, flush=True)
    out = ev.evaluate_once()
    if out is None:
        time.sleep(0.2)
        continue
    ack = out["ack"]
    print("BATCH_DONE %d applied=%d duplicates=%d"
          % (done, ack["applied"], ack["duplicates"]), flush=True)
    done += 1
print("EVAL_EXIT", flush=True)
"""


def cmd_arena_drill(args) -> int:
    """Kill an arena evaluator mid-batch and restart it: zero lost and zero
    double-counted matches by idempotent-key construction.

    Stands up a real coordinator hosting a durable ArenaStore, runs a real
    evaluator subprocess (anchors-only roster: scripted policies, no model
    loads) over the real ``arena_next``/``arena_report`` wire plane, and
    SIGKILLs it shortly after a batch starts — the assignment is taken and
    the scenario is running, but nothing is reported. The restarted
    evaluator must re-receive the identical assignment (scheduling is a
    pure function of *reported* state) and finish the run with EXACT
    accounting:

      (a) applied matches == scheduled matches (zero lost);
      (b) zero idempotent-key duplicates during normal operation, and a
          deliberately replayed ack — the whole last batch re-sent over the
          wire, as a crashed-after-report evaluator would — dedups 100%
          with the match total unchanged (zero double-counted);
      (c) the round counter advanced exactly once per completed batch;
      (d) the journal reloads into a fresh store that STILL dedups the
          replayed batch (idempotency survives a coordinator restart)."""
    import subprocess

    from ..actor.inference import resolve_device

    device = resolve_device(args.device).type
    os.makedirs(args.dir, exist_ok=True)

    from ..arena import (ArenaStore, match_key, set_arena_store)
    from ..comm.coordinator import (CoordinatorServer,
                                             coordinator_request)

    journal = os.path.join(args.dir, "arena.journal")
    ckpt_dir = os.path.join(args.dir, "ckpt")  # empty -> anchors-only roster
    os.makedirs(ckpt_dir, exist_ok=True)
    store = ArenaStore(path=journal)
    set_arena_store(store)
    srv = CoordinatorServer()
    srv.start()
    inj = ChaosInjector(seed=args.seed)
    episodes = int(args.episodes)

    def spawn(batches: int):
        return subprocess.Popen(
            [sys.executable, "-c", _ARENA_CHILD, _REPO, srv.host,
             str(srv.port), ckpt_dir, str(batches), str(episodes), "2", "12",
             device],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            bufsize=1, cwd=_REPO, env=dict(os.environ))

    failures = []
    proc = proc2 = None
    try:
        kill_after = max(1, int(args.kill_after))
        total = max(kill_after + 1, int(args.batches))
        proc = spawn(total)
        assert proc.stdout is not None
        for line in proc.stdout:
            if line.startswith(f"BATCH_START {kill_after}"):
                break
        time.sleep(args.kill_delay_s)  # land inside the running scenario
        inj.kill_role(proc.pid, sig=signal.SIGKILL, name="arena-evaluator")
        proc.wait(timeout=60)
        matches_at_kill = store.matches_total
        killed_mid_batch = matches_at_kill < (kill_after + 1) * episodes
        # the hole the restarted evaluator must fill: pure re-ask, no state
        hole = store.next_match([], episodes=episodes)
        if hole is None:
            failures.append("store refused to re-issue the lost assignment")

        proc2 = spawn(total - matches_at_kill // episodes)
        out2, _ = proc2.communicate(timeout=args.timeout_s)
        if proc2.returncode != 0:
            failures.append(f"restarted evaluator exited {proc2.returncode}")
        if "duplicates=0" not in out2 or "EVAL_EXIT" not in out2:
            failures.append(f"restarted evaluator log unexpected: {out2!r}")

        expected = total * episodes
        if store.matches_total != expected:
            failures.append(f"lost matches: applied {store.matches_total}, "
                            f"scheduled {expected}")
        if store.duplicates_total != 0:
            failures.append(f"{store.duplicates_total} duplicates during "
                            "normal operation (keys must be unique)")
        if len(store._seen) != expected:
            failures.append(f"seen-key set has {len(store._seen)} entries, "
                            f"wanted {expected} distinct keys")
        pair = tuple(sorted(store.anchors))
        rounds = store._next_round.get(pair)
        if rounds != total:
            failures.append(f"round counter at {rounds}, wanted {total} "
                            "(one advance per completed batch)")
        if hole is not None:
            refilled = [match_key(hole["home"], hole["away"], hole["round"], i)
                        in store._seen for i in range(episodes)]
            if not all(refilled):
                failures.append(f"re-issued assignment {hole} not fully "
                                f"applied after restart: {refilled}")

        # the double-count arm: replay the final batch's ack over the wire,
        # exactly as an evaluator killed AFTER reporting would on restart
        last = total - 1
        home, away = pair if last % 2 == 0 else (pair[1], pair[0])
        replay = [{"key": match_key(home, away, last, i), "home": home,
                   "away": away, "round": last, "winner": "draw",
                   "game_steps": 1, "duration_s": 0.0}
                  for i in range(episodes)]
        resp = coordinator_request(srv.host, srv.port, "arena_report",
                                   {"matches": replay})
        ack = resp.get("info") if resp.get("code") == 0 else None
        if not ack or ack.get("applied") != 0 \
                or ack.get("duplicates") != episodes:
            failures.append(f"replayed ack was not fully deduped: {resp}")
        if store.matches_total != expected:
            failures.append("replayed ack double-counted matches")

        # idempotency must survive a coordinator restart via the journal
        store.save()
        fresh = ArenaStore(path=journal)
        fresh.maybe_load()
        ack2 = fresh.report_batch(replay)
        if fresh.matches_total != expected or ack2["applied"] != 0:
            failures.append(f"journal reload lost idempotency: "
                            f"matches={fresh.matches_total}, ack={ack2}")

        verdict = {
            "batches": total, "episodes": episodes,
            "killed_after_batch": kill_after,
            "killed_mid_batch": killed_mid_batch,
            "matches_at_kill": matches_at_kill,
            "matches_applied": store.matches_total,
            "duplicates": store.duplicates_total,
            "replayed_ack_deduped": bool(ack and ack.get("duplicates") == episodes),
            "events": [e["kind"] for e in inj.events],
            "failures": failures,
        }
        print(json.dumps(verdict, default=str))
        print("verdict: evaluator killed mid-batch and restarted; zero lost, "
              "zero double-counted, replayed ack deduped before and after a "
              "journal reload" if not failures
              else f"verdict: DRILL FAILED {failures}")
        return 0 if not failures else 1
    finally:
        for p_ in (proc, proc2):
            if p_ is not None and p_.poll() is None:
                p_.kill()
        srv.stop()
        set_arena_store(None)


_COORDINATOR_CHILD = r"""
import os, sys, time
repo = sys.argv[1]
if repo not in sys.path:
    sys.path.insert(0, repo)
port, journal_dir, role = int(sys.argv[2]), sys.argv[3], sys.argv[4]
peers = [p for p in sys.argv[5].split(",") if p and p != "-"]
grace, lease_s = float(sys.argv[6]), float(sys.argv[7])
from distar_tpu_torch.arena import ArenaStore, set_arena_store
from distar_tpu_torch.comm.coordinator import Coordinator, CoordinatorServer
set_arena_store(ArenaStore())
co = Coordinator(default_lease_s=lease_s)
srv = CoordinatorServer(coordinator=co, port=port)
if role != "none":
    from distar_tpu_torch.comm.ha import HAState
    ha = HAState(co, journal_dir, advertise="127.0.0.1:%d" % srv.port,
                 peers=peers, role=role, takeover_grace_s=grace,
                 snapshot_every=64)
    ha.boot()
    srv.attach_ha(ha)
srv.start()
print("READY %d" % srv.port, flush=True)
while True:
    time.sleep(1)
"""


def cmd_coordinator_drill(args) -> int:
    """SIGKILL the primary coordinator under live fleet load and prove the
    HA contract end to end (the broker was the fleet's last SPOF):

      LEG 1 — failover: primary + warm standby, live load (producers
      registering payload records, an arena reporter, discovery heartbeats,
      a telemetry shipper) → SIGKILL the primary mid-run. The standby must
      be serving within one lease window; draining the queue afterwards
      must surface EVERY acked register exactly once (semi-synchronous
      replication: an ack means the standby has it); re-reporting every
      acked arena batch must dedup 100% (zero double-counted matches);
      heartbeated leases survive, an abandoned lease is cleanly evicted;
      the revived old primary must rejoin as a STANDBY (epoch fencing) and
      the shipper must have counted a resync.

      LEG 2 — cold restart: kill every coordinator, restart one over its
      journal alone — acked items, arena accounting and dedup keys must be
      reconstructed exactly by snapshot + WAL replay.

      LEG 3 (--no-ha or always-on counter-demo) — a journal-less
      coordinator demonstrably LOSES acked items across the same kill: the
      baseline the durability contract is measured against."""
    import itertools
    import socket
    import subprocess
    import threading

    os.makedirs(args.dir, exist_ok=True)

    from ..comm import ha as ha_mod
    from ..comm.coordinator import coordinator_request
    from ..comm.discovery import register_endpoint
    from ..obs import get_registry
    from ..obs.shipper import TelemetryShipper

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def spawn(port: int, jdir: str, role: str, peers: str):
        proc = subprocess.Popen(
            [sys.executable, "-c", _COORDINATOR_CHILD, _REPO, str(port),
             jdir, role, peers or "-", str(args.grace_s), str(args.lease_s)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            bufsize=1, cwd=_REPO, env=dict(os.environ))
        assert proc.stdout is not None
        deadline = time.time() + 30
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("READY"):
                return proc
            if proc.poll() is not None:
                break
        raise RuntimeError(f"coordinator child on :{port} never came up")

    inj = ChaosInjector(seed=args.seed)
    failures = []
    children = []
    lease_s = float(args.lease_s)

    if args.no_ha:
        # counter-demo only: journal-less coordinator loses acked items
        port = free_port()
        proc = spawn(port, os.path.join(args.dir, "none"), "none", "-")
        children.append(proc)
        for i in range(10):
            coordinator_request("127.0.0.1", port, "register",
                                {"token": "demo", "ip": f"10.3.0.{i}", "port": 1})
        inj.kill_role(proc.pid, sig=signal.SIGKILL, name="coordinator")
        proc.wait(timeout=30)
        proc = spawn(port, os.path.join(args.dir, "none"), "none", "-")
        children.append(proc)
        depth = coordinator_request("127.0.0.1", port, "depth",
                                    {"token": "demo"}).get("info")
        lost = 10 - int(depth or 0)
        verdict = {"mode": "no-ha counter-demo", "acked": 10, "lost": lost,
                   "failures": [] if lost > 0 else
                   ["journal-less restart did NOT lose state?"]}
        print(json.dumps(verdict))
        print("verdict: journal-less coordinator lost "
              f"{lost}/10 acked items across a SIGKILL — the loss HA exists "
              "to prevent" if lost > 0 else "verdict: DRILL FAILED")
        for p_ in children:
            if p_.poll() is None:
                p_.kill()
        return 0 if lost > 0 else 1

    p1, p2 = free_port(), free_port()
    addr1, addr2 = f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"
    spec = f"{addr1},{addr2}"
    j1, j2 = os.path.join(args.dir, "j1"), os.path.join(args.dir, "j2")
    ha_mod.reset_targets()

    primary = spawn(p1, j1, "primary", "-")
    standby = spawn(p2, j2, "standby", addr1)
    children += [primary, standby]
    shipper = None
    hb_thread = None
    try:
        # ------------------------------------------------------ live load
        stop_load = threading.Event()
        acked_lock = threading.Lock()
        acked_items: list = []     # "ip:port" acked under token "payload"
        ack_times: list = []
        acked_batches: list = []   # arena batches acked (list of records)
        counter = itertools.count()

        def pusher():
            while not stop_load.is_set():
                i = next(counter)
                ip = f"10.1.{i // 250}.{i % 250}"
                try:
                    r = coordinator_request(spec, None, "register",
                                            {"token": "payload", "ip": ip,
                                             "port": 7}, timeout=5.0)
                    if r.get("code") == 0:
                        with acked_lock:
                            acked_items.append(f"{ip}:7")
                            ack_times.append(time.time())
                except Exception:
                    pass
                time.sleep(0.02)

        def reporter():
            b = 0
            while not stop_load.is_set():
                batch = [{"key": f"a|b|r{b}e{i}", "home": "a", "away": "b",
                          "round": b, "winner": "draw", "game_steps": 1,
                          "duration_s": 0.0} for i in range(4)]
                try:
                    r = coordinator_request(spec, None, "arena_report",
                                            {"matches": batch}, timeout=5.0)
                    if r.get("code") == 0:
                        with acked_lock:
                            acked_batches.append(batch)
                        b += 1
                except Exception:
                    pass
                time.sleep(0.05)

        threads = [threading.Thread(target=pusher, daemon=True),
                   threading.Thread(target=reporter, daemon=True)]
        for t in threads:
            t.start()
        # a heartbeated service lease (must survive the failover) and an
        # abandoned one (must be cleanly evicted when its lease lapses)
        hb_stop = threading.Event()
        hb_thread = register_endpoint((spec, None), "svc", "10.9.0.1", 1,
                                      lease_s=lease_s,
                                      heartbeat_interval_s=max(0.5, lease_s / 8),
                                      stop_event=hb_stop)
        coordinator_request(spec, None, "register",
                            {"token": "svc", "ip": "10.9.0.2", "port": 1,
                             "lease_s": lease_s})
        shipper = TelemetryShipper("coordinator-drill",
                                   coordinator_addr=(spec, None),
                                   interval_s=0.5).start()

        deadline = time.time() + args.timeout_s
        while time.time() < deadline:
            with acked_lock:
                if len(acked_items) >= args.items and len(acked_batches) >= 3:
                    break
            time.sleep(0.1)
        st1 = ha_mod.probe_ha_status(addr1)
        epoch_before = int(st1["epoch"]) if st1 else -1

        # ------------------------------------------------- the SIGKILL
        t_kill = time.time()
        inj.kill_role(primary.pid, sig=signal.SIGKILL, name="coordinator-primary")
        primary.wait(timeout=30)

        with acked_lock:
            acked_at_kill = len(acked_items)
        while time.time() < deadline:
            with acked_lock:
                if len(acked_items) >= acked_at_kill + args.post_items:
                    break
            time.sleep(0.1)
        with acked_lock:
            recovery_s = next((t - t_kill for t in ack_times if t > t_kill),
                              None)
        if recovery_s is None:
            failures.append("no register was acked after the primary kill")
        elif recovery_s > lease_s:
            failures.append(f"standby took {recovery_s:.1f}s to serve "
                            f"(> one lease window {lease_s:.0f}s)")
        st2 = ha_mod.probe_ha_status(addr2)
        if not st2 or st2.get("role") != "primary":
            failures.append(f"standby did not take over: {st2}")
        elif int(st2.get("epoch", -1)) <= epoch_before:
            failures.append(f"promotion did not bump the epoch: {st2} "
                            f"vs {epoch_before}")

        # ------------------------------- epoch fencing: revive the victim
        revived = spawn(p1, j1, "auto", addr2)
        children.append(revived)
        revived_role = None
        for _ in range(40):
            st = ha_mod.probe_ha_status(addr1)
            revived_role = st.get("role") if st else None
            if revived_role == "standby":
                break
            time.sleep(0.25)
        if revived_role != "standby":
            failures.append("revived old primary did not rejoin as standby: "
                            f"{revived_role}")
        stop_load.set()
        for t in threads:
            t.join(timeout=10)

        # ------------------------------------- zero lost acked queue items
        popped = []
        empties = 0
        while empties < 5:
            r = coordinator_request(spec, None, "ask", {"token": "payload"},
                                    timeout=5.0)
            info = r.get("info")
            if r.get("code") == 0 and info:
                popped.append(f"{info['ip']}:{info['port']}")
                empties = 0
            else:
                empties += 1
        with acked_lock:
            acked_set = set(acked_items)
        lost = acked_set - set(popped)
        if lost:
            failures.append(f"{len(lost)} acked queue items lost across "
                            f"failover: {sorted(lost)[:5]}...")
        if len(popped) != len(set(popped)):
            failures.append("a queue item was popped twice")
        extras = len(set(popped) - acked_set)  # applied-but-unacked: benign

        # --------------------------------- zero double-counted arena matches
        st2 = ha_mod.probe_ha_status(addr2) or {}
        with acked_lock:
            replay_all = [rec for batch in acked_batches for rec in batch]
        import urllib.request

        with urllib.request.urlopen(f"http://{addr2}/arena/ratings",
                                    timeout=5.0) as resp:
            matches_before = int(json.loads(resp.read())["matches_total"])
        rr = coordinator_request(spec, None, "arena_report",
                                 {"matches": replay_all})
        ack = rr.get("info") or {}
        if rr.get("code") != 0 or ack.get("applied") != 0 \
                or ack.get("duplicates") != len(replay_all):
            failures.append(f"replayed acked arena batches not fully "
                            f"deduped: {rr}")
        with urllib.request.urlopen(f"http://{addr2}/arena/ratings",
                                    timeout=5.0) as resp:
            matches_after = int(json.loads(resp.read())["matches_total"])
        if matches_after != matches_before:
            failures.append(f"arena matches double-counted across failover: "
                            f"{matches_before} -> {matches_after}")

        # ------------------- every lease re-established or cleanly evicted
        svc = {f"{r['ip']}:{r['port']}" for r in
               coordinator_request(spec, None, "peers",
                                   {"token": "svc"}).get("info") or ()}
        if "10.9.0.1:1" not in svc:
            failures.append("heartbeated lease did not survive the failover")
        evict_deadline = time.time() + lease_s + 5
        while "10.9.0.2:1" in svc and time.time() < evict_deadline:
            time.sleep(0.5)
            svc = {f"{r['ip']}:{r['port']}" for r in
                   coordinator_request(spec, None, "peers",
                                       {"token": "svc"}).get("info") or ()}
        if "10.9.0.2:1" in svc:
            failures.append("abandoned lease was never evicted on the "
                            "new primary")

        resyncs = sum(v for k, v in get_registry().snapshot().items()
                      if k.startswith("distar_obs_shipper_resyncs_total"))
        if resyncs < 1:
            failures.append("telemetry shipper never counted a resync "
                            "across the failover")

        # ------------------------------------------ LEG 2: cold restart
        cold_acked = []
        for i in range(5):
            r = coordinator_request(spec, None, "register",
                                    {"token": "cold", "ip": f"10.2.0.{i}",
                                     "port": 9})
            if r.get("code") == 0:
                cold_acked.append(f"10.2.0.{i}:9")
        hb_stop.set()
        shipper.stop()
        for proc in (standby, revived):
            inj.kill_role(proc.pid, sig=signal.SIGKILL, name="coordinator")
            proc.wait(timeout=30)
        cold = spawn(p2, j2, "auto", addr1)
        children.append(cold)
        st_cold = ha_mod.probe_ha_status(addr2)
        if not st_cold or st_cold.get("role") != "primary":
            failures.append(f"cold restart did not take leadership: {st_cold}")
        cold_popped = []
        empties = 0
        while empties < 5:
            r = coordinator_request(spec, None, "ask", {"token": "cold"},
                                    timeout=5.0)
            info = r.get("info")
            if r.get("code") == 0 and info:
                cold_popped.append(f"{info['ip']}:{info['port']}")
                empties = 0
            else:
                empties += 1
        if set(cold_popped) != set(cold_acked):
            failures.append(f"journal replay lost acked items: wanted "
                            f"{cold_acked}, got {cold_popped}")
        rr = coordinator_request(spec, None, "arena_report",
                                 {"matches": replay_all})
        ack = rr.get("info") or {}
        if rr.get("code") != 0 or ack.get("applied") != 0:
            failures.append(f"arena dedup keys did not survive the cold "
                            f"journal replay: {rr}")
        with urllib.request.urlopen(f"http://{addr2}/arena/ratings",
                                    timeout=5.0) as resp:
            matches_cold = int(json.loads(resp.read())["matches_total"])
        if matches_cold != matches_after:
            failures.append(f"cold replay changed arena accounting: "
                            f"{matches_after} -> {matches_cold}")

        verdict = {
            "acked_items": len(acked_set), "popped": len(popped),
            "applied_unacked_extras": extras,
            "acked_arena_matches": len(replay_all),
            "matches_total": matches_after,
            "recovery_s": recovery_s,
            "lease_window_s": lease_s,
            "epoch_before": epoch_before,
            "epoch_after": st2.get("epoch"),
            "revived_old_primary_role": revived_role,
            "shipper_resyncs": resyncs,
            "cold_restart_items": len(cold_popped),
            "events": [e["kind"] for e in inj.events],
            "failures": failures,
        }
        print(json.dumps(verdict, default=str))
        print("verdict: primary SIGKILL'd under live load; standby served "
              f"in {recovery_s:.1f}s, zero acked items lost, zero arena "
              "matches double-counted, fencing demoted the revived primary, "
              "cold journal replay exact" if not failures
              else f"verdict: DRILL FAILED {failures}")
        return 0 if not failures else 1
    finally:
        if shipper is not None:
            shipper.stop()
        if hb_thread is not None:
            hb_thread.stop_event.set()
        for p_ in children:
            if p_.poll() is None:
                p_.kill()
        ha_mod.reset_targets()


_LEAGUE_PLANE_CHILD = r"""
import os, sys, time
repo = sys.argv[1]
if repo not in sys.path:
    sys.path.insert(0, repo)
port, journal_dir = int(sys.argv[2]), sys.argv[3]
players = sys.argv[4].split(",")
seed, lease_s, job_ttl_s = int(sys.argv[5]), float(sys.argv[6]), float(sys.argv[7])
from distar_tpu_torch.arena import ArenaStore, set_arena_store
from distar_tpu_torch.comm.coordinator import Coordinator, CoordinatorServer
from distar_tpu_torch.league.runtime import LeagueService, set_league_service
from distar_tpu_torch.league.runtime.runner import league_cfg
store = ArenaStore()
set_arena_store(store)
service = LeagueService(league_cfg(players), seed=seed,
                        lease_s=lease_s, job_ttl_s=job_ttl_s)
set_league_service(service)
co = Coordinator()
srv = CoordinatorServer(coordinator=co, port=port)
if journal_dir != "-":
    from distar_tpu_torch.comm.ha import HAState
    ha = HAState(co, journal_dir, advertise="127.0.0.1:%d" % srv.port,
                 role="primary", snapshot_every=64,
                 arena_store_fn=lambda: store,
                 league_service_fn=lambda: service)
    ha.boot()
    srv.attach_ha(ha)
srv.start()
print("READY %d" % srv.port, flush=True)
while True:
    time.sleep(1)
"""

_LEAGUE_LEARNER_CHILD = r"""
import json, os, sys, time
repo = sys.argv[1]
if repo not in sys.path:
    sys.path.insert(0, repo)
addr, player_id, learner_id = sys.argv[2], sys.argv[3], sys.argv[4]
rounds, sleep_s = int(sys.argv[5]), float(sys.argv[6])
from distar_tpu_torch.league.remote import RemoteLeagueService
remote = RemoteLeagueService(addr, timeout=10.0)
reply = remote.register_learner(player_id, learner_id=learner_id)
print("REG " + json.dumps(reply), flush=True)
if not reply.get("registered"):
    sys.exit(3)
base = int(reply.get("train_seq", -1)) + 1
for i in range(rounds):
    job = remote.ask_job(player_id, learner_id=learner_id)
    rec = {"key": "%se0" % job["job_id"], "home": player_id,
           "away": job["player_ids"][1], "round": 0,
           "winner": ("home", "away", "draw")[i % 3],
           "game_steps": 8, "duration_s": 0.1}
    out = remote.report(job["job_id"], [rec], learner_id=learner_id)
    if out.get("applied"):
        print("MATCH " + json.dumps(rec), flush=True)
    seq = base + i
    gen = "/fake/%s_g%d.ckpt" % (player_id, seq)
    ti = remote.train_info(player_id, seq=seq, train_steps=1,
                           checkpoint_path=gen, generation_path=gen,
                           learner_id=learner_id)
    print("SEQ %d minted=%d snap=%s" % (
        seq, 1 if ti.get("minted") else 0, ti.get("snapshot_id", "-")),
        flush=True)
    time.sleep(sleep_s)
print("DONE %d" % rounds, flush=True)
"""


def cmd_league_drill(args) -> int:
    """SIGKILL one league learner mid-league and prove the matchmaking
    control plane's failure model (the self-play economy must degrade to a
    smaller economy, never a corrupted one):

      * the killed learner's player FREEZES (lease-derived, no tombstone)
        instead of vanishing — it stays on the active roster and its
        minted historical snapshots stay matchable;
      * the surviving learners keep drawing and completing jobs;
      * a supervised restart re-registers under the same learner id and
        resumes its train-info lineage past the service's seq watermark;
      * the dead learner's abandoned assignment expires after the job TTL
        (counted as orphaned) and the assignment map drains to empty —
        matchmaking state is uncorrupted;
      * SIGKILL the coordinator afterwards and cold-restart it over its
        HA journal alone: roster, snapshot lineage, branch counters and
        arena dedup keys reconstruct exactly — re-reporting every acked
        match dedups 100% (zero lost, zero double-counted).

      --no-journal is the counter-demo: the same kill against a
      journal-less control plane provably FORGETS the league (mints gone,
      seq watermark reset, acked matches double-count on replay)."""
    import json as _json
    import socket
    import subprocess
    import threading
    import urllib.request

    os.makedirs(args.dir, exist_ok=True)

    from ..comm import ha as ha_mod
    from ..league.remote import RemoteLeagueService

    players = ("MP0", "EP0", "ME0")
    victim = "EP0"
    lease_s = float(args.lease_s)
    job_ttl_s = float(args.job_ttl_s)
    inj = ChaosInjector(seed=args.seed)
    failures = []
    children = []

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def spawn_plane(port: int, jdir: str):
        proc = subprocess.Popen(
            [sys.executable, "-c", _LEAGUE_PLANE_CHILD, _REPO, str(port),
             jdir, ",".join(players), str(args.seed), str(lease_s),
             str(job_ttl_s)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            bufsize=1, cwd=_REPO, env=dict(os.environ))
        assert proc.stdout is not None
        deadline = time.time() + 30
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("READY"):
                children.append(proc)
                return proc
            if proc.poll() is not None:
                break
        raise RuntimeError(f"league control plane on :{port} never came up")

    def spawn_learner(addr: str, pid: str, learner_id: str, rounds: int):
        """Learner child + stdout collector: REG reply, acked match
        records, acked train-info seqs and minted snapshot ids."""
        proc = subprocess.Popen(
            [sys.executable, "-c", _LEAGUE_LEARNER_CHILD, _REPO, addr, pid,
             learner_id, str(rounds), str(args.round_sleep_s)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            bufsize=1, cwd=_REPO, env=dict(os.environ))
        children.append(proc)
        acked = {"reg": None, "matches": [], "seqs": [], "snaps": [],
                 "proc": proc}
        lock = threading.Lock()

        def reader():
            assert proc.stdout is not None
            for line in proc.stdout:
                with lock:
                    if line.startswith("REG "):
                        acked["reg"] = _json.loads(line[4:])
                    elif line.startswith("MATCH "):
                        acked["matches"].append(_json.loads(line[6:]))
                    elif line.startswith("SEQ "):
                        parts = line.split()
                        acked["seqs"].append(int(parts[1]))
                        if parts[2] == "minted=1":
                            acked["snaps"].append(parts[3].split("=", 1)[1])

        threading.Thread(target=reader, daemon=True).start()
        acked["lock"] = lock
        return acked

    def league_status(addr: str) -> dict:
        with urllib.request.urlopen(f"http://{addr}/league/status",
                                    timeout=5.0) as resp:
            return _json.loads(resp.read())

    DIGEST_KEYS = ("active_players", "historical_players", "snapshot_mints",
                   "jobs_by_branch", "orphaned_jobs", "minted")

    ha_mod.reset_targets()
    port = free_port()
    try:
        if args.no_journal:
            # ---------------------- counter-demo: the league is forgotten
            plane = spawn_plane(port, "-")
            addr = f"127.0.0.1:{port}"
            lrn = spawn_learner(addr, "MP0", "MP0-learner", rounds=5)
            lrn["proc"].wait(timeout=60)
            with lrn["lock"]:
                acked_seqs = list(lrn["seqs"])
                acked_matches = list(lrn["matches"])
                mints_acked = len(lrn["snaps"])
            inj.kill_role(plane.pid, sig=signal.SIGKILL,
                          name="league-coordinator")
            plane.wait(timeout=30)
            spawn_plane(port, "-")
            st = league_status(addr)
            remote = RemoteLeagueService(addr, timeout=10.0)
            reg = remote.register_learner("MP0", learner_id="MP0-learner")
            resend = remote.report("RESEND", acked_matches)
            lost_mints = mints_acked - int(st["snapshot_mints"])
            watermark_lost = int(reg.get("train_seq", -1)) < max(acked_seqs)
            double_counted = int(resend.get("applied", 0))
            verdict = {
                "mode": "no-journal counter-demo",
                "acked_mints": mints_acked, "mints_after_restart":
                    st["snapshot_mints"], "lost_mints": lost_mints,
                "seq_watermark_lost": watermark_lost,
                "acked_matches_double_counted": double_counted,
                "failures": [] if (lost_mints > 0 and watermark_lost
                                   and double_counted > 0) else
                ["journal-less restart did NOT lose league state?"],
            }
            print(_json.dumps(verdict))
            lost = not verdict["failures"]
            print("verdict: journal-less control plane forgot "
                  f"{lost_mints} minted snapshots, reset the seq watermark "
                  f"and double-counted {double_counted} acked matches "
                  "across a SIGKILL — the loss the journal exists to prevent"
                  if lost else "verdict: DRILL FAILED")
            return 0 if lost else 1

        # ----------------------------------------------- journaled drill
        jdir = os.path.join(args.dir, "journal")
        plane = spawn_plane(port, jdir)
        addr = f"127.0.0.1:{port}"
        remote = RemoteLeagueService(addr, timeout=10.0)

        survivors = {
            pid: spawn_learner(addr, pid, f"{pid}-learner",
                               rounds=args.rounds)
            for pid in players if pid != victim
        }
        vic = spawn_learner(addr, victim, f"{victim}-learner", rounds=100000)

        # -------------------------- SIGKILL the victim mid-league
        deadline = time.time() + args.timeout_s
        while time.time() < deadline:
            with vic["lock"]:
                if len(vic["seqs"]) >= 3:
                    break
            time.sleep(0.05)
        with vic["lock"]:
            vic_seqs, vic_snaps = list(vic["seqs"]), list(vic["snaps"])
            vic_matches = list(vic["matches"])
        if len(vic_seqs) < 3:
            failures.append("victim learner never reached 3 acked rounds")
        t_kill = time.time()
        inj.kill_role(vic["proc"].pid, sig=signal.SIGKILL,
                      name=f"league-learner-{victim}")
        vic["proc"].wait(timeout=30)
        # a dead actor's ask: dispatched, never reported -> must expire
        orphan_job = remote.ask_job(victim, learner_id="dead-actor")

        # ------------------------ freeze (not vanish) within one lease
        frozen_seen = None
        freeze_deadline = time.time() + lease_s * 3 + 5
        while time.time() < freeze_deadline:
            st = league_status(addr)
            if victim in st["frozen_players"]:
                frozen_seen = st
                break
            time.sleep(0.2)
        if frozen_seen is None:
            failures.append(f"{victim} never froze after the kill")
        else:
            if victim not in frozen_seen["active_players"]:
                failures.append(f"{victim} vanished from the active roster")
            missing = [s for s in vic_snaps
                       if s not in frozen_seen["historical_players"]]
            if missing:
                failures.append(f"killed learner's minted snapshots "
                                f"disappeared: {missing}")
        jobs_at_kill = sum((frozen_seen or st)["jobs_by_branch"].values())

        # ------------- supervised restart resumes the train-info lineage
        vic2 = spawn_learner(addr, victim, f"{victim}-learner",
                             rounds=max(3, args.rounds // 4))
        reg_deadline = time.time() + 30
        reg = None
        while time.time() < reg_deadline:
            with vic2["lock"]:
                reg = vic2["reg"]
            if reg is not None:
                break
            time.sleep(0.1)
        if reg is None or not reg.get("registered"):
            failures.append(f"restarted {victim} failed to register: {reg}")
        elif vic_seqs and int(reg.get("train_seq", -1)) < max(vic_seqs):
            failures.append(
                f"restart lost the seq watermark: register returned "
                f"train_seq={reg.get('train_seq')} < acked {max(vic_seqs)}")
        thaw_deadline = time.time() + lease_s + 10
        while time.time() < thaw_deadline:
            if victim not in league_status(addr)["frozen_players"]:
                break
            time.sleep(0.2)
        else:
            failures.append(f"{victim} stayed frozen after restart")

        for pid, col in {**survivors, victim: vic2}.items():
            if col["proc"].wait(timeout=args.timeout_s) != 0:
                failures.append(f"learner {pid} exited nonzero")
        st = league_status(addr)
        if sum(st["jobs_by_branch"].values()) <= jobs_at_kill:
            failures.append("survivors made no matchmaking progress "
                            "after the kill")

        # ------------- the abandoned assignment expires, map drains clean
        time.sleep(max(0.0, job_ttl_s - (time.time() - t_kill)) + 0.5)
        flush_job = remote.ask_job("MP0", learner_id="drill-flush")
        remote.report(flush_job["job_id"], [], learner_id="drill-flush")
        st1 = league_status(addr)
        if st1["assignments_pending"] != 0:
            failures.append(f"assignment map did not drain: "
                            f"{st1['assignments']}")
        if st1["orphaned_jobs"] < 1:
            failures.append("dead actor's assignment was never counted "
                            "as orphaned")
        if orphan_job and orphan_job["job_id"] in st1["assignments"]:
            failures.append("dead actor's assignment never expired")

        # -------------- cold journal replay: the league state is exact
        all_matches = list(vic_matches)
        for col in list(survivors.values()) + [vic2]:
            with col["lock"]:
                all_matches.extend(col["matches"])
        inj.kill_role(plane.pid, sig=signal.SIGKILL,
                      name="league-coordinator")
        plane.wait(timeout=30)
        spawn_plane(port, jdir)
        st2 = league_status(addr)
        for key in DIGEST_KEYS:
            if st1[key] != st2[key]:
                failures.append(f"cold journal replay diverged on {key}: "
                                f"{st1[key]} != {st2[key]}")
        resend = remote.report("RESEND", all_matches)
        if resend.get("applied", 1) != 0 \
                or resend.get("duplicates") != len(all_matches):
            failures.append(f"acked matches not exactly reconstructed by "
                            f"journal replay: {resend}")

        verdict = {
            "acked_matches": len(all_matches),
            "victim_acked_rounds": len(vic_seqs),
            "victim_minted_snapshots": len(vic_snaps),
            "restart_train_seq": reg and reg.get("train_seq"),
            "snapshot_mints": st2["snapshot_mints"],
            "jobs_by_branch": st2["jobs_by_branch"],
            "orphaned_jobs": st2["orphaned_jobs"],
            "events": [e["kind"] for e in inj.events],
            "failures": failures,
        }
        print(_json.dumps(verdict, default=str))
        print("verdict: learner SIGKILL'd mid-league; its player froze "
              "(still matchable), survivors kept training, the supervised "
              "restart resumed the lineage, the abandoned assignment "
              "expired cleanly, and a cold journal replay reconstructed "
              "the league exactly with zero lost / zero double-counted "
              "acked matches" if not failures
              else f"verdict: DRILL FAILED {failures}")
        return 0 if not failures else 1
    finally:
        for p_ in children:
            if p_.poll() is None:
                p_.kill()
        ha_mod.reset_targets()


def cmd_latest(args) -> int:
    mgr = CheckpointManager(args.dir)
    gens = mgr.generations()
    if not gens:
        print(f"no latest pointer under {args.dir}")
        return 1
    for i, gen in enumerate(gens):
        ok = verify_checkpoint(gen["path"])
        marker = "LATEST " if i == 0 else "       "
        print(f"{marker}step={gen.get('step', '?'):>8}  "
              f"{'ok     ' if ok else 'CORRUPT'}  {gen['path']}")
    resolved = mgr.resolve_latest()
    print(json.dumps({"resolves_to": resolved and resolved["path"]}))
    return 0 if resolved else 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("corrupt", help="damage a checkpoint in place")
    c.add_argument("--path", required=True)
    c.add_argument("--mode", choices=("truncate", "bitflip"), default="truncate")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--frac", type=float, default=0.5, help="truncate: fraction kept")
    c.add_argument("--flips", type=int, default=8, help="bitflip: bits to flip")

    k = sub.add_parser("kill", help="signal a role process")
    k.add_argument("--pid", type=int, required=True)
    k.add_argument("--signal", default="TERM", choices=("TERM", "KILL", "INT"))

    r = sub.add_parser("reset", help="RST-abort connections to an endpoint")
    r.add_argument("--addr", required=True, help="host:port")
    r.add_argument("--count", type=int, default=1)
    r.add_argument("--seed", type=int, default=0)

    l = sub.add_parser("latest", help="inspect a durable latest pointer")
    l.add_argument("--dir", required=True, help="checkpoint directory")

    d = sub.add_parser("replay-drill",
                       help="kill a replay store mid-run; prove spill recovery")
    d.add_argument("--dir", required=True, help="spill directory")
    d.add_argument("--items", type=int, default=50, help="acked inserts before the kill")
    d.add_argument("--shards", type=int, default=1,
                   help="N > 1: shard-loss variant — kill 1 of N "
                        "consistent-hash shards mid-run; the learner must "
                        "ride through on the rest, only the victim's "
                        "unsampled tail may go missing, and its restart "
                        "must spill-recover exactly that tail (--shards 1 "
                        "is the whole-store counter-demo)")
    d.add_argument("--no-spill", action="store_true",
                   help="counter-demo: run without durability and show the loss")
    d.add_argument("--seed", type=int, default=0)

    s = sub.add_parser("serve-drill",
                       help="kill 1 of N serve gateways under load; prove "
                            "router re-route + exact migration accounting")
    s.add_argument("--gateways", type=int, default=3)
    s.add_argument("--sessions", type=int, default=48)
    s.add_argument("--steps", type=int, default=8,
                   help="episode length per session (kill at the midpoint)")
    s.add_argument("--slots", type=int, default=64, help="slots per gateway")
    s.add_argument("--seed", type=int, default=0)

    h = sub.add_parser("shm-drill",
                       help="SIGKILL the shm-ring peer mid-frame; prove "
                            "typed detection + TCP fallback, zero acked loss")
    h.add_argument("--dir", required=True, help="spill directory")
    h.add_argument("--items", type=int, default=60,
                   help="acked inserts across the kill")
    h.add_argument("--ring-bytes", type=int, default=8192,
                   help="forced tiny ring so frames span it (mid-frame kills)")
    h.add_argument("--seed", type=int, default=0)

    e = sub.add_parser("elastic-drill",
                       help="load spike -> autoscaler scale-up observed "
                            "live -> graceful cooldown drain with exact "
                            "migration accounting -> SIGKILL mid-drain with "
                            "zero acked replay loss")
    e.add_argument("--dir", required=True, help="replay spill root")
    e.add_argument("--slots", type=int, default=8, help="slots per gateway")
    e.add_argument("--sessions", type=int, default=14,
                   help="resident sessions offered (pick > --slots so the "
                        "spike actually sheds)")
    e.add_argument("--items", type=int, default=60,
                   help="acked replay inserts across the drain/kill")
    e.add_argument("--seed", type=int, default=0)

    y = sub.add_parser("dynamics-drill",
                       help="poison one module's params with a NaN mid-run; "
                            "prove census localization, a single exemplar-"
                            "carrying alert, a black-box bundle, and a "
                            "deterministic stepreplay reproduction")
    y.add_argument("--dir", required=True, help="scratch experiment directory")
    y.add_argument("--module", default="",
                   help="top-level model submodule to poison (default: first "
                        "module, sorted)")
    y.add_argument("--pre-steps", type=int, default=3,
                   help="clean steps before the poison (EMA/census baseline)")
    y.add_argument("--post-steps", type=int, default=3,
                   help="clean steps after (debounce must hold at 1 bundle)")
    y.add_argument("--seed", type=int, default=0)
    y.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")

    a = sub.add_parser(
        "arena-drill",
        help="kill an arena evaluator mid-batch, restart it, prove zero "
             "lost / zero double-counted matches by idempotent keys")
    a.add_argument("--dir", required=True, help="scratch directory (journal "
                   "+ empty checkpoint dir live here)")
    a.add_argument("--batches", type=int, default=4,
                   help="total scenario batches the run must complete")
    a.add_argument("--episodes", type=int, default=6,
                   help="episodes per batch (matches per assignment)")
    a.add_argument("--kill-after", type=int, default=1,
                   help="SIGKILL the evaluator when this batch STARTS "
                        "(this many batches already reported)")
    a.add_argument("--kill-delay-s", type=float, default=0.2,
                   help="wait this long after BATCH_START before the kill")
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--timeout-s", type=float, default=900.0,
                   help="restarted evaluator wall budget")
    a.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")

    o = sub.add_parser(
        "coordinator-drill",
        help="SIGKILL the primary coordinator under live fleet load; prove "
             "warm-standby failover with zero acked-item loss, exact arena "
             "dedup, lease survival/eviction, epoch fencing of the revived "
             "primary, and an exact cold journal-replay restart")
    o.add_argument("--dir", required=True,
                   help="scratch directory (per-coordinator journals)")
    o.add_argument("--items", type=int, default=30,
                   help="acked payload registers before the kill")
    o.add_argument("--post-items", type=int, default=15,
                   help="further acked registers the fleet must land on the "
                        "standby after the kill")
    o.add_argument("--lease-s", type=float, default=8.0,
                   help="endpoint lease TTL; the failover must complete "
                        "within ONE lease window")
    o.add_argument("--grace-s", type=float, default=1.5,
                   help="standby takeover grace (quiet feed -> promotion)")
    o.add_argument("--no-ha", action="store_true",
                   help="counter-demo: journal-less coordinator provably "
                        "loses acked items across the same SIGKILL")
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--timeout-s", type=float, default=120.0,
                   help="load-phase wall budget")

    g = sub.add_parser(
        "league-drill",
        help="SIGKILL one league learner mid-league; prove the matchmaker "
             "freezes (not forgets) its player, survivors keep training, a "
             "supervised restart resumes the lineage, the abandoned "
             "assignment expires, and a cold journal replay reconstructs "
             "the league exactly")
    g.add_argument("--dir", required=True,
                   help="scratch directory (the control plane's HA journal)")
    g.add_argument("--rounds", type=int, default=40,
                   help="matchmade rounds each SURVIVOR learner completes "
                        "(the victim runs unbounded until the kill)")
    g.add_argument("--round-sleep-s", type=float, default=0.2,
                   help="per-round think time in the toy learner children")
    g.add_argument("--lease-s", type=float, default=2.0,
                   help="learner lease TTL; the victim's player must freeze "
                        "within ~one window of the kill")
    g.add_argument("--job-ttl-s", type=float, default=5.0,
                   help="assignment TTL; the dead actor's job must expire")
    g.add_argument("--no-journal", action="store_true",
                   help="counter-demo: a journal-less control plane "
                        "provably forgets the league across a SIGKILL")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--timeout-s", type=float, default=120.0,
                   help="per-phase wall budget")

    m = sub.add_parser("multichip-drill",
                       help="kill a multichip learner after a sharded save; "
                            "prove resume on a DIFFERENT mesh shape")
    m.add_argument("--dir", required=True, help="experiment scratch directory")
    m.add_argument("--mesh", default="dp=4,fsdp=2",
                   help="mesh the run is killed on")
    m.add_argument("--resume-mesh", default="dp=8",
                   help="mesh the run must finish on (resharding restore)")
    m.add_argument("--host-devices", type=int, default=8,
                   help="gloo ranks on the CPU (with --device cpu); 0 = one process on --device")
    m.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without CUDA unless 'cpu')")
    m.add_argument("--iters", type=int, default=5, help="target iterations")
    m.add_argument("--kill-after", type=int, default=2,
                   help="kill the learner after this iteration's sharded save")
    m.add_argument("--restart-max", type=int, default=3,
                   help="restart budget (RestartPolicy semantics)")
    m.add_argument("--timeout-s", type=float, default=900.0,
                   help="per-child wall budget")

    args = p.parse_args(argv)
    return {"corrupt": cmd_corrupt, "kill": cmd_kill,
            "reset": cmd_reset, "latest": cmd_latest,
            "replay-drill": cmd_replay_drill,
            "serve-drill": cmd_serve_drill,
            "shm-drill": cmd_shm_drill,
            "elastic-drill": cmd_elastic_drill,
            "dynamics-drill": cmd_dynamics_drill,
            "arena-drill": cmd_arena_drill,
            "coordinator-drill": cmd_coordinator_drill,
            "league-drill": cmd_league_drill,
            "multichip-drill": cmd_multichip_drill}[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
