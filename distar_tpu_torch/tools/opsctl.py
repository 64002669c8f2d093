"""opsctl: fleet-health CLI over the /healthz, /alerts, /timeseries routes.

Counterpart of the JAX package's ``tools/opsctl.py``, over the port's
``resilience.CommError``, ``obs/dynamics.py`` and ``obs/waterfall.py``.
Both answer the same against either package's servers: the routes are the
same. A bundle's replay line names the port's stepreplay.

Any process serving the obs health surfaces answers (coordinator broker,
serve HTTP frontend, or a training role started with --metrics-port):

  python -m distar_tpu_torch.tools.opsctl status       --addr 127.0.0.1:8423
  python -m distar_tpu_torch.tools.opsctl tail-alerts  --addr 127.0.0.1:8423 [--interval 2]
  python -m distar_tpu_torch.tools.opsctl query        --addr 127.0.0.1:8423 \\
        --name distar_learner_step_seconds_p50 [--window 300] [--source local]
  python -m distar_tpu_torch.tools.opsctl profile      --addr <learner-admin host:port> \\
        [--steps 2] [--timeout 600]
  python -m distar_tpu_torch.tools.opsctl trace        --addr 127.0.0.1:8423 \\
        [--name serve_request] [--min-ms 50] [--outcome shed] [--limit 20]
  python -m distar_tpu_torch.tools.opsctl trace        --addr 127.0.0.1:8423 --id <trace_id>
  python -m distar_tpu_torch.tools.opsctl dynamics     --dir exp/blackbox [--inspect <id>]

``status`` exits 0 when healthy, 1 when any rule is warning, 2 when firing —
scriptable for cron probes; it also prints a per-role step-time/MFU digest
from the ``distar_perf_*`` series when any are in the probed TSDB, and an
actor-throughput digest (env-steps/s, rollout-plane backend, plane sample
rates, serve shed rate) from the ``distar_actor_*``/``distar_rollout_*``/
``distar_serve_*`` series.
``tail-alerts`` follows the transition history (one line per
ok/warning/firing edge, deduped by event sequence). When the probed address
is a replay admin surface (``--type replay`` with ``--metrics-port``),
``status`` additionally prints per-table occupancy and rate-limiter state
from GET ``/replay/stats`` — and for a SHARD FLEET it aggregates: pass the
admin surfaces via ``--replay-addrs a:p,b:p,...`` or probe the coordinator,
whose ``replay_shard`` registrations are auto-discovered; the digest then
shows every shard's tables plus a fleet-aggregate line (total residency,
summed limiter block time, staleness span). Probing a coordinator also
prints the SERVING-FLEET digest: every ``serve_gateway`` registration's
gateway block (sessions/slots occupancy, shed rate, model generation +
served version, read off each gateway's own ``/serve/status``) plus an
aggregate line whose served-version spread says whether a fleet rollout has
converged. A coordinator hosting an ``Autoscaler`` (GET /autoscaler) adds
the AUTOSCALER digest: per-fleet target vs actual membership with
in-progress drains, per-policy value/threshold/hysteresis state, and the
last scaling decision with its reason. When a ``--distill`` learner ships
telemetry to the probed TSDB, ``status`` adds the DISTILLATION digest:
student vs teacher generation (and lag), the live divergence gauge (total
+ per head), the FLOPs-derived step-cost ratio, and the current canary
split state from the ``serve_canary`` record — student drift at a glance
without reading raw metrics. ``profile`` talks to a LEARNER ADMIN surface
(``rl_train --admin-port``): captures --steps iterations of torch.profiler
trace on the live learner and prints the ranked per-bucket attribution
table (obs/traceview.py).
``trace`` is the distributed-tracing consumer: without ``--id`` it lists
the retained traces (coordinator trace store + the probed process's own
tail-sampled buffer; filter by ``--name/--min-ms/--outcome`` — sheds and
errors are always retained by the tail sampler, so ``--outcome shed``
answers "show me a request we refused"); with ``--id`` it fetches one
trace's spans and renders the waterfall + ranked critical-path table
(obs/waterfall.py) — client/router/gateway spans joined under one
trace_id, with queue-wait vs service-time decomposition per process.
``league`` probes a coordinator hosting the league runtime
(``rl_train --type league-run``): learner leases, roster freeze state,
jobs dispatched per matchmaking branch, outstanding assignments, snapshot
mints and elastic reassignments (GET /league/status, docs/league.md).
``arena`` prints the ladder the matchmaker feeds on.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request

from ..resilience import CommError


def _fetch(url: str, timeout: float) -> dict:
    """One probe; transport faults surface as the typed ``CommError`` (the
    same taxonomy every fleet call site speaks), never a raw URLError."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError:
        raise  # status codes are handled by the caller (503 carries a body)
    except (urllib.error.URLError, ConnectionError, TimeoutError, OSError,
            ValueError) as e:
        raise CommError(f"GET {url} failed: {e!r}", op="opsctl:get", cause=e) from e


def _get(addr: str, path: str, timeout: float = 10.0) -> dict:
    url = f"http://{addr}{path}"
    try:
        return _fetch(url, timeout)
    except urllib.error.HTTPError as e:
        # /healthz answers 503 while firing — that body is still the payload
        try:
            return json.loads(e.read())
        except Exception:
            raise SystemExit(f"GET {url} -> HTTP {e.code}")
    except CommError as e:
        raise SystemExit(str(e))


def _fmt_ts(ts) -> str:
    try:
        return time.strftime("%H:%M:%S", time.localtime(float(ts)))
    except (TypeError, ValueError):
        return "--:--:--"


def _try_get(addr: str, path: str, timeout: float = 5.0):
    """Optional-surface probe: None when the route isn't served here (404)
    or the peer is unreachable — never exits."""
    try:
        return _fetch(f"http://{addr}{path}", timeout)
    except (urllib.error.HTTPError, CommError, ValueError):
        return None


def _discover_replay_admins(addr: str, timeout: float = 5.0) -> list:
    """Shard-fleet discovery for ``status``: when the probed address is a
    coordinator, its ``replay_shard`` registrations (POST /coordinator/peers)
    name every live shard and the admin port each put in its meta. Returns
    admin addresses; [] when the address isn't a coordinator (or no shard
    registered) — never exits."""
    try:
        req = urllib.request.Request(
            f"http://{addr}/coordinator/peers",
            data=json.dumps({"token": "replay_shard"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read())
    except (urllib.error.URLError, ConnectionError, TimeoutError, OSError,
            ValueError):
        return []
    admins = []
    for rec in (body.get("info") or []):
        admin_port = (rec.get("meta") or {}).get("admin_port")
        if admin_port:
            admins.append(f"{rec['ip']}:{admin_port}")
    return sorted(set(admins))


def _try_post(addr: str, path: str, body: dict, timeout: float = 5.0):
    """Optional POST probe (serve frontends answer /serve/status on POST):
    None on unreachable/unserved — never exits."""
    try:
        req = urllib.request.Request(
            f"http://{addr}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, ConnectionError, TimeoutError, OSError,
            ValueError):
        return None


def _discover_serve_gateways(addr: str) -> list:
    """Serving-fleet discovery for ``status``: when the probed address is a
    coordinator, its ``serve_gateway`` registrations name every live
    gateway plus the HTTP port each advertised. Returns
    ``[(tcp_addr, http_addr, meta)]``; [] when the address isn't a
    coordinator or no gateway registered — never exits."""
    body = _try_post(addr, "/coordinator/peers", {"token": "serve_gateway"})
    seen = {}
    for rec in ((body or {}).get("info") or []):
        meta = rec.get("meta") or {}
        tcp_addr = f"{rec['ip']}:{rec['port']}"
        http_port = meta.get("http_port")
        http_addr = f"{rec['ip']}:{http_port}" if http_port else None
        seen[tcp_addr] = (tcp_addr, http_addr, meta)
    return [seen[k] for k in sorted(seen)]


def _print_serve_fleet(gateways: list) -> None:
    """Serving-fleet digest for ``status``: one block per discovered
    gateway (sessions/occupancy, shed rate, model generation + served
    version — read off its own /serve/status) and a fleet aggregate line
    (total sessions/slots, weighted shed rate, the served-version spread that
    says whether a rollout has converged)."""
    if not gateways:
        return
    print("serving fleet:")
    agg = {"sessions": 0, "slots": 0, "shed_num": 0.0, "shed_den": 0.0,
           "versions": set(), "unreachable": 0}
    for tcp_addr, http_addr, meta in gateways:
        players = ",".join(meta.get("players") or []) or "-"
        st = _try_post(http_addr, "/serve/status", {}) if http_addr else None
        info = (st or {}).get("info") if isinstance(st, dict) else None
        if not info or (st or {}).get("code") != 0:
            agg["unreachable"] += 1
            print(f"  [{tcp_addr}] players={players} UNREACHABLE "
                  f"(http={http_addr})")
            continue
        sess = info.get("sessions") or {}
        active = sess.get("active", 0)
        slots = sess.get("num_slots", 0)
        occ = active / slots if slots else 0.0
        reqs = info.get("requests") or {}
        total = sum(reqs.values())
        gen = info.get("generation", (info.get("registry") or {}).get("generation"))
        # convergence is about the VERSION each gateway is on — generation
        # numbers are per-gateway monotonic counters (a canaried gateway
        # legitimately runs one ahead after promote)
        version = (info.get("registry") or {}).get("current") \
            or info.get("served_version")
        # per-connection transport split (shm rings vs framed TCP): which
        # leg each colocated client actually negotiated on this gateway
        tr = info.get("transports") or {}
        tr_s = f" transports=shm:{tr.get('shm', 0)}/tcp:{tr.get('tcp', 0)}" \
            if tr else ""
        print(f"  [{tcp_addr}] players={players} sessions={active}/{slots} "
              f"occ={occ:5.2f} shed_rate={info.get('shed_rate', 0.0):.4f} "
              f"gen={gen} serving={version} "
              f"q={info.get('queue_depth', 0)}{tr_s}"
              + (" DRAINING" if info.get("draining") else ""))
        agg["sessions"] += active
        agg["slots"] += slots
        agg["shed_num"] += reqs.get("shed", 0.0)
        agg["shed_den"] += total
        agg["versions"].add(version)
    occ = agg["sessions"] / agg["slots"] if agg["slots"] else 0.0
    shed = agg["shed_num"] / agg["shed_den"] if agg["shed_den"] else 0.0
    versions = sorted(str(v) for v in agg["versions"])
    converged = "converged" if len(versions) <= 1 else f"SPLIT {versions}"
    print(f"  aggregate: {len(gateways)} gateways  "
          f"{agg['sessions']}/{agg['slots']} sessions (occ={occ:.2f})  "
          f"shed_rate={shed:.4f}  versions={converged}"
          + (f"  unreachable={agg['unreachable']}" if agg["unreachable"] else ""))


def _print_replay(per_shard: dict) -> None:
    """Replay digest for ``status``, fleet-aware: one block per shard
    (occupancy + rate-limiter state per table — the numbers that say which
    side of the fleet is behind and WHICH shard), then the fleet aggregate
    (total residency, summed limiter block time, staleness span). A
    single-store probe is just a one-shard fleet."""
    per_shard = {k: v for k, v in per_shard.items() if v}
    if not per_shard:
        return
    fleet = len(per_shard) > 1
    agg = {"size": 0, "max": 0, "ins": 0, "smp": 0,
           "block_ins": 0.0, "block_smp": 0.0,
           "stale_min": None, "stale_max": None, "spill_live": 0}
    print("replay fleet:" if fleet else "replay tables:")
    for shard_addr in sorted(per_shard):
        stats = per_shard[shard_addr]
        tag = f"[{stats.get('shard') or shard_addr}] " if fleet else ""
        if "error" in stats:
            print(f"  {tag}UNREACHABLE: {stats['error']}")
            continue
        for name in sorted(stats.get("tables", {})):
            t = stats["tables"][name]
            lim = t.get("limiter", {})
            spi = lim.get("samples_per_insert")
            blocked = ("insert" if not lim.get("can_insert", True) else
                       "sample" if not lim.get("can_sample", True) else "-")
            print(f"  {tag}{name:<16} {t.get('size', 0):>6}/{t.get('max_size', 0):<6} "
                  f"occ={t.get('occupancy', 0.0):5.2f}  sampler={t.get('sampler', '?'):<11} "
                  f"spi={spi if spi is not None else 'off':<5} "
                  f"ins={lim.get('inserts', 0)} smp={lim.get('samples', 0)} "
                  f"blocked={blocked} "
                  f"block_s=ins:{lim.get('block_insert_s', 0.0)}/smp:{lim.get('block_sample_s', 0.0)}")
            agg["size"] += t.get("size", 0)
            agg["max"] += t.get("max_size", 0)
            agg["ins"] += lim.get("inserts", 0)
            agg["smp"] += lim.get("samples", 0)
            agg["block_ins"] += lim.get("block_insert_s", 0.0)
            agg["block_smp"] += lim.get("block_sample_s", 0.0)
            for key, side in (("newest_item_s", "stale_min"),
                              ("oldest_item_s", "stale_max")):
                v = t.get(key)
                if v is not None:
                    cur = agg[side]
                    pick = min if side == "stale_min" else max
                    agg[side] = v if cur is None else pick(cur, v)
        spill = stats.get("spill")
        if spill:
            agg["spill_live"] += spill.get("live", 0) or 0
            print(f"  {tag}spill: {spill.get('live')}/{spill.get('max_items')} live "
                  f"({spill.get('root')})")
        tr = stats.get("transports")
        if tr:
            # the active transport per data-plane connection: colocated
            # clients negotiate shm rings, remote ones stay framed TCP
            print(f"  {tag}transports: shm:{tr.get('shm', 0)} "
                  f"tcp:{tr.get('tcp', 0)}")
    if fleet:
        occ = agg["size"] / agg["max"] if agg["max"] else 0.0
        stale = (f"staleness={agg['stale_min']}..{agg['stale_max']}s "
                 if agg["stale_min"] is not None else "")
        print(f"  aggregate: {len(per_shard)} shards  {agg['size']}/{agg['max']} "
              f"items (occ={occ:.2f})  ins={agg['ins']} smp={agg['smp']}  "
              f"block_s=ins:{round(agg['block_ins'], 3)}/smp:{round(agg['block_smp'], 3)}  "
              f"{stale}spill_live={agg['spill_live']}")


def _print_autoscaler(addr: str) -> None:
    """Autoscaler digest for ``status``: per-fleet target-vs-actual
    membership + in-progress drains, per-policy state (current value vs
    thresholds and hysteresis streaks), and the last scaling decision with
    its reason — read off the coordinator's GET /autoscaler route (absent
    when no autoscaler runs there)."""
    body = _try_get(addr, "/autoscaler")
    if not body:
        return
    print("autoscaler:")
    for fleet in sorted(body.get("fleets") or {}):
        f = body["fleets"][fleet]
        drains = ",".join(f.get("draining") or []) or "-"
        cd = f.get("cooldown_remaining_s", 0.0)
        print(f"  [{fleet}] actual={f.get('actual')} "
              f"bounds={f.get('min')}..{f.get('max')} draining={drains} "
              f"cooldown={cd}s"
              + ("  GAVE-UP (respawn budget exhausted)" if f.get("gave_up")
                 else ""))
    for name in sorted(body.get("policies") or {}):
        p = body["policies"][name]
        value = p.get("value")
        value_s = f"{value:.4g}" if isinstance(value, (int, float)) else "no-data"
        bounds = []
        if p.get("up_when") is not None:
            bounds.append(f"up>{p['up_when']:g}")
        if p.get("down_when") is not None:
            bounds.append(f"down<{p['down_when']:g}")
        print(f"  policy {name:<24} fleet={p.get('fleet'):<8} "
              f"value={value_s:<10} {' '.join(bounds):<20} "
              f"streaks={p.get('up_streak')}/{p.get('down_streak')} "
              f"(need {p.get('for_count')})")
    last = body.get("last_decision")
    if last:
        print(f"  last decision: scale_{last.get('direction')} "
              f"{last.get('fleet')} {last.get('from')}->{last.get('to')} "
              f"at {_fmt_ts(last.get('ts'))}  ({last.get('reason')})")


# the per-role perf series worth a one-line digest (flattened TSDB keys;
# token = learner class name, sources = fleet processes)
_PERF_DIGEST_NAMES = tuple(
    f"{name}{{token={token}}}"
    for name in ("distar_perf_step_seconds", "distar_perf_frames_per_s",
                 "distar_perf_mfu", "distar_perf_implied_tflops")
    for token in ("rllearner", "sllearner")
)


def _print_distill_digest(addr: str) -> None:
    """Distillation digest for ``status``: student vs teacher generation,
    the live divergence gauge (total + per head), the step-cost ratio when
    a learner published one, and the canary split state — everything an
    operator needs to see student drift without reading raw metrics. All
    from the probed TSDB (shipped by any ``--distill`` learner) plus the
    coordinator's ``serve_canary`` record; silent when no distill learner
    ever shipped."""
    def last_of(name, window=600):
        body = _try_get(addr,
                        f"/timeseries?name={urllib.parse.quote(name)}"
                        f"&window_s={window}")
        best = None
        for source, st in ((body or {}).get("stats") or {}).items():
            if st and st.get("last") is not None:
                ts = st.get("last_ts", 0.0)
                if best is None or ts > best[0]:
                    best = (ts, source, st["last"])
        return best  # (ts, source, value) or None

    kl = last_of("distar_distill_kl")
    if kl is None:
        return
    print("distillation:")
    student = last_of("distar_distill_student_generation")
    teacher = last_of("distar_distill_teacher_generation")
    s_gen = int(student[2]) if student else "-"
    t_gen = int(teacher[2]) if teacher else "-"
    lag = (f" (lag {int(teacher[2]) - int(student[2])})"
           if student and teacher else "")
    print(f"  [{kl[1]}] student_gen={s_gen} teacher_gen={t_gen}{lag}  "
          f"divergence={kl[2]:.6g}")
    heads = []
    for head in ("action_type", "delay", "queued", "selected_units",
                 "target_unit", "target_location"):
        row = last_of(f"distar_distill_head_kl{{head={head}}}")
        if row:
            heads.append(f"{head}={row[2]:.4g}")
    if heads:
        print(f"  per-head KL: {' '.join(heads)}")
    ratio = last_of("distar_distill_step_cost_ratio")
    if ratio:
        print(f"  step-cost ratio: {ratio[2]:.4g}x teacher (FLOPs-derived)")
    canary = _try_post(addr, "/coordinator/peers", {"token": "serve_canary"})
    recs = (canary or {}).get("info") or []
    if recs:
        latest = max(recs, key=lambda r: r.get("ts", 0.0))
        meta = latest.get("meta") or {}
        if meta.get("pct"):
            print(f"  canary split: {meta.get('pct')}% -> "
                  f"{','.join(meta.get('addrs') or [])} "
                  f"(version {meta.get('version') or '?'})")
        else:
            print("  canary split: none (pct=0)")


def _print_arena_digest(addr: str) -> None:
    """Arena digest for ``status``: match accounting + the current top of
    the ladder — read off the coordinator's GET /arena/ratings route
    (absent when no arena store is hosted there)."""
    body = _try_get(addr, "/arena/ratings")
    if not body:
        return
    players = body.get("players") or {}
    top = max(players.items(), key=lambda kv: kv[1].get("elo", 0.0))[0] \
        if players else "-"
    print(f"arena: {body.get('matches_total', 0)} matches "
          f"({body.get('duplicates_total', 0)} deduped) "
          f"players={len(players)} top={top}")


def _print_coordinator_ha_digest(addr: str) -> None:
    """Coordinator HA digest for ``status``: leadership role, fencing epoch
    and journal position per coordinator, plus the standby's replication lag
    (records + seconds behind the primary) with a freshness warning when the
    standby has drifted far enough that a failover would replay stale state.
    ``addr`` may be a comma list (the same spec clients pass as
    ``--coordinator-addr``); a single probed coordinator also reveals its
    peers, which are folded in. Silent when nothing at ``addr`` speaks HA
    (GET /coordinator/ha is 404 on a journal-less coordinator)."""
    probed = {}
    pending = [a.strip() for a in addr.split(",") if a.strip()]
    while pending:
        a = pending.pop(0)
        if a in probed:
            continue
        body = _try_get(a, "/coordinator/ha", timeout=3.0)
        probed[a] = body
        for peer in (body or {}).get("peers") or []:
            if peer not in probed:
                pending.append(peer)
    rows = {a: b for a, b in probed.items() if b}
    if not rows:
        return
    print("coordinator HA:")
    for a in sorted(rows):
        b = rows[a]
        role = b.get("role", "?")
        line = (f"  {a:<24} role={role:<8} epoch={b.get('epoch', 0)} "
                f"seq={b.get('seq', 0)}")
        if role == "standby":
            lag_r = int(b.get("journal_lag_records", 0))
            lag_s = float(b.get("journal_lag_seconds", 0.0))
            line += f" lag={lag_r} records / {lag_s:.1f}s behind"
            if lag_r > 256 or lag_s > 30.0:
                line += "  STALE STANDBY (failover would lose recent state)"
        print(line)
    roles = [b.get("role") for b in rows.values()]
    if "primary" not in roles:
        print("  WARNING: no primary answering (fleet is between leaders)")
    elif roles.count("primary") > 1:
        print("  WARNING: multiple primaries answering (epoch fencing will "
              "demote the loser; check again shortly)")
    elif "standby" not in roles and len(rows) == 1:
        n = int(next(iter(rows.values())).get("followers", 0))
        if n:
            print(f"  note: {n} follower(s) tailing the journal feed "
                  "(probe the comma list for their lag)")
        else:
            print("  note: single HA coordinator probed, no standby attached "
                  "(a failover here would wait on a cold journal replay)")


def cmd_arena(args) -> int:
    """The arena scoreboard: rating ladder, payoff matrix with Wilson
    intervals, PFSP preview weights, and rating-over-time trajectories from
    the shipped ``distar_arena_*`` TSDB series."""
    ratings = _get(args.addr, "/arena/ratings")
    payoff = _get(args.addr, "/arena/payoff")
    if args.json:
        print(json.dumps({"ratings": ratings, "payoff": payoff}, indent=1))
        return 0
    players = ratings.get("players") or {}
    print(f"arena scoreboard  ({ratings.get('matches_total', 0)} matches, "
          f"{ratings.get('duplicates_total', 0)} duplicates deduped)")
    print(f"  {'player':<24} {'elo':>8} {'trueskill':>10} {'games':>6}")
    ordered = sorted(players.items(), key=lambda kv: -kv[1].get("elo", 0.0))
    for pid, row in ordered:
        tag = "  (anchor)" if row.get("anchor") else ""
        print(f"  {pid:<24} {row.get('elo', 0.0):>8.1f} "
              f"{row.get('trueskill_exposed', 0.0):>10.2f} "
              f"{row.get('games', 0):>6}{tag}")
    cells = payoff.get("cells") or []
    if cells:
        print("payoff matrix (a-perspective, draws count half):")
        for c in cells:
            if not c.get("games"):
                continue
            print(f"  {c['a']:<20} vs {c['b']:<20} "
                  f"wr={c['win_rate']:.3f} "
                  f"ci=[{c['wilson_low']:.3f},{c['wilson_high']:.3f}] "
                  f"n={c['games']}")
    preview = payoff.get("pfsp_preview") or {}
    if preview:
        print(f"pfsp preview ({payoff.get('pfsp_weighting', 'variance')} "
              f"weighting):")
        for pid in sorted(preview):
            row = " ".join(f"{o}={w:.3f}"
                           for o, w in sorted(preview[pid].items()))
            print(f"  {pid:<24} {row}")
    # rating-over-time from the shipped TSDB series: the coordinator's
    # registry sampler turns every distar_arena_rating_elo gauge into a
    # series per player — the learning-curve view of the ladder
    shown = False
    for pid, _ in ordered:
        name = urllib.parse.quote(f"distar_arena_rating_elo{{player={pid}}}")
        body = _try_get(args.addr,
                        f"/timeseries?name={name}&window_s={args.window}")
        for source, pts in ((body or {}).get("points") or {}).items():
            if not pts:
                continue
            if not shown:
                print("rating trajectories (TSDB):")
                shown = True
            first, last = pts[0][1], pts[-1][1]
            print(f"  {pid:<24} [{source}] {len(pts)} pts  "
                  f"{first:.1f} -> {last:.1f}  "
                  f"({'+' if last >= first else ''}{last - first:.1f})")
    return 0


def cmd_league(args) -> int:
    """The self-play economy digest: roster (active/frozen/historical),
    learner leases, jobs dispatched per matchmaking branch, outstanding
    assignments, snapshot mints and elastic reassignments — the
    ``GET /league/status`` surface of the coordinator-hosted
    ``LeagueService`` (docs/league.md)."""
    st = _get(args.addr, "/league/status")
    if args.json:
        print(json.dumps(st, indent=1))
        return 0
    print(f"league  ({st.get('active_learners', 0)}/"
          f"{st.get('registered_learners', 0)} learners fresh, "
          f"lease={st.get('lease_s', 0):.0f}s "
          f"job_ttl={st.get('job_ttl_s', 0):.0f}s)")
    frozen = set(st.get("frozen_players") or [])
    learners_by_player = {}
    for lid, e in (st.get("learners") or {}).items():
        learners_by_player.setdefault(e.get("player_id", "?"), []).append(
            (lid, e))
    print(f"  {'player':<12} {'state':<8} learners")
    for pid in st.get("active_players") or []:
        rows = learners_by_player.get(pid, [])
        detail = ", ".join(
            f"{lid}(fresh)" if e.get("fresh")
            else f"{lid}(stale {e.get('age_s', 0.0):.0f}s)"
            for lid, e in sorted(rows)) or "-"
        state = "FROZEN" if pid in frozen else "active"
        print(f"  {pid:<12} {state:<8} {detail}")
    hist = st.get("historical_players") or []
    print(f"historical players: {len(hist)}"
          + (f"  ({', '.join(hist[:8])}{', ...' if len(hist) > 8 else ''})"
             if hist else ""))
    jobs = st.get("jobs_by_branch") or {}
    total = sum(jobs.values())
    dist = "  ".join(f"{b}={jobs.get(b, 0)}"
                     for b in ("sp", "pfsp", "vs_main", "eval"))
    print(f"jobs dispatched: {total}  ({dist})")
    pending = st.get("assignments") or {}
    print(f"assignments pending: {len(pending)}"
          f"  orphaned(ttl-expired): {st.get('orphaned_jobs', 0)}")
    for jid, a in sorted(pending.items()):
        print(f"  {jid:<8} {a.get('branch', '?'):<8} "
              f"{' vs '.join(a.get('player_ids') or [])}  "
              f"learner={a.get('learner_id') or '?'}")
    print(f"snapshot mints: {st.get('snapshot_mints', 0)}"
          f"  reassignments: {st.get('reassignments', 0)}")
    return 0


def _print_actor_digest(addr: str) -> None:
    """Actor-throughput digest from the probed TSDB: env-steps/s, the
    rollout-plane backend serving the fleet, plane sample rates per
    backend, and the serve-plane shed rate — the four numbers that say
    whether the rollout plane is keeping the fleet fed (docs/serving.md)."""
    rows = []
    body = _try_get(addr, "/timeseries?name=distar_actor_env_step_rate&window_s=600")
    for source, st in ((body or {}).get("stats") or {}).items():
        if st and st.get("last") is not None:
            rows.append((source, "env_steps_per_s", f"{st['last']:.6g}"))
    backends = []
    for backend in ("inline", "local", "remote", "anakin"):
        name = urllib.parse.quote(
            f"distar_rollout_plane_backend{{backend={backend}}}")
        body = _try_get(addr, f"/timeseries?name={name}&window_s=600")
        for source, st in ((body or {}).get("stats") or {}).items():
            if st and st.get("last") == 1.0:
                backends.append((source, backend))
        name = urllib.parse.quote(
            f"distar_rollout_samples_total{{backend={backend}}}")
        body = _try_get(addr, f"/timeseries?name={name}&window_s=600")
        for source, st in ((body or {}).get("stats") or {}).items():
            if st and st.get("rate"):
                rows.append((source, f"plane_samples_per_s[{backend}]",
                             f"{st['rate']:.6g}"))
    # the fused-rollout tier has no plane samples: its feed-rate signal is
    # the per-window env-steps/s gauge
    body = _try_get(addr, "/timeseries?name=distar_anakin_env_steps_per_s&window_s=600")
    for source, st in ((body or {}).get("stats") or {}).items():
        if st and st.get("last") is not None:
            rows.append((source, "anakin_env_steps_per_s",
                         f"{st['last']:.6g}"))
    shed = 0.0
    for reason in ("shed_queue_full", "shed_deadline", "shed_capacity", "draining"):
        name = urllib.parse.quote(f"distar_serve_shed_total{{reason={reason}}}")
        body = _try_get(addr, f"/timeseries?name={name}&window_s=600")
        for _source, st in ((body or {}).get("stats") or {}).items():
            shed += st.get("rate") or 0.0
    if not rows and not backends:
        return
    print("actor:")
    for source, backend in sorted(backends):
        print(f"  {source:<24} plane_backend={backend}")
    for source, name, value in sorted(rows):
        print(f"  {source:<24} {name:<28} {value}")
    if shed:
        print(f"  serve shed rate: {shed:.4g}/s")


def _print_perf_digest(addr: str) -> None:
    """Per-role step-time/MFU digest from the probed TSDB: one line per
    (series, source) with the last value — the 10-second answer to "how
    fast is each learner stepping and at what MFU"."""
    rows = []
    for name in _PERF_DIGEST_NAMES:
        body = _try_get(addr, f"/timeseries?name={urllib.parse.quote(name)}&window_s=600")
        if not body or not body.get("points"):
            continue
        for source, st in (body.get("stats") or {}).items():
            if st and st.get("last") is not None:
                rows.append((source, name, st["last"], st.get("mean")))
    if not rows:
        return
    print("perf:")
    for source, name, last, mean in sorted(rows):
        short = name.replace("distar_perf_", "")
        mean_s = f"{mean:.6g}" if isinstance(mean, (int, float)) else "—"
        print(f"  {source:<24} {short:<40} last={last:<12.6g} mean={mean_s}")


_DYN_HEADS = ("action_type", "delay", "queued", "selected_units",
              "target_unit", "target_location")


def _print_dynamics_digest(addr: str) -> None:
    """Training-dynamics digest for ``status``: per-learner total grad
    norm / EMA, update-to-weight ratio, clip fraction, the top-3 loss
    heads by magnitude, and the last anomaly (step + bundle count) — the
    10-second answer to "are the gradients healthy and what dominates the
    loss". All from the probed TSDB (shipped by any learner running the
    dynamics monitor); silent when no learner ever shipped the tree."""
    def stats_of(name, window=600):
        body = _try_get(addr,
                        f"/timeseries?name={urllib.parse.quote(name)}"
                        f"&window_s={window}")
        out = {}
        for source, st in ((body or {}).get("stats") or {}).items():
            if st and st.get("last") is not None:
                out[source] = st["last"]
        return out  # {source: last}

    grad = stats_of("distar_train_grad_norm{module=total}")
    if not grad:
        return
    ema = stats_of("distar_train_grad_norm_ema")
    ratio = stats_of("distar_train_update_ratio{module=total}")
    clip = stats_of("distar_train_grad_clip_fraction")
    print("training dynamics:")
    for source in sorted(grad):
        parts = [f"grad_norm={grad[source]:.6g}"]
        if source in ema:
            parts.append(f"ema={ema[source]:.6g}")
        if source in ratio:
            parts.append(f"update_ratio={ratio[source]:.4g}")
        if source in clip:
            parts.append(f"clip_fraction={clip[source]:.4g}")
        print(f"  {source:<24} {'  '.join(parts)}")
    # top-3 loss heads by |last| across the bounded term x head grid
    heads = []
    for term in ("sl", "pg", "upgo", "entropy", "kl", "dapo"):
        for head in _DYN_HEADS:
            rows = stats_of(
                f"distar_train_loss_head{{head={head},term={term}}}")
            if not rows:
                rows = stats_of(
                    f"distar_train_loss_head{{term={term},head={head}}}")
            for _source, last in rows.items():
                heads.append((abs(last), f"{term}/{head}", last))
    if heads:
        top = sorted(heads, reverse=True)[:3]
        print("  top loss heads: "
              + "  ".join(f"{name}={last:.6g}" for _m, name, last in top))
    anomaly = stats_of("distar_train_last_anomaly_step")
    bundles = stats_of("distar_train_blackbox_bundles_total")
    for source in sorted(anomaly):
        n = bundles.get(source)
        extra = f" ({int(n)} black-box bundle(s) — opsctl dynamics)" \
            if n else ""
        print(f"  {source:<24} last_anomaly_step={int(anomaly[source])}{extra}")


def cmd_dynamics(args) -> int:
    """Black-box bundle browser (local filesystem — bundles are forensic
    artifacts, not telemetry): list a directory's bundles, or inspect one
    (summary, provenance, the worst diagnostics) and print the stepreplay
    invocation that reproduces it."""
    from ..obs.dynamics import bundle_summary, list_bundles, load_bundle

    dirpath = args.dir
    if os.path.isdir(os.path.join(dirpath, "blackbox")):
        dirpath = os.path.join(dirpath, "blackbox")  # experiment root given
    bundles = list_bundles(dirpath)
    if args.inspect:
        match = [b for b in bundles if args.inspect in b["id"]]
        if not match:
            print(f"no bundle matching {args.inspect!r} under {dirpath}")
            return 1
        bundle = load_bundle(match[0]["path"])
        if args.json:
            print(json.dumps(bundle_summary(bundle), indent=1, default=str))
        else:
            for k, v in bundle_summary(bundle).items():
                print(f"  {k}: {v}")
            diag = bundle.get("diagnostics") or {}
            worst = sorted(
                ((v, k) for k, v in diag.items()
                 if k.startswith("dyn/nonfinite_") and not k.endswith("/total")
                 and v and v == v),
                reverse=True)[:5]
            if worst:
                print("  non-finite census: "
                      + "  ".join(f"{k}={int(v)}" for v, k in worst))
            print(f"  replay: python -m distar_tpu_torch.tools.stepreplay --bundle "
                  f"{match[0]['path']}")
        return 0
    if not bundles:
        print(f"no black-box bundles under {dirpath}")
        return 1
    if args.json:
        print(json.dumps(bundles, indent=1))
        return 0
    for b in bundles:
        print(f"  {b['id']}  step={b['step']}  reason={b['reason']}")
    return 0


def cmd_status(args) -> int:
    body = _get(args.addr, "/healthz")
    status = body.get("status", "unknown")
    print(f"status: {status}   (started={body.get('started')})")
    rules = body.get("rules", {})
    if rules:
        width = max(len(n) for n in rules)
        for name in sorted(rules):
            print(f"  {name:<{width}}  {rules[name]}")
    sources = body.get("sources", {})
    if sources:
        print("sources:")
        for name in sorted(sources):
            s = sources[name]
            stale = "  STALE" if s.get("stale") else ""
            print(f"  {name:<24} age={s.get('age_s', 0):7.1f}s "
                  f"series={s.get('series', 0)}{stale}")
    tsdb = body.get("tsdb", {})
    if tsdb:
        print(f"tsdb: {tsdb.get('series')} series "
              f"(cap {tsdb.get('max_series')} x {tsdb.get('points_per_series')} pts, "
              f"{tsdb.get('dropped_series')} dropped)")
    # replay digest: explicit --replay-addrs fleet, else shards discovered
    # from a probed coordinator's replay_shard registrations, else the
    # probed address itself (a single replay admin surface)
    admin_addrs = ([a.strip() for a in args.replay_addrs.split(",") if a.strip()]
                   if args.replay_addrs else _discover_replay_admins(args.addr))
    if admin_addrs:
        per_shard = {}
        for admin in admin_addrs:
            stats = _try_get(admin, "/replay/stats")
            per_shard[admin] = stats if stats else {"error": "unreachable"}
        _print_replay(per_shard)
    else:
        replay = _try_get(args.addr, "/replay/stats")
        if replay:
            _print_replay({args.addr: replay})
    # serving-fleet digest: gateways auto-discovered from a probed
    # coordinator's serve_gateway registrations (each block read off the
    # gateway's own /serve/status)
    _print_serve_fleet(_discover_serve_gateways(args.addr))
    # elastic-control-plane digest (present when the probed coordinator
    # hosts an autoscaler): policy state, target vs actual, live drains
    _print_autoscaler(args.addr)
    # distillation-tier digest (present when a --distill learner ships
    # telemetry here): student/teacher generation drift, live divergence,
    # canary split state
    _print_distill_digest(args.addr)
    # training-dynamics digest (present when a learner ships the dynamics
    # tree): per-learner grad norm / update ratio / clip fraction, top
    # loss heads, last anomaly + bundle count
    _print_dynamics_digest(args.addr)
    # coordinator-HA digest (present when the probed coordinator journals):
    # role/epoch/journal position per coordinator, standby replication lag
    _print_coordinator_ha_digest(args.addr)
    # skill-ledger digest (present when the probed coordinator hosts the
    # arena store): match accounting + the ladder's current top
    _print_arena_digest(args.addr)
    _print_perf_digest(args.addr)
    _print_actor_digest(args.addr)
    return {"ok": 0, "warning": 1}.get(status, 2)


def _print_event(e: dict) -> None:
    print(f"{_fmt_ts(e.get('ts'))}  {e.get('state', '?'):<8} {e.get('rule', '?')}  "
          f"value={e.get('value')}  series={e.get('series')}  "
          f"[{e.get('severity', '')}] {e.get('summary', '')}")


def cmd_tail_alerts(args) -> int:
    seen = -1
    try:
        while True:
            body = _get(args.addr, "/alerts")
            history = body.get("history", [])
            # the evaluator doesn't stamp seq; dedupe on (ts, rule, state)
            fresh = [e for i, e in enumerate(history) if i > seen or args.once]
            if seen < 0 and not args.once:
                # first poll: show current context, then follow
                for e in history[-10:]:
                    _print_event(e)
            else:
                for e in fresh:
                    _print_event(e)
            seen = len(history) - 1
            firing = body.get("firing", [])
            if args.once:
                if firing:
                    print(f"firing: {', '.join(firing)}")
                return 2 if firing else 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_query(args) -> int:
    path = f"/timeseries?name={urllib.parse.quote(args.name)}&window_s={args.window}"
    if args.source:
        path += f"&source={urllib.parse.quote(args.source)}"
    body = _get(args.addr, path)
    stats = body.get("stats") or {}
    points = body.get("points") or {}
    if not points:
        print(f"no data for {args.name!r} in the last {args.window}s")
        return 1
    if args.json:
        print(json.dumps(body, indent=1))
        return 0
    for source in sorted(points):
        st = stats.get(source) or {}
        print(f"{args.name} @ {source}: n={st.get('count')} last={st.get('last')} "
              f"mean={st.get('mean')} min={st.get('min')} max={st.get('max')} "
              f"rate={st.get('rate')}")
        for ts, v in points[source][-args.tail:]:
            print(f"  {_fmt_ts(ts)}  {v}")
    return 0


def cmd_trace(args) -> int:
    """Distributed-trace consumer: list retained traces, or render one
    trace's waterfall + ranked critical path. Exit 0 on success, 1 when
    nothing matched (scriptable: a bench can assert its slow request is
    retrievable)."""
    from ..obs.waterfall import build_waterfall, render_listing, render_waterfall

    if args.id:
        body = _try_get(args.addr, f"/trace/{args.id}", timeout=10.0)
        if not body or not body.get("spans"):
            print(f"no spans for trace {args.id!r} at {args.addr}")
            return 1
        if args.json:
            print(json.dumps(body, indent=1))
            return 0
        report = body.get("waterfall") or build_waterfall(body["spans"])
        print(render_waterfall(report))
        return 0
    qs = [f"limit={args.limit}"]
    if args.name:
        qs.append(f"name={urllib.parse.quote(args.name)}")
    if args.min_ms:
        qs.append(f"min_ms={args.min_ms}")
    if args.outcome:
        qs.append(f"outcome={urllib.parse.quote(args.outcome)}")
    body = _try_get(args.addr, "/traces?" + "&".join(qs), timeout=10.0)
    if body is None:
        raise SystemExit(f"GET /traces failed at {args.addr} (no trace surface?)")
    rows = body.get("traces") or []
    if args.json:
        print(json.dumps(body, indent=1))
        return 0 if rows else 1
    print(render_listing(rows), end="")
    ing = body.get("ingest") or {}
    buf = body.get("buffer") or {}
    print(f"(ingest: {ing.get('records', 0)} records / "
          f"{ing.get('sources', 0)} sources; local buffer: "
          f"{buf.get('resident', 0)}/{buf.get('maxlen', 0)})")
    return 0 if rows else 1


def cmd_profile(args) -> int:
    """On-demand fleet profiling: POST /learner/profile?steps=N on a live
    learner's admin surface, print the ranked bucket table. Blocks while
    the learner captures + analyzes (bounded by --timeout)."""
    url = (f"http://{args.addr}/learner/profile?steps={args.steps}"
           f"&timeout_s={args.timeout}")
    req = urllib.request.Request(url, data=b"{}", method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        # +30s transport grace over the learner-side capture budget
        with urllib.request.urlopen(req, timeout=args.timeout + 30.0) as resp:
            body = json.loads(resp.read())
    except (urllib.error.URLError, ConnectionError, TimeoutError, OSError,
            ValueError) as e:
        raise SystemExit(f"POST {url} failed: {e!r}")
    if body.get("code") != 0:
        raise SystemExit(f"profile failed: {body.get('info')}")
    report = body["info"]
    if args.json:
        print(json.dumps(report, indent=1))
        return 0
    print(report.get("markdown", ""))
    perf = report.get("perf") or {}
    if perf:
        parts = [f"{k}={v:.6g}" for k, v in sorted(perf.items())
                 if isinstance(v, (int, float))]
        print("live perf: " + " ".join(parts))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=("status", "tail-alerts", "query",
                                       "profile", "trace", "dynamics",
                                       "arena", "league"))
    p.add_argument("--addr", default="127.0.0.1:8423", help="host:port of a health surface")
    p.add_argument("--interval", type=float, default=2.0, help="tail-alerts poll cadence")
    p.add_argument("--once", action="store_true",
                   help="tail-alerts: print the history once and exit "
                        "(exit 2 when anything is firing)")
    p.add_argument("--replay-addrs", default="",
                   help="status: comma-separated replay ADMIN surfaces to "
                        "aggregate the shard-fleet digest across (default: "
                        "auto-discover from the probed coordinator's "
                        "replay_shard registrations, else probe --addr)")
    p.add_argument("--name", default="", help="query: flattened series name")
    p.add_argument("--window", type=float, default=300.0, help="query window seconds")
    p.add_argument("--source", default="", help="query: restrict to one source")
    p.add_argument("--tail", type=int, default=10, help="query: points to print per source")
    p.add_argument("--json", action="store_true",
                   help="query/profile: raw JSON output")
    p.add_argument("--steps", type=int, default=2,
                   help="profile: iterations of device trace to capture")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="profile: learner-side capture+analysis budget (s)")
    p.add_argument("--id", default="",
                   help="trace: render this trace_id's waterfall instead of "
                        "listing")
    p.add_argument("--min-ms", type=float, default=0.0,
                   help="trace: list only traces at least this slow")
    p.add_argument("--outcome", default="",
                   help="trace: filter by outcome (ok/shed/error)")
    p.add_argument("--limit", type=int, default=20,
                   help="trace: max listings")
    p.add_argument("--dir", default="",
                   help="dynamics: blackbox directory (or an experiment "
                        "root containing blackbox/)")
    p.add_argument("--inspect", default="",
                   help="dynamics: inspect the bundle whose id contains "
                        "this substring instead of listing")
    args = p.parse_args(argv)
    if args.command == "status":
        return cmd_status(args)
    if args.command == "dynamics":
        if not args.dir:
            p.error("dynamics requires --dir")
        return cmd_dynamics(args)
    if args.command == "tail-alerts":
        return cmd_tail_alerts(args)
    if args.command == "profile":
        return cmd_profile(args)
    if args.command == "trace":
        return cmd_trace(args)
    if args.command == "arena":
        return cmd_arena(args)
    if args.command == "league":
        return cmd_league(args)
    if not args.name:
        p.error("query requires --name")
    return cmd_query(args)


if __name__ == "__main__":
    raise SystemExit(main())
