"""The port's serving frontends against the JAX package's, on the CPU, over
their mock engines: one request script through both packages' HTTP and TCP
frontends gets equal answers, typed errors included (queue-full shed,
drain 503, unknown version, ``bad_hello``, ``bad_frame``); each package's
client talks to the other's server (the JAX client's ``DTL0`` frames
included); ``GatewayMux`` routes by ``player``; ``bin/serve.py`` runs as a
process, answers, and exits 0 on SIGTERM."""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from conftest import SMALL_MODEL

from distar_tpu import obs as jobs
from distar_tpu import serve as jserve
from distar_tpu.comm import serializer as jser
from distar_tpu_torch import obs as pobs
from distar_tpu_torch import serve as pserve
from distar_tpu_torch.bin import serve as serve_bin
from distar_tpu_torch.comm import serializer as pser
from distar_tpu_torch.model import Model, default_model_config, init_params
from distar_tpu_torch.model.convert import params_to_flax
from distar_tpu_torch.utils import checkpoint as ckpt
from distar_tpu_torch.utils import deep_merge_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = {"port": (pserve, pobs), "jax": (jserve, jobs)}
STATUS_KEYS = ("transports", "draining", "queue_depth", "served_version", "generation", "sessions",
               "requests", "shed_rate")


def plain(tree):
    """Answers as comparable plain values (arrays to lists)."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        return np.asarray(tree).tolist()
    return tree


def stack(lib, slots=4, **gateway):
    """A mock gateway (with a teacher) behind both frontends, on a metrics
    registry and a fleet-health handle of its own (a handle an earlier test
    of the worker left may hold a firing rule: a learner's
    ``distar_perf_mfu`` reads 0 until its flop count lands)."""
    serve, obs = LIBS[lib]
    obs.set_registry(obs.MetricsRegistry())
    prev = obs.set_fleet_health(None)
    if prev is not None:
        prev.stop()
    engine = serve.MockModelEngine(slots, teacher_params={"version": "t0"})
    gw = serve.InferenceGateway(engine, **{"max_delay_s": 0.005, **gateway}).start()
    gw.load_version("v1", params={"version": "v1", "bias": 1.0}, activate=True)
    return gw, serve.ServeHTTPServer(gw, port=0).start(), serve.ServeTCPServer(gw, port=0, transport="tcp").start()


def stop(gw, http, tcp):
    http.stop()
    tcp.stop()
    gw.drain_and_stop()


def post(http, route, body):
    req = urllib.request.Request(f"http://127.0.0.1:{http.port}{route}", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(http, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{http.port}{route}", timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


OBS = {"x": [1.0, 2.0]}
HTTP_SCRIPT = [
    ("/serve/act", {"session_id": "s0", "obs": OBS}),
    ("/serve/act", {"session_id": "s0", "obs": {"x": [3.0]}}),
    ("/serve/act", {"session_id": "s1", "obs": OBS, "timeout_s": 5.0}),
    ("/serve/reset", {"session_id": "s0"}),
    ("/serve/act", {"session_id": "s0", "obs": OBS}),
    ("/serve/end", {"session_id": "s1"}),
    ("/serve/end", {"session_id": "nobody"}),
    ("/serve/swap", {"version": "nope"}),
    ("/serve/nothing", {}),
    ("/serve/status", {}),
    ("/serve/drain", {}),
    ("/serve/act", {"session_id": "s2", "obs": OBS}),
]


def run_http(lib):
    gw, http, tcp = stack(lib)
    try:
        out = []
        for route, body in HTTP_SCRIPT:
            status, resp = post(http, route, body)
            if route == "/serve/status":
                resp["info"] = {k: resp["info"].get(k) for k in STATUS_KEYS}
            out.append((status, resp))
        metrics = get(http, "/metrics")
        health = get(http, "/healthz")[0]
        return out, metrics, health
    finally:
        stop(gw, http, tcp)


def test_http_script_answers_like_the_jax_frontend():
    got, metrics, health = run_http("port")
    want, jmetrics, jhealth = run_http("jax")
    assert got == want
    assert got[-1][0] == 503 and got[-1][1]["code"] == "draining"
    assert got[7][1]["code"] == "unknown_version"
    # the same series; the counts of requests alike
    names = [{ln.split("{")[0].split(" ")[0] for ln in m[1].splitlines() if not ln.startswith("#")}
             for m in (metrics, jmetrics)]
    assert metrics[0] == jmetrics[0] == 200 and names[0] == names[1]
    count = [sorted(ln for ln in m[1].splitlines() if ln.startswith("distar_serve_requests_total"))
             for m in (metrics, jmetrics)]
    assert count[0] == count[1]
    # fleet health answers as the JAX package's does
    assert health == jhealth == 200


def framed(sock, obj, lib="port"):
    (pser if lib == "port" else jser).send_msg(sock, obj)
    return pser.recv_msg(sock)


TCP_SCRIPT = [
    {"op": "hello", "transports": ["tcp"]},
    {"op": "hello", "transports": ["shm", "tcp"], "codecs": ["zstd", "lz4"], "host": "elsewhere"},
    {"op": "ping"},
    {"op": "act", "session_id": "a", "obs": {"x": np.array([1.0, 2.0])}},
    {"op": "act", "session_id": "a", "obs": {"x": np.array([1.0])}, "want_teacher": True},
    {"op": "act_many", "requests": [{"session_id": "a", "obs": {"x": np.ones(3)}, "want_teacher": True},
                                    {"session_id": "b", "obs": {"x": np.zeros(2)}}]},
    {"op": "set_teacher", "params": {"version": "t1"}},
    {"op": "act", "session_id": "b", "obs": {"x": np.array([2.0])}, "want_teacher": True},
    {"op": "reserve", "session_ids": ["r0", "r1"]},
    {"op": "reserve", "session_ids": ["q0", "q1", "q2"]},
    {"op": "hidden", "session_id": "a"},
    {"op": "reset", "session_id": "a"},
    {"op": "end", "session_id": "r0"},
    {"op": "swap", "version": "nope"},
    {"op": "load", "version": "v2", "params": {"version": "v2", "bias": -1.0}, "activate": True},
    {"op": "act", "session_id": "a", "obs": {"x": np.array([5.0])}},
    {"op": "status"},
    {"op": "bogus"},
    "not a request",
    {"op": "drain"},
    {"op": "act", "session_id": "c", "obs": {"x": np.array([1.0])}},
]


def run_tcp(lib, client_lib):
    gw, http, tcp = stack(lib)
    try:
        out = []
        with socket.create_connection(("127.0.0.1", tcp.port)) as sock:
            for req in TCP_SCRIPT:
                resp = framed(sock, req, client_lib)
                if isinstance(req, dict) and req.get("op") == "status":
                    resp["status"] = {k: resp["status"].get(k) for k in STATUS_KEYS}
                if isinstance(req, dict) and req.get("op") == "load":
                    resp["info"] = sorted(resp["info"])
                out.append(plain(resp))
        for bad in ({"op": "hello", "transports": ["carrier-pigeon"]},
                    {"op": "hello", "codecs": ["morse"]}):
            with socket.create_connection(("127.0.0.1", tcp.port)) as sock:
                out.append(plain(framed(sock, bad)))
                assert sock.recv(1) == b""  # a NACKed peer is disconnected
        with socket.create_connection(("127.0.0.1", tcp.port)) as sock:
            sock.sendall(pser.frame(b"XXXXnot a payload"))
            out.append(plain(pser.recv_msg(sock)))
            assert sock.recv(1) == b""
        return out
    finally:
        stop(gw, http, tcp)


@pytest.mark.parametrize("client_lib", ["port", "jax"])
def test_tcp_script_answers_like_the_jax_frontend(client_lib):
    """Raw frames (zlib-1 from the port's serializer, ``DTL0`` from the JAX
    package's) to both servers: the same answers."""
    got, want = run_tcp("port", client_lib), run_tcp("jax", client_lib)
    assert got == want
    codes = [r.get("code") for r in got]
    assert codes[:3] == [0, 0, 0] and got[0]["transport"] == "tcp"
    assert got[4]["outputs"]["teacher_logit"] == {"teacher_step": 1, "teacher_version": "t0"}
    assert got[7]["outputs"]["teacher_logit"]["teacher_version"] == "t1"
    assert got[9]["code"] == "shed_capacity" and got[13]["code"] == "unknown_version"
    assert got[15]["outputs"]["model_version"] == "v2"
    assert codes[-3:] == ["bad_hello", "bad_hello", "bad_frame"]
    assert got[-4]["code"] == "draining"


def shed_queue_full(lib):
    """A queue of one: the second request of a cycle sheds typed."""
    gw, http, tcp = stack(lib, queue_capacity=1, max_delay_s=0.5)
    try:
        with socket.create_connection(("127.0.0.1", tcp.port)) as sock:
            return plain(framed(sock, {"op": "act_many", "requests": [
                {"session_id": "a", "obs": {"x": np.ones(1)}}, {"session_id": "b", "obs": {"x": np.ones(1)}}]}))
    finally:
        stop(gw, http, tcp)


def test_queue_full_sheds_like_the_jax_gateway():
    got = shed_queue_full("port")
    assert got == shed_queue_full("jax")
    assert "ok" in got["results"][0] and got["results"][1]["code"] == "shed_queue_full"
    assert got["results"][1]["shed"] is True


def test_clients_talk_to_the_other_packages_server():
    """The JAX client (it offers shared memory in a hello and writes
    ``DTL0`` frames) against the port's server, and the port's client
    against the JAX server."""
    assert jser.dumps({"x": 1}).startswith(pser.MAGIC_LZ)  # the JAX client's codec here
    for server_lib, client in (("port", lambda port: jserve.ServeClient("127.0.0.1", port)),
                               ("jax", lambda port: pserve.ServeClient("127.0.0.1", port))):
        gw, http, tcp = stack(server_lib)
        try:
            c = client(tcp.port)
            assert c.transport_active == "tcp" and c.ping()
            out = c.act("s0", {"x": np.arange(5.0)}, want_teacher=True)
            assert out["model_version"] == "v1" and float(out["action"]) == 11.0
            assert out["teacher_logit"]["teacher_version"] == "t0"
            many = c.act_many([{"session_id": "s0", "obs": {"x": np.ones(2)}},
                               {"session_id": "s1", "obs": {"x": np.ones(3)}}])
            assert [o["session_step"] for o in many] == [2, 1]
            assert c.set_teacher({"version": "t9"}) is True
            assert c.load("v2", params={"version": "v2", "bias": 0.0})["version"] == "v2"
            assert c.swap("v2") == 2
            assert c.act("s1", {"x": np.ones(1)})["model_version"] == "v2"
            with pytest.raises((jserve.UnknownVersionError, pserve.UnknownVersionError)):
                c.swap("nope")
            c.close()
        finally:
            stop(gw, http, tcp)


def wait_counted_off(srv, timeout_s=5.0):
    """Until a stopped server's handler threads have counted their
    connections off. ``stop()`` closes the live sockets without joining
    the handlers (as the JAX server's does), and a stopped server's counts
    stay summed into its gateway's status."""
    deadline = time.monotonic() + timeout_s
    while srv.transport_counts() != {"tcp": 0, "shm": 0}:
        assert time.monotonic() < deadline, f"connections still counted after stop(): {srv.transport_counts()}"
        time.sleep(0.01)


def test_transports_auto_and_shm_negotiate_rings():
    """``auto`` (the default) and ``shm`` get a ring pair from the same
    host, ``tcp`` does not; the status counts connections by transport,
    as the JAX server's does."""
    gw, http, tcp = stack("port")
    try:
        for transport in ("auto", "shm"):
            srv = pserve.ServeTCPServer(gw, port=0, transport=transport).start()
            c = pserve.ServeClient("127.0.0.1", srv.port, transport=transport)
            assert c.transport_active == "shm" and c.act("s", {"x": np.ones(2)})["model_version"] == "v1"
            assert gw.status()["transports"] == {"tcp": 0, "shm": 1}
            c.close()
            srv.stop()
            wait_counted_off(srv)
        c = pserve.ServeClient("127.0.0.1", tcp.port)  # the stack's server refuses rings
        assert c.transport_active == "tcp" and c.ping()
        c.close()
        with pytest.raises(ValueError):
            pserve.ServeTCPServer(gw, port=0, transport="carrier-pigeon")
        with pytest.raises(ValueError):
            pserve.ServeClient("127.0.0.1", tcp.port, transport="carrier-pigeon")
    finally:
        stop(gw, http, tcp)


@pytest.mark.parametrize("kind", ["gateway", "mux"])
def test_two_tcp_frontends_on_one_target_sum_their_transports(kind):
    """Every TCP frontend mounted on a gateway or a mux hands in its
    connection counts; ``status()["transports"]`` sums them (one frontend
    does not hide another's)."""
    pobs.set_registry(pobs.MetricsRegistry())
    gw = pserve.InferenceGateway(pserve.MockModelEngine(2), max_delay_s=0.005)
    target = (gw if kind == "gateway" else pserve.GatewayMux({"MP0": gw})).start()
    assert "transports" not in target.status()
    servers = [pserve.ServeTCPServer(target, port=0, transport=t).start() for t in ("tcp", "shm")]
    clients = []
    try:
        clients = [pserve.ServeClient("127.0.0.1", srv.port, transport=t)
                   for srv, t in zip(servers, ("tcp", "shm"))]
        assert [c.transport_active for c in clients] == ["tcp", "shm"]
        # the tcp client sends no hello: its round trip first, so the server
        # has counted its connection before the target's sum is read
        assert clients[0].status()["transports"] == {"tcp": 1, "shm": 1}
        assert target.status()["transports"] == {"tcp": 1, "shm": 1}
    finally:
        for c in clients:
            c.close()
        for srv in servers:
            srv.stop()
        target.drain_and_stop()


def test_mux_routes_by_player():
    pobs.set_registry(pobs.MetricsRegistry())
    gws = {}
    for player, bias in (("MP0", 0.0), ("MP1", 10.0)):
        gws[player] = pserve.InferenceGateway(pserve.MockModelEngine(4), max_delay_s=0.005)
        gws[player].load_version(f"v_{player}", params={"version": f"v_{player}", "bias": bias},
                                 activate=True)
    mux = pserve.GatewayMux(gws).start()
    tcp = pserve.ServeTCPServer(mux, port=0).start()
    http = pserve.ServeHTTPServer(mux, port=0).start()
    try:
        c = pserve.ServeClient("127.0.0.1", tcp.port)
        assert c.act("s", {"x": np.ones(1)})["model_version"] == "v_MP0"
        one = c.act("s", {"x": np.ones(1)}, player="MP1")
        assert one["model_version"] == "v_MP1" and float(one["action"]) == 11.0 and one["session_step"] == 1
        assert pserve.ServeClient("127.0.0.1", tcp.port, player="MP1").act("t", {"x": np.ones(1)})[
            "model_version"] == "v_MP1"
        with pytest.raises(pserve.UnknownPlayerError):
            c.act("s", {"x": np.ones(1)}, player="nobody")
        status, resp = post(http, "/serve/act", {"session_id": "h", "obs": OBS, "player": "MP1"})
        assert status == 200 and resp["info"]["model_version"] == "v_MP1", resp
        assert sorted(c.status()["players"]) == ["MP0", "MP1"]
        assert c.drain()["draining"] and all(gw.draining for gw in gws.values())
        c.close()
    finally:
        http.stop()
        tcp.stop()
        mux.drain_and_stop()
    for traffic in ("eval", "ladder", "rollout", "bulk", "unknown"):
        assert pserve.tier_player(traffic) == jserve.tier_player(traffic)


def test_serializer_reads_every_jax_magic():
    obj = {"obs": np.arange(1000, dtype=np.float32).reshape(10, 100), "s": "x" * 500}
    for codec, magic in (("lz4", pser.MAGIC_LZ), ("zlib", pser.MAGIC_ZLIB)):
        blob = jser.dumps(obj, codec=codec)
        assert blob[:4] == magic
        back = pser.loads(blob)
        np.testing.assert_array_equal(back["obs"], obj["obs"])
    raw = jser.dumps(obj, compress=False)
    assert pser.loads(raw)["s"] == obj["s"] and jser.loads(pser.dumps(obj))["s"] == obj["s"]
    with pytest.raises(ValueError):
        pser.loads(pser.MAGIC_LZ + (10 ** 12).to_bytes(8, "little") + b"\x00" * 10)
    with pytest.raises(ValueError):
        pser.loads(b"XXXXjunk")
    assert pser.supported_codecs() == jser.supported_codecs()
    for prefs in (["zstd", "zlib"], ["morse"], None):
        assert pser.negotiate_codec(prefs, ("lz4", "zlib")) == jser.negotiate_codec(prefs, ("lz4", "zlib"))


def serve_process(*flags):
    """``python -m distar_tpu_torch.bin.serve`` on free ports; returns (the
    process, its HTTP port, its TCP port) once it has said where it serves."""
    proc = subprocess.Popen([sys.executable, "-m", "distar_tpu_torch.bin.serve", "--host", "127.0.0.1",
                             "--http-port", "0", "--tcp-port", "0", *flags],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    assert "serving:" in line, line + proc.stdout.read()
    http = int(line.split("http=")[1].split()[0].rsplit(":", 1)[1])
    tcp = int(line.split("tcp=")[1].split()[0].rsplit(":", 1)[1])
    assert f"health={'off' if '--no-health' in flags else 'on'}" in line
    return proc, http, tcp


def sigterm(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=30)
    finally:
        proc.kill()
    out = proc.stdout.read()
    proc.stdout.close()
    assert rc == 0, out
    assert "drained; bye" in out


def test_bin_serve_mock_process_answers_and_exits_0_on_sigterm():
    proc, http, tcp = serve_process("--mock", "--players", "MP0,MP1", "--no-health")
    try:
        c = pserve.ServeClient("127.0.0.1", tcp)
        assert c.act("s", {"x": np.ones(2)}, player="MP1")["model_version"] == "v1"
        assert c.status()["players"]["MP0"]["served_version"] is None
        c.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/metrics", timeout=10) as r:
            assert 'distar_serve_requests_total{outcome="ok"} 1' in r.read().decode()
    finally:
        sigterm(proc)


def test_bin_serve_checkpoint_process_on_the_cpu(tmp_path):
    """A SMALL_MODEL learner checkpoint written by the port, served by the
    process on the CPU (``--device cpu``), one act over TCP."""
    cfg = {"model": SMALL_MODEL}
    model = Model(deep_merge_dicts(default_model_config(), SMALL_MODEL))
    init_params(model, 3)
    path = str(tmp_path / "small.ckpt")
    ckpt.save_checkpoint(path, {"params": params_to_flax(model), "opt_state": ()})
    proc, http, tcp = serve_process("--checkpoint", path, "--device", "cpu", "--slots", "2",
                                    "--config", json.dumps(cfg))
    try:
        from distar_tpu_torch.lib import features as F

        c = pserve.ServeClient("127.0.0.1", tcp)
        out = c.act("s", F.random_step_data(np.random.default_rng(0)))
        assert out["model_version"] == "v1" and np.isfinite(out["logit"]["action_type"]).all()
        boot = c.status()["registry"]["versions"]["v1"]
        assert boot["source"] == path and boot["warmup_s"] > 0
        c.close()
    finally:
        sigterm(proc)


@pytest.mark.parametrize("flags", [["--telemetry-interval-s", "0.5"], []], ids=["0.5", "default_5"])
def test_bin_serve_ships_telemetry_to_its_coordinator(flags, tmp_path):
    """``--telemetry-interval-s`` (5.0 by default, as in the JAX package)
    with ``--coordinator-addr``: the gateway process's snapshots reach the
    coordinator's store under ``serve:<tcp port>``, and its answers to the
    fleet-health routes are the process's own."""
    from distar_tpu_torch.comm import CoordinatorServer
    from distar_tpu_torch.obs import FleetHealth, set_fleet_health

    fleet = FleetHealth()
    prev = set_fleet_health(fleet)
    coord = CoordinatorServer()
    coord.start()
    proc, http, tcp = serve_process("--mock", "--coordinator-addr", f"{coord.host}:{coord.port}", *flags)
    try:
        deadline = time.time() + 30
        while time.time() < deadline and f"serve:{tcp}" not in fleet.store.sources():
            time.sleep(0.1)
        assert f"serve:{tcp}" in fleet.store.sources(), fleet.store.sources()
        assert any(n.startswith("distar_serve_") for n in fleet.store.names(f"serve:{tcp}"))
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/alerts", timeout=10) as r:
            assert {"serve_shed_rate", "serve_latency_slo", "trace_e2e_slo"} == set(json.loads(r.read())["rules"])
    finally:
        sigterm(proc)
        coord.stop()
        set_fleet_health(prev)


def test_bin_serve_needs_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "x.ckpt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_bin.main(["--checkpoint", path, "--http-port", "0", "--tcp-port", "0"])
