"""The port's data plane against the JAX package's, on the CPU: the native
shuttle library builds with g++, its CRC-32 and LZ4 block stream equal the
JAX package's byte for byte, the native and plain decoders agree on each
other's and the JAX package's frames, ``dumps`` writes the JAX package's
``DTL0`` bytes, hostile headers are refused typed, the socket shuttle talks
across the packages, and either package's coordinator client talks to the
other's ``CoordinatorServer``. Every socket and subprocess has its own time
limit."""
import io
import os
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from distar_tpu.comm import coordinator as jcoord
from distar_tpu.comm import serializer as jser
from distar_tpu.comm import shuttle as jshuttle
from distar_tpu_torch.comm import coordinator as pcoord
from distar_tpu_torch.comm import discovery as pdisc
from distar_tpu_torch.comm import serializer as pser
from distar_tpu_torch.comm import shuttle as pshuttle
from distar_tpu_torch.resilience import NO_RETRY, CommError


def payloads():
    """Seeded payloads: empty, one byte, incompressible, repetitive, and 8
    MiB of float32 with runs (LZ matches and literals both)."""
    rng = np.random.default_rng(7)
    floats = np.repeat(rng.normal(size=1 << 19).astype(np.float32), 4)
    return {"empty": b"", "one_byte": b"\x2a", "incompressible": rng.bytes(300_001),
            "repetitive": b"distar" * 40_000, "8MiB": floats.tobytes()}


PAYLOADS = payloads()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package builds its own library at first use, without a lock
    across processes, and retries a load that failed: wait until it loads
    (another pytest worker may be writing it), so its codec is compared,
    not its zlib fallback."""
    deadline = time.monotonic() + 120
    while not jshuttle.native_available():
        assert time.monotonic() < deadline, "the JAX package's native shuttle did not build"
        time.sleep(0.5)


def test_native_shuttle_builds_with_gxx():
    lib = pshuttle.library_path()
    assert lib.name.startswith("shuttle-") and lib.suffix == ".so"
    assert pshuttle.build() == lib and lib.exists()
    assert pshuttle.load() is pshuttle.load()


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_crc32_equals_zlib_and_jax(name):
    data = PAYLOADS[name]
    want = zlib.crc32(data)
    assert pshuttle.crc32(data) == want == jshuttle.crc32(data)
    assert pshuttle.crc32(memoryview(data)) == want  # the rings hand views
    assert pshuttle.crc32(data[len(data) // 2:], pshuttle.crc32(data[:len(data) // 2])) == want


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_lz_compress_byte_equal_to_jax(name):
    data = PAYLOADS[name]
    assert pshuttle.lz_compress(data) == jshuttle.lz_compress(data)


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_decoders_agree_across_packages(name):
    """Native and plain decoders, the port's and the JAX package's, each on
    each package's stream."""
    data = PAYLOADS[name]
    for stream in (pshuttle.lz_compress(data), jshuttle.lz_compress(data)):
        assert pshuttle.lz_decompress(stream, len(data)) == data
        assert pshuttle.lz_decompress(memoryview(stream), len(data)) == data
        assert pshuttle.py_lz_decompress(stream, len(data)) == data
        assert jshuttle.lz_decompress(stream, len(data)) == data
        assert jshuttle._py_lz_decompress(stream, len(data)) == data


def test_serializer_writes_the_jax_dtl0_bytes():
    rng = np.random.default_rng(3)
    obj = {"obs": rng.normal(size=(64, 128)).astype(np.float32), "mask": np.ones(512, bool),
           "ids": np.arange(4096), "s": "x" * 300, "nested": [{"a": 1}, None]}
    blob = pser.dumps(obj)
    assert blob[:4] == pser.MAGIC_LZ and blob == jser.dumps(obj)
    assert pser.dumps_sized(obj) == jser.dumps_sized(obj)
    back = jser.loads(blob)
    np.testing.assert_array_equal(back["obs"], obj["obs"])
    assert pser.loads(jser.dumps(obj))["nested"] == obj["nested"]
    for codec in ("zlib",):
        assert pser.dumps(obj, codec=codec) == jser.dumps(obj, codec=codec)
    assert pser.dumps(obj, compress=False) == jser.dumps(obj, compress=False)
    ours, theirs = io.BytesIO(), io.BytesIO()
    pser.dump_stream(obj, ours)
    jser.dump_stream(obj, theirs)
    assert ours.getvalue() == theirs.getvalue()
    assert pser.loads(ours.getvalue())["s"] == obj["s"]


def test_opaque_and_payload_files_across_packages(tmp_path):
    obj = {"traj": np.arange(2000, dtype=np.float32), "k": "v"}
    op = pser.Opaque.encode(obj)
    assert op.blob == jser.Opaque.encode(obj).blob
    inner = pser.loads(pser.dumps({"item": op}))["item"]
    assert isinstance(inner, pser.Opaque)
    np.testing.assert_array_equal(pser.maybe_decode(inner)["traj"], obj["traj"])
    assert pser.maybe_decode(5) == 5
    path = str(tmp_path / "p.bin")
    pser.save_payload(path, obj)
    np.testing.assert_array_equal(jser.load_payload(path)["traj"], obj["traj"])
    assert pser.load_payload(path)["k"] == "v"


@pytest.mark.parametrize("blob", [
    pser.MAGIC_LZ + (10 ** 12).to_bytes(8, "little") + b"\x00" * 10,  # implausible size
    pser.MAGIC_LZ + b"\x01\x02",  # truncated header
    pser.MAGIC_LZ + (100).to_bytes(8, "little") + bytes([0x0F, 0x00, 0x00]),  # offset 0
    pser.MAGIC_LZ + (100).to_bytes(8, "little") + bytes([0x50]) + b"abc",  # truncated literals
    pser.MAGIC_LZ + (9).to_bytes(8, "little") + bytes([0x40]) + b"abcd",  # short stream
    b"XXXXjunk",  # unknown magic
], ids=["size", "header", "offset", "literals", "short", "magic"])
def test_hostile_dtl0_refused_typed(blob):
    with pytest.raises(ValueError):
        pser.loads(blob)
    with pytest.raises(ValueError):
        jser.loads(blob)


def test_native_decoder_refuses_what_the_plain_one_refuses():
    good = pshuttle.lz_compress(PAYLOADS["repetitive"])
    n = len(PAYLOADS["repetitive"])
    for bad, size in ((good[:-3], n), (good, n - 1), (good, n + 1), (b"\xf0", 20)):
        for decode in (pshuttle.lz_decompress, pshuttle.py_lz_decompress):
            with pytest.raises(ValueError):
                decode(bad, size)


def test_shuttle_serve_fetch_across_packages():
    payload = PAYLOADS["incompressible"]
    pairs = ((pshuttle.serve, jshuttle.fetch), (jshuttle.serve, pshuttle.fetch),
             (pshuttle.serve, pshuttle.py_fetch), (pshuttle.py_serve, pshuttle.fetch))
    for serve, fetch in pairs:
        port = serve(payload, 1, 10_000)
        assert fetch("127.0.0.1", port, 10_000) == payload
    port = pshuttle.serve(b"w" * 1000, 3, 10_000)
    assert [pshuttle.fetch("127.0.0.1", port, 10_000) for _ in range(3)] == [b"w" * 1000] * 3
    with pytest.raises(OSError):
        pshuttle.fetch("127.0.0.1", 1, 2_000)  # nobody serves there


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "shuttle.cpp"
    broken.write_text(pshuttle.SRC.read_text().replace("extern \"C\" {", "extern \"C\" { not c++;", 1))
    monkeypatch.setattr(pshuttle, "SRC", broken)
    monkeypatch.setattr(pshuttle, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited") as e:
        pshuttle.build()
    assert "not" in str(e.value) and not list((tmp_path / "build").glob("*.so*"))


def test_concurrent_builds_publish_one_whole_library(tmp_path):
    """Four processes build into an empty directory at once, as pytest
    workers or a fleet's gateways do: each loads a whole library."""
    script = textwrap.dedent(f"""
        import pathlib, zlib
        from distar_tpu_torch.comm import shuttle
        shuttle.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        assert shuttle.crc32(b"abc" * 500) == zlib.crc32(b"abc" * 500)
        print(shuttle.library_path().name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o.strip() for o, _ in outs}) == 1
    assert [f.name for f in tmp_path.glob("*.so")] == [outs[0][0].strip()]
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------- coordinator
def test_coordinator_register_heartbeat_lease_and_strikes():
    co = pcoord.Coordinator()
    assert co.ask("t") is None and co.depth("t") == 0
    co.register("t", "1.2.3.4", 1111, {"n": 1})
    co.register("t", "1.2.3.4", 2222)
    assert co.depth("t") == 2 and co.depth("t", max_age_s=0) == 0
    assert [r["port"] for r in co.peers("t")] == [1111, 2222] and co.depth("t") == 2
    rec = co.ask("t")
    assert (rec["ip"], rec["port"], rec["meta"]) == ("1.2.3.4", 1111, {"n": 1})
    for _ in range(5):
        co.strike("1.2.3.4", 2222)
    assert co.ask("t") is None
    # leases: a heartbeat keeps one endpoint, the other lapses
    co.register("g", "h", 1, lease_s=0.3)
    co.register("g", "h", 2, lease_s=0.3)
    assert co.heartbeat("h", 1, lease_s=60.0) is True
    co._last_sweep = 0.0
    time.sleep(0.4)
    assert [r["port"] for r in co.peers("g")] == [1]
    assert co.heartbeat("h", 2) is False  # its records are gone: register again
    assert co.unregister("h", 1) == 1 and co.peers("g") == []
    assert co.stats() == {"t": 0, "g": 0}


def _servers():
    """(label, server) pairs: the port's CoordinatorServer and the JAX
    package's, each on a free port."""
    return [("port", pcoord.CoordinatorServer(port=0)), ("jax", jcoord.CoordinatorServer(port=0))]


def test_coordinator_requests_across_packages():
    """Each package's ``coordinator_request`` against each package's
    server: the same answers route by route."""
    answers = {}
    for label, srv in _servers():
        srv.start()
        try:
            for client in ("port", "jax"):
                req = (pcoord if client == "port" else jcoord).coordinator_request
                tok = f"{client}-tok"
                got = [req(srv.host, srv.port, "register", {"token": tok, "ip": "a", "port": 1,
                                                            "meta": {"m": 1}, "lease_s": 30.0}),
                       req(srv.host, srv.port, "register", {"token": tok, "ip": "a", "port": 2}),
                       req(srv.host, srv.port, "heartbeat", {"ip": "a", "port": 1, "lease_s": 30.0}),
                       req(srv.host, srv.port, "depth", {"token": tok}),
                       req(srv.host, srv.port, "unregister", {"ip": "a", "port": 2}),
                       req(srv.host, srv.port, "strike", {"ip": "a", "port": 9})]
                peers = req(srv.host, srv.port, "peers", {"token": tok})["info"]
                got.append([(p["ip"], p["port"], p["meta"]) for p in peers])
                got.append(req(srv.host, srv.port, "ask", {"token": tok})["info"]["port"])
                got.append(req(srv.host, srv.port, "ask", {"token": tok}))
                got.append(req(srv.host, srv.port, "stats", {"max_age_s": None}))
                got.append(req(srv.host, srv.port, "nope", {}))
                answers[(label, client)] = [{k: v for k, v in g.items() if k not in ("epoch", "role")}
                                            if isinstance(g, dict) else g for g in got]
                req(srv.host, srv.port, "unregister", {"ip": "a", "port": 1})
        finally:
            srv.stop()
    for client in ("port", "jax"):
        assert answers[("port", client)] == answers[("jax", client)], client
    want = answers[("jax", "jax")]
    assert want[3]["info"] == 2 and want[6] == [("a", 1, {"m": 1})] and want[7] == 1
    assert want[-1]["code"] == 404


def test_coordinator_discovery_and_metrics_scrape():
    import urllib.request

    srv = pcoord.CoordinatorServer(port=0)
    srv.start()
    try:
        coord = (srv.host, srv.port)
        beat = pdisc.register_endpoint(coord, "svc", "127.0.0.1", 7001, meta={"k": 1}, lease_s=60.0)
        pdisc.register_endpoint(coord, "svc", "127.0.0.1", 7002, lease_s=0.2,
                                heartbeat_interval_s=30.0).stop_event.set()
        assert {r["port"] for r in pdisc.discover_endpoints(f"{srv.host}:{srv.port}", "svc")} == {7001, 7002}
        assert {r["port"] for r in jcoord.coordinator_request(srv.host, srv.port, "peers",
                                                              {"token": "svc"})["info"]} == {7001, 7002}
        time.sleep(1.2)  # the lease of 7002 lapses (the sweep runs at most once a second)
        assert [r["port"] for r in pdisc.discover_endpoints(coord, "svc")] == [7001]
        seen = []
        refresher = pdisc.start_refresh(coord, "svc", seen.append, interval_s=0.05)
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.02)
        refresher.stop_event.set()
        assert seen and seen[0][0]["meta"] == {"k": 1}
        assert pdisc.unregister_endpoint(coord, "127.0.0.1", 7001) == 1
        beat.stop_event.set()
        with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "distar_coordinator_unregisters_total" in text
        assert 'distar_coordinator_queue_depth{token="svc"} 0' in text
    finally:
        srv.stop()


def test_unported_coordinator_parts_name_their_roadmap_item():
    """Nothing of the coordinator is left unported: an address list (the HA
    client) rotates past a dead first address to a live one, for
    ``coordinator_request`` and discovery alike; a server starts with no HA
    attached; the routes a process hosts nothing for answer as the JAX
    coordinator's do."""
    from distar_tpu_torch.comm import ha

    srv = pcoord.CoordinatorServer(port=0)
    assert srv.ha is None
    srv.start()
    try:
        spec = f"127.0.0.1:1,{srv.host}:{srv.port}"
        assert pcoord.coordinator_request(spec, None, "peers", {"token": "t"})["info"] == []
        ha.reset_targets()
        assert pdisc.discover_endpoints(spec, "t") == []
        ha.reset_targets()
        # the arena and league routes answer as the JAX coordinator's do
        # when the process hosts no store and no service; so does telemetry
        # ingest, a malformed message refused and a JSON one folded
        jsrv = jcoord.CoordinatorServer(port=0)
        jsrv.start()
        try:
            msg = {"source": "actor:1", "ts": 1.0e9, "snapshot": {"distar_env_steps_total": 3.0}}
            for body, code in (({}, 1), (msg, 0)):
                reply = pcoord.coordinator_request(srv.host, srv.port, "telemetry", body)
                assert reply == jcoord.coordinator_request(jsrv.host, jsrv.port, "telemetry", body), reply
                assert reply["code"] == code, reply
            assert reply["info"] == 1
            for route in ("arena_next", "league_ask"):
                reply = pcoord.coordinator_request(srv.host, srv.port, route, {})
                assert reply == jcoord.coordinator_request(jsrv.host, jsrv.port, route, {}), reply
                assert reply["code"] == 1 and "no " in reply["info"], reply
            for route in ("/league/status", "/arena/ratings", "/arena/payoff"):
                for s in (srv, jsrv):
                    with pytest.raises(urllib.error.HTTPError) as err:
                        urllib.request.urlopen(f"http://{s.host}:{s.port}{route}", timeout=10)
                    assert err.value.code == 404
        finally:
            jsrv.stop()
        # a single address given in list form is one coordinator
        assert pcoord.coordinator_request(f"{srv.host}:{srv.port}", None, "peers",
                                          {"token": "t"})["info"] == []
    finally:
        srv.stop()
    with pytest.raises(CommError):
        pcoord.coordinator_request("127.0.0.1", 1, "peers", {"token": "t"}, timeout=2.0,
                                   policy=NO_RETRY)
