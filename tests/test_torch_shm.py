"""The port's shared-memory rings (``comm/shm_ring.py``) through the cases
of ``tests/test_shm_ring.py``, and against the JAX package's: round trip,
wraparound, a frame too large refused typed, CRC corruption, a full ring
that resumes, writer and reader death seen across processes, a spoofed
host and a hostile hello, a ring fault that falls back to the TCP leg with
nothing lost, rings unlinked on close; then each package's ``ServeClient``
over shm to the other's ``ServeTCPServer``. Every wait has its own time
limit."""
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from distar_tpu import serve as jserve
from distar_tpu.comm import shm_ring as jshm
from distar_tpu_torch import serve as pserve
from distar_tpu_torch.comm import shm_ring
from distar_tpu_torch.comm.serializer import recv_msg, send_msg
from distar_tpu_torch.obs import get_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mint(capacity=1 << 16):
    server, fields = shm_ring.mint_ring_pair(capacity, op="test")
    client = shm_ring.attach_ring_pair(fields, op="test")
    return server, client, fields


def _fallbacks():
    return sum(v for k, v in get_registry().snapshot().items()
               if k.startswith("distar_shm_fallbacks_total"))


# ------------------------------------------------------------- ring basics
def test_roundtrip_preserves_numpy_payloads():
    server, client, _ = _mint(1 << 20)
    try:
        payload = {"obs": np.arange(5000, dtype=np.float32), "mask": np.ones((7, 3), dtype=bool), "n": 42}
        client.send(payload)
        got = server.recv(timeout_s=5.0)
        assert got["n"] == 42
        np.testing.assert_array_equal(got["obs"], payload["obs"])
        np.testing.assert_array_equal(got["mask"], payload["mask"])
        server.send({"code": 0})
        assert client.recv(timeout_s=5.0) == {"code": 0}
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("minter", ["port", "jax"])
def test_rings_of_one_package_attach_to_the_other(minter):
    """One ring layout: each package attaches the other's segments and the
    frames cross both ways."""
    mint, attach = ((shm_ring.mint_ring_pair, jshm.attach_ring_pair) if minter == "port"
                    else (jshm.mint_ring_pair, shm_ring.attach_ring_pair))
    server, fields = mint(1 << 16, op="x")
    client = attach(fields, op="x")
    try:
        assert client.request.__self__ is client
        client.send({"q": np.arange(300)})
        assert server.recv(timeout_s=5.0)["q"][-1] == 299
        server.send(b"pong" * 1000)
        assert client.recv(timeout_s=5.0) == b"pong" * 1000
    finally:
        client.close()
        server.close()


def test_wraparound_many_frames_through_small_ring():
    """Hundreds of odd-sized frames through a 4 KiB ring: every frame
    crosses the wrap point at some time and every byte survives."""
    server, client, _ = _mint(4096)
    done = []

    def echo():
        for _ in range(300):
            server.send(server.recv(timeout_s=10.0))
        done.append(True)

    t = threading.Thread(target=echo, daemon=True)
    t.start()
    try:
        for i in range(300):
            blob = bytes([i % 256]) * ((i * 37) % 1800 + 1)
            assert client.request(blob, timeout_s=10.0) == blob
        t.join(10.0)
        assert done
    finally:
        client.close()
        server.close()


def test_frame_larger_than_ring_rejected_typed_at_send():
    server, client, _ = _mint(4096)
    try:
        with pytest.raises(shm_ring.ShmFrameTooLargeError):
            client.send(b"z" * 8192)
        client.send(b"ok")  # nothing of the oversized frame was published
        assert server.recv(timeout_s=5.0) == b"ok"
    finally:
        client.close()
        server.close()


def test_crc_corruption_detected_typed():
    server, client, _ = _mint(4096)
    try:
        client.send(b"a" * 3800)
        buf = server._rx_ring.buf  # the client's published frame, in place
        for off in (200, 1200, 3000):
            buf[shm_ring.HEADER_SIZE + off] ^= 0x40
        with pytest.raises(shm_ring.ShmCorruptError):
            server.recv(timeout_s=2.0)
    finally:
        client.close()
        server.close()


def test_doorbell_wakes_a_blocked_reader_inside_a_slice():
    server, client, _ = _mint()
    woke = {}

    def reader():
        server.recv(timeout_s=10.0)
        woke["t"] = time.monotonic()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        time.sleep(0.3)  # the reader is parked past its first checks
        t0 = time.monotonic()
        client.send(b"ding")
        t.join(5.0)
        assert "t" in woke and woke["t"] - t0 < shm_ring.Doorbell.SLICE_S
    finally:
        client.close()
        server.close()


def test_ring_full_writer_blocks_then_resumes():
    server, client, _ = _mint(4096)
    try:
        client.send(b"x" * 3000)
        result = {}
        before = get_registry().snapshot().get("distar_shm_ring_full_wait_seconds_count", 0.0)

        def write_second():
            client.send(b"y" * 3000)  # cannot fit until the reader drains
            result["sent"] = True

        t = threading.Thread(target=write_second, daemon=True)
        t.start()
        time.sleep(0.15)
        assert "sent" not in result
        assert server.recv(timeout_s=5.0) == b"x" * 3000
        t.join(5.0)
        assert result.get("sent")
        assert server.recv(timeout_s=5.0) == b"y" * 3000
        assert get_registry().snapshot()["distar_shm_ring_full_wait_seconds_count"] >= before + 1
    finally:
        client.close()
        server.close()


# -------------------------------------------------------------- liveness
def test_writer_death_seen_from_the_reader_across_processes():
    """A subprocess attaches by name, echoes a frame, then dies without
    closing (``os._exit``): the reader sees the dead writer typed within
    the heartbeat window."""
    server, fields = shm_ring.mint_ring_pair(1 << 20, op="xp")
    child = textwrap.dedent(f"""
        import os, time
        from distar_tpu_torch.comm import shm_ring
        peer = shm_ring.attach_ring_pair({fields!r}, op="xp")
        req = peer.recv(timeout_s=15)
        peer.send({{"echo": req}})
        time.sleep(0.2)
        os._exit(9)  # no close, no atexit; the beat thread dies with us
    """)
    proc = subprocess.Popen([sys.executable, "-c", child], cwd=REPO)
    try:
        server.send({"n": 7}, timeout_s=10.0)
        assert server.recv(timeout_s=10.0) == {"echo": {"n": 7}}
        proc.wait(timeout=15)
        t0 = time.monotonic()
        with pytest.raises(shm_ring.ShmPeerDeadError):
            server.recv(timeout_s=10.0)
        assert time.monotonic() - t0 < 2 * shm_ring.DEFAULT_HEARTBEAT_WINDOW_S
    finally:
        proc.kill()
        proc.wait(timeout=10)
        server.close()


def test_reader_death_seen_from_the_writer():
    server, client, _ = _mint(4096)
    try:
        server.close()
        with pytest.raises(shm_ring.ShmPeerDeadError):
            for _ in range(10):  # blocks for space, then sees the closed reader
                client.send(b"z" * 3000, timeout_s=5.0)
    finally:
        client.close()


# ------------------------------------------------------------ negotiation
def test_spoofed_host_never_gets_rings():
    assert shm_ring.host_identity() == jshm.host_identity()
    reply, peer = shm_ring.negotiate_server(
        {"transports": ["shm", "tcp"], "host": "spoofed-host|not-our-boot-id"}, transport="auto")
    assert reply == {"transport": "tcp"} and peer is None
    reply, peer = shm_ring.negotiate_server(
        {"transports": ["shm", "tcp"], "host": shm_ring.host_identity()}, transport="tcp")
    assert reply == {"transport": "tcp"} and peer is None
    reply, peer = shm_ring.negotiate_server(
        {"transports": ["shm", "tcp"], "host": shm_ring.host_identity()}, transport="auto")
    try:
        assert reply["transport"] == "shm" and peer is not None
    finally:
        peer.close()


def _mock_stack(lib="port", **server):
    serve = pserve if lib == "port" else jserve
    gw = serve.InferenceGateway(serve.MockModelEngine(4, params={"version": "v1", "bias": 0.0}),
                                max_delay_s=0.002).start()
    gw.load_version("v1", params={"version": "v1", "bias": 0.0}, activate=True)
    return gw, serve.ServeTCPServer(gw, port=0, **server).start()


def _stop(gw, srv):
    srv.stop()
    gw.drain_and_stop(2.0)


def test_spoofed_host_over_a_live_server_stays_tcp():
    gw, srv = _mock_stack()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=5) as s:
            send_msg(s, {"op": "hello", "transports": ["shm", "tcp"], "host": "evil-host|some-boot-id"})
            resp = recv_msg(s)
        assert resp == {"code": 0, "transport": "tcp"}
    finally:
        _stop(gw, srv)


def test_no_shared_memory_on_the_host_negotiates_tcp(monkeypatch):
    monkeypatch.setattr(shm_ring, "_sm", None)
    assert shm_ring.offer_transports("auto") == ["tcp"]
    reply, peer = shm_ring.negotiate_server(
        {"transports": ["shm", "tcp"], "host": shm_ring.host_identity()}, transport="auto")
    assert reply == {"transport": "tcp"} and peer is None
    gw, srv = _mock_stack()
    try:
        c = pserve.ServeClient(srv.host, srv.port)
        assert c.transport_active == "tcp" and c.act("s", {"x": np.ones(2)})["step"] == 1
        c.close()
    finally:
        _stop(gw, srv)


@pytest.mark.parametrize("hello", [{"op": "hello", "transports": ["carrier-pigeon", "morse"]},
                                   {"op": "hello", "codecs": ["rot13", "base64"]}],
                         ids=["transports", "codecs"])
def test_hostile_hello_nacked_typed(hello):
    gw, srv = _mock_stack()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=5) as s:
            send_msg(s, hello)
            resp = recv_msg(s)
            assert resp["code"] == "bad_hello" and s.recv(1) == b""
        assert shm_ring.hello_nack(hello) == jshm.hello_nack(hello)
        # a recognized but unavailable codec degrades, not a NACK
        assert shm_ring.hello_nack({"codecs": ["zstd"]}) is None
    finally:
        _stop(gw, srv)


def test_ring_fault_falls_back_to_the_tcp_leg_with_zero_loss():
    """Only the ring service dies (the TCP leg lives): the client's next
    call completes over TCP on the same connection, counted, executed
    exactly once."""
    gw, srv = _mock_stack()
    try:
        c = pserve.ServeClient(srv.host, srv.port, timeout_s=10.0)
        assert c.act("s", {"x": np.ones(2)})["step"] == 1 and c.transport_active == "shm"
        before = _fallbacks()
        for svc in list(srv._ring_services):  # the injected ring fault
            svc.stop()
        assert c.act("s", {"x": np.ones(2)})["step"] == 2  # not lost, not run twice
        assert c.transport_active == "tcp" and _fallbacks() == before + 1
        c.close()
    finally:
        _stop(gw, srv)


def test_frame_larger_than_the_ring_goes_over_tcp():
    gw, srv = _mock_stack(ring_bytes=4096)
    try:
        c = pserve.ServeClient(srv.host, srv.port, timeout_s=10.0)
        assert c.transport_active == "shm"
        before = _fallbacks()
        out = c.act("s", {"x": np.ones(4000)})  # about 32 KB: past the 4 KiB ring
        assert float(out["action"]) == 4000.0 and out["step"] == 1
        assert c.transport_active == "tcp" and _fallbacks() == before + 1
        c.close()
    finally:
        _stop(gw, srv)


# ------------------------------------------------------------- lifecycle
def test_rings_unlinked_on_close_and_by_unlink_all():
    server, client, fields = _mint()
    names = [fields["shm_c2s"], fields["shm_s2c"]]
    client.close()
    server.close()
    for name in names:
        with pytest.raises(shm_ring.ShmError):
            shm_ring.ShmRing.attach(name)
    server2, fields2 = shm_ring.mint_ring_pair(1 << 16, op="exit")
    assert shm_ring.unlink_all() >= 2  # what atexit runs
    for name in (fields2["shm_c2s"], fields2["shm_s2c"]):
        with pytest.raises(shm_ring.ShmError):
            shm_ring.ShmRing.attach(name)
    server2.close()  # idempotent on unlinked rings


def test_connection_teardown_unlinks_its_rings():
    gw, srv = _mock_stack()
    try:
        c = pserve.ServeClient(srv.host, srv.port)
        names = c._shm.names
        assert gw.status()["transports"] == {"tcp": 0, "shm": 1}
        c.close()
        deadline = time.monotonic() + 10
        while gw.status()["transports"]["shm"] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert gw.status()["transports"] == {"tcp": 0, "shm": 0}
        for name in names:
            with pytest.raises(shm_ring.ShmError):
                shm_ring.ShmRing.attach(name)
    finally:
        _stop(gw, srv)


# ------------------------------------------------------------- interop
@pytest.mark.parametrize("server_lib, client_lib", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_serve_client_over_shm_across_packages(server_lib, client_lib):
    gw, srv = _mock_stack(server_lib)
    client_serve = pserve if client_lib == "port" else jserve
    try:
        c = client_serve.ServeClient(srv.host, srv.port, timeout_s=10.0)
        assert c.transport_active == "shm"
        out = c.act("s1", {"x": np.ones((4,), np.float32)})
        assert float(out["action"]) == 4.0 and out["version"] == "v1"
        results = c.act_many([{"session_id": "s1", "obs": {"x": np.ones(3, np.float32)}},
                              {"session_id": "s2", "obs": {"x": np.zeros(2, np.float32)}}])
        assert [r["step"] for r in results] == [2, 1]
        assert c.status()["transports"] == {"tcp": 0, "shm": 1} == gw.status()["transports"]
        tcp_client = client_serve.ServeClient(srv.host, srv.port, transport="tcp")
        assert tcp_client.transport_active == "tcp" and tcp_client.ping()
        assert gw.status()["transports"] == {"tcp": 1, "shm": 1}
        tcp_client.close()
        c.close()
    finally:
        _stop(gw, srv)
