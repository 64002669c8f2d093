"""The port's resumable downloader (``distar_tpu_torch/bin/
download_model.py``): the counterparts of tests/test_utils.py's two Range
tests, against a local HTTP server (no other host is dialed), and its CLI
writing the same bytes as the JAX downloader's."""
import http.server
import threading

import pytest

from distar_tpu.bin import download_model as jdl
from distar_tpu_torch.bin import download_model as dl


def serve(handler):
    srv = http.server.HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def range_handler(payload):
    class RangeHandler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            start = 0
            rng = self.headers.get("Range")
            if rng:
                start = int(rng.split("=")[1].rstrip("-"))
                self.send_response(206)
            else:
                self.send_response(200)
            body = payload[start:]
            self.send_header("Content-Length", str(len(payload) if not rng else len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    return RangeHandler


def test_downloader_resumes_with_range(tmp_path):
    payload = bytes(range(256)) * 40  # 10240 bytes
    srv = serve(range_handler(payload))
    try:
        out = tmp_path / "model.pth"
        out.write_bytes(payload[:3000])  # partial file on disk
        url = f"http://127.0.0.1:{srv.server_address[1]}/model.pth"
        d = dl.Downloader(url, str(out), timeout=5.0)
        assert d.total_size == len(payload)
        d.download()
        assert out.read_bytes() == payload
    finally:
        srv.shutdown()


def test_downloader_restarts_when_server_ignores_range(tmp_path):
    payload = b"x" * 5000

    class NoRangeHandler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)  # ignores Range entirely
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = serve(NoRangeHandler)
    try:
        out = tmp_path / "model.pth"
        out.write_bytes(b"y" * 1234)  # stale partial from an older attempt
        url = f"http://127.0.0.1:{srv.server_address[1]}/model.pth"
        dl.Downloader(url, str(out), timeout=5.0).download()
        assert out.read_bytes() == payload
    finally:
        srv.shutdown()


@pytest.mark.parametrize("name", ["rl_model", "sl_model.pth"])
def test_cli_writes_what_the_jax_downloader_writes(tmp_path, name, capsys):
    payload = bytes(range(256)) * 8
    srv = serve(range_handler(payload))
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/x"
        dl.main(["--name", name, "--url", url, "--out", str(tmp_path / "port.pth")])
        jdl.Downloader(url, str(tmp_path / "jax.pth"), timeout=5.0).download()
        assert (tmp_path / "port.pth").read_bytes() == (tmp_path / "jax.pth").read_bytes() == payload
        assert f"downloading {url} -> {tmp_path / 'port.pth'}" in capsys.readouterr().out
        assert dl.DEFAULT_URL == jdl.DEFAULT_URL
    finally:
        srv.shutdown()
