"""Resumable pretrained-model downloader.

    python -m distar_tpu_torch.bin.download_model --name rl_model [--out PATH] [--url URL]

Counterpart of ``distar_tpu.bin.download_model``: fetches a released model
by name from the DI-star HuggingFace repo (``DEFAULT_URL``), resuming a
partial file with HTTP Range requests (a server that ignores Range answers
200, and the file starts over), with a console progress line. Stdlib urllib
only. A downloaded ``.pth`` plays through ``bin/play.py --model1 x.pth``
(``model.ref_convert.convert_model``, then the port's weight bridge).
"""
from __future__ import annotations

import argparse
import os
import ssl
import sys
import time
import urllib.error
import urllib.request

DEFAULT_URL = (
    "https://huggingface.co/OpenDILabCommunity/DI-star/resolve/main/"
    "{name}?download=true"
)


class Downloader:
    def __init__(self, url: str, file_path: str, timeout: float = 60.0,
                 max_retries: int = 5):
        self.url = url
        self.file_path = file_path
        self.timeout = timeout
        self.max_retries = max_retries
        self._ctx = ssl.create_default_context()
        self.total_size = self._head_total_size()

    def _open(self, headers=None, method="GET"):
        req = urllib.request.Request(self.url, headers=headers or {}, method=method)
        return urllib.request.urlopen(req, timeout=self.timeout, context=self._ctx)

    def _head_total_size(self) -> int:
        try:
            with self._open(method="HEAD") as r:
                if r.status == 200:
                    return int(r.headers.get("Content-Length", 0))
        except urllib.error.HTTPError:
            pass  # server without HEAD support: fall through to GET
        with self._open() as r:
            if r.status != 200:
                raise ConnectionError(f"cannot connect {self.url} ({r.status})")
            return int(r.headers.get("Content-Length", 0))

    def _progress(self, done_bytes: int) -> None:
        if self.total_size <= 0:
            sys.stdout.write(f"\r{done_bytes // 1000} kB")
        else:
            done = int(50 * done_bytes / self.total_size)
            sys.stdout.write(
                "\r[%s%s] %d kB / %d kB "
                % ("#" * done, " " * (50 - done), done_bytes // 1000,
                   self.total_size // 1000)
            )
        sys.stdout.flush()

    def download(self) -> str:
        """Fetch with Range-resume; retries continue from what's on disk."""
        for attempt in range(self.max_retries):
            temp_size = (
                os.path.getsize(self.file_path) if os.path.exists(self.file_path) else 0
            )
            if self.total_size and temp_size >= self.total_size:
                break
            try:
                with self._open(
                    {"Range": f"bytes={temp_size}-"} if temp_size else {}
                ) as r:
                    if temp_size and r.status != 206:
                        # server ignored the Range header: appending the full
                        # body would corrupt the partial file — start over
                        temp_size = 0
                    with open(self.file_path, "ab" if temp_size else "wb") as f:
                        while True:
                            chunk = r.read(1 << 16)
                            if not chunk:
                                break
                            temp_size += len(chunk)
                            f.write(chunk)
                            self._progress(temp_size)
            except (urllib.error.URLError, OSError) as e:
                if attempt == self.max_retries - 1:
                    raise
                wait = 2.0 * (attempt + 1)
                print(f"\ndownload interrupted ({e!r}); retrying in {wait:.0f}s")
                time.sleep(wait)
            else:
                if not self.total_size or temp_size >= self.total_size:
                    break
        print()
        return self.file_path


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--name", required=True,
                   help="released model name, e.g. rl_model or sl_model")
    p.add_argument("--out", default="",
                   help="output path (default: ./<name>.pth)")
    p.add_argument("--url", default="",
                   help="override the download URL entirely")
    args = p.parse_args(argv)

    model_name = args.name if args.name.endswith(".pth") else args.name + ".pth"
    url = args.url or DEFAULT_URL.format(name=model_name)
    path = args.out or os.path.join(os.getcwd(), model_name)
    print(f"downloading {url} -> {path}")
    Downloader(url, path, timeout=60.0).download()


if __name__ == "__main__":
    main()
