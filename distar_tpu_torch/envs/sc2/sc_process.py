"""Launch the SC2 binary and set up its websocket endpoint.

Counterpart of ``distar_tpu.envs.sc2.sc_process``.

Role parity with the reference StarcraftProcess (reference: distar/pysc2/
lib/sc_process.py:49-234): build the command line (-listen/-port/-dataDir/
-tempDir/-dataVersion), pick a free port, launch detached, connect a
RemoteController with boot-aware retries, and clean up (terminate -> kill,
temp dir removal, port return) on close.
"""
from __future__ import annotations

import logging
import os
import platform as _platform
import shutil
import subprocess
import tempfile
import time
from typing import Optional

from . import portpicker_compat as portpicker
from . import remote_controller

# the role of the reference's --sc2_port flag: connect to an already-running
# instance instead of launching one
FIXED_PORT = os.environ.get("DISTAR_SC2_PORT")


class SC2LaunchError(Exception):
    pass


class StarcraftProcess:
    """Launch an SC2 server, initialize a controller, clean up on close.

    Best used via run_configs (which resolves version and paths) and as a
    context manager — otherwise temp files and SC2 processes leak.
    """

    def __init__(self, run_config, exec_path, version, full_screen=False,
                 extra_args=None, verbose=False, host=None, port=None,
                 connect=True, timeout_seconds=None, window_size=(640, 480),
                 window_loc=(50, 50), **kwargs):
        self._proc = None
        self._controller = None
        self._check_exists(exec_path)
        self._tmp_dir = tempfile.mkdtemp(prefix="sc-", dir=run_config.tmp_dir)
        self._host = host or "127.0.0.1"
        self._port = int(FIXED_PORT) if FIXED_PORT else (port or portpicker.pick_unused_port())
        self._version = version

        args = [
            exec_path,
            "-listen", self._host,
            "-port", str(self._port),
            "-dataDir", os.path.join(run_config.data_dir, ""),
            "-tempDir", os.path.join(self._tmp_dir, ""),
        ]
        if ":" in self._host:
            args += ["-ipv6"]
        if _platform.system() != "Linux":
            if full_screen:
                args += ["-displayMode", "1"]
            else:
                args += [
                    "-displayMode", "0",
                    "-windowwidth", str(window_size[0]),
                    "-windowheight", str(window_size[1]),
                    "-windowx", str(window_loc[0]),
                    "-windowy", str(window_loc[1]),
                ]
        if verbose or os.environ.get("DISTAR_SC2_VERBOSE"):
            args += ["-verbose"]
        if self._version and self._version.data_version:
            args += ["-dataVersion", self._version.data_version.upper()]
        if extra_args:
            args += extra_args

        logging.info("Launching SC2: %s", " ".join(args))
        try:
            if not FIXED_PORT:
                self._proc = self._launch(run_config, args, **kwargs)
            if connect:
                self._controller = remote_controller.RemoteController(
                    self._host, self._port, self, timeout_seconds=timeout_seconds
                )
        except Exception:
            self.close()
            raise

    def close(self) -> None:
        """Shut down the game and clean up."""
        if hasattr(self, "_controller") and self._controller:
            self._controller.quit()
            self._controller.close()
            self._controller = None
        self._shutdown()
        if hasattr(self, "_port") and self._port:
            if not FIXED_PORT:
                portpicker.return_port(self._port)
            self._port = None
        if hasattr(self, "_tmp_dir") and os.path.exists(self._tmp_dir):
            shutil.rmtree(self._tmp_dir, ignore_errors=True)

    @property
    def controller(self):
        return self._controller

    @property
    def host(self):
        return self._host

    @property
    def port(self):
        return self._port

    @property
    def version(self):
        return self._version

    def __enter__(self):
        return self.controller

    def __exit__(self, exc_type, exc_value, tb):
        self.close()

    def __del__(self):
        self.close()

    def _check_exists(self, exec_path: str) -> None:
        if not os.path.isfile(exec_path):
            raise RuntimeError(f"Trying to run '{exec_path}', but it doesn't exist")
        if not os.access(exec_path, os.X_OK):
            raise RuntimeError(f"Trying to run '{exec_path}', but it isn't executable.")

    def _launch(self, run_config, args, **kwargs):
        del kwargs
        try:
            return subprocess.Popen(
                args,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                cwd=run_config.cwd,
                env=run_config.env,
            )
        except OSError:
            logging.exception("Failed to launch")
            raise SC2LaunchError(f"Failed to launch: {args}")

    def _shutdown(self) -> None:
        if self._proc:
            ret = _shutdown_proc(self._proc, 3)
            logging.info("Shutdown with return code: %s", ret)
            self._proc = None

    @property
    def running(self) -> bool:
        if FIXED_PORT:
            return True
        return bool(self._proc) and self._proc.poll() is None

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self.running else None


def _shutdown_proc(p, timeout: int):
    """Terminate politely, then kill after ``timeout`` seconds."""
    freq = 10
    for _ in range(1 + timeout * freq):
        p.terminate()
        ret = p.poll()
        if ret is not None:
            logging.info("Shutdown gracefully.")
            return ret
        time.sleep(1 / freq)
    logging.warning("Killing the process.")
    p.kill()
    return p.wait()
