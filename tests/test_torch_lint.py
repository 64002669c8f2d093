"""The JAX package's lints, run over the port (``distar_tpu_torch/``).

``tools/lint_sockets.py`` (every socket has a timeout or is a listener),
``tools/lint_no_print.py`` (no bare print in library code) and
``tools/lint_metric_names.py`` (every registered metric named
``distar_<subsystem>_<name>`` and documented in docs/observability.md) scan
only the JAX package from their command lines; here they scan the port, so
its sockets and metrics stay under the same rules as it grows. The tools
are loaded from their files, as tests/test_obs_metrics.py loads them.
"""
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "distar_tpu_torch")


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("lint", ["sockets", "no_print", "metric_names"])
def test_port_passes_the_jax_packages_lint(lint):
    if lint == "sockets":
        problems = _tool("lint_sockets").find_offences(PORT)
    elif lint == "no_print":
        problems = _tool("lint_no_print").find_bare_prints(PORT)
    else:
        problems = _tool("lint_metric_names").lint(PORT, os.path.join(ROOT, "docs", "observability.md"))
    assert problems == [], problems


def test_the_metric_lint_sees_the_ports_anakin_and_env_series():
    """The lint reads the port's registrations, the Anakin loop's and the
    win-rate gauge among them (so a clean run above is not an empty scan)."""
    names = _tool("lint_metric_names").registered_names(PORT)
    assert {"distar_anakin_env_steps_per_s", "distar_anakin_batches_total", "distar_anakin_window_seconds",
            "distar_env_episodes_total", "distar_env_head2head_win_rate",
            "distar_rollout_plane_backend"} <= names


def test_the_lints_scan_the_sc2_stack():
    """The SC2 client stack and the decoder are under the same lints: the
    decoder's throughput series are registered under the JAX names, and
    the socket lint reads the port's websocket client and fake server."""
    names = _tool("lint_metric_names").registered_names(PORT)
    assert {"distar_replay_decoded_total", "distar_replay_decoded_steps_total", "distar_replay_decode_seconds",
            "distar_replay_decode_steps_per_s", "distar_replay_decode_errors_total"} <= names
    sc2 = os.path.join(PORT, "envs", "sc2")
    assert _tool("lint_sockets").find_offences(sc2) == []
    assert _tool("lint_no_print").find_bare_prints(sc2) == []
