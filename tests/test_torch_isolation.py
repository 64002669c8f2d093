"""The port stands alone: no module of distar_tpu_torch/ and neither of the
port's root scripts (chip_smoke.py, attention_variants.py, loop_gap_probe.py) imports jax,
flax, optax or anything of the JAX package distar_tpu, nor msgpack, lz4 or
websocket (websocket-client), which the GPU machine lacks (the port reads
and writes checkpoints and frames with its own codecs, and speaks to SC2
through its own websocket client, ``envs/sc2/wsclient.py``); zstandard and
tensorboardX only under an ImportError guard, as the JAX serializer and
scalar sink import them. (google.protobuf, which the SC2 stack's vendored
``_proto_gen`` needs, is on the GPU machine.)"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distar_tpu", "msgpack", "lz4", "websocket")
GUARDED = ("zstandard", "tensorboardX")  # optional: imported only inside try / except ImportError
ROOT_SCRIPTS = ("chip_smoke.py", "attention_variants.py", "loop_gap_probe.py")


def _port_files():
    out = [os.path.join(REPO, name) for name in ROOT_SCRIPTS]
    for root, _, files in os.walk(os.path.join(REPO, "distar_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _guarded_imports(tree):
    """Import nodes inside a ``try`` whose handlers catch ImportError."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                h.type is not None and "ImportError" in ast.dump(h.type) for h in node.handlers):
            for stmt in node.body:
                out.update(id(n) for n in ast.walk(stmt) if isinstance(n, (ast.Import, ast.ImportFrom)))
    return out


def _imported_modules(path, unguarded_only=False):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), filename=path)
    guarded = _guarded_imports(tree) if unguarded_only else set()
    for node in ast.walk(tree):
        if id(node) in guarded:
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_has_modules():
    files = _port_files()
    assert set(ROOT_SCRIPTS) <= set(files)
    for module in ("bin/sl_train.py", "learner/sl_learner.py", "learner/base_learner.py",
                   "learner/data.py", "losses/sl_loss.py", "parallel/optimizer.py",
                   "parallel/grad_clip.py", "ops/rl.py", "model/value.py", "losses/rl_loss.py",
                   "losses/distill_loss.py", "learner/rl_learner.py", "learner/distill_learner.py",
                   "utils/storage.py", "utils/msgpack.py", "utils/checkpoint.py", "obs/registry.py",
                   "obs/trace.py", "obs/tracestore.py", "obs/exporters.py", "resilience/policy.py",
                   "comm/serializer.py", "serve/http_frontend.py", "serve/tcp_frontend.py",
                   "serve/mux.py", "bin/serve.py", "comm/shuttle.py", "comm/shm_ring.py",
                   "comm/coordinator.py", "comm/discovery.py", "replay/sharding.py",
                   "serve/fleet/__init__.py", "serve/fleet/discovery.py", "serve/fleet/router.py",
                   "serve/fleet/rollout.py", "serve/fleet/gateway_proc.py", "utils/log.py",
                   "utils/timing.py", "resilience/supervisor.py", "learner/hooks.py",
                   "learner/prefetch.py", "learner/admin.py", "learner/sl_dataloader.py",
                   "envs/env.py", "envs/mock_env.py", "lib/stat.py", "lib/z_library.py",
                   "lib/metric.py", "actor/agent.py", "actor/env_pool.py", "actor/rollout_plane.py",
                   "actor/scripted.py", "actor/actor.py", "comm/adapter.py", "league/algorithms.py",
                   "league/stats.py", "league/payoff.py", "league/elo.py", "league/trueskill.py",
                   "league/stat_meters.py", "league/player.py", "league/league.py", "league/api.py",
                   "league/remote.py", "plugins.py", "learner/rl_dataloader.py", "bin/rl_train.py",
                   "replay/__init__.py", "replay/errors.py", "replay/store.py", "replay/spill.py",
                   "replay/local.py", "replay/client.py", "replay/server.py", "learner/replay_actor.py",
                   "bin/play.py", "envs/jaxenv/__init__.py", "envs/jaxenv/scenario.py",
                   "envs/jaxenv/core.py", "envs/jaxenv/obs.py", "envs/jaxenv/host.py",
                   "envs/jaxenv/winrate.py", "envs/jaxenv/anakin.py", "utils/pickles.py",
                   "arena/__init__.py", "arena/store.py", "arena/evaluator.py", "league/runtime/__init__.py",
                   "league/runtime/service.py", "league/runtime/reassign.py", "league/runtime/runner.py",
                   "envs/sc2/__init__.py", "envs/sc2/proto.py", "envs/sc2/wsclient.py",
                   "envs/sc2/portpicker_compat.py", "envs/sc2/protocol.py", "envs/sc2/remote_controller.py",
                   "envs/sc2/fake_sc2.py", "envs/sc2/sc_process.py", "envs/sc2/maps.py",
                   "envs/sc2/run_configs.py", "envs/sc2/replay_header.py", "envs/sc2/launcher.py",
                   "envs/sc2/lan.py", "envs/sc2/_proto_gen/sc2api_pb2.py", "envs/features.py",
                   "envs/dummy_obs.py", "envs/sc2_env.py", "envs/replay_decoder.py", "bin/gen_z.py",
                   "bin/sc2_tools.py"):
        assert os.path.join("distar_tpu_torch", module) in files
    # the data plane's native library is the port's own copy of the source
    assert os.path.exists(os.path.join(REPO, "distar_tpu_torch", "comm", "native", "shuttle.cpp"))
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_files())
def test_optional_imports_are_guarded(path):
    bad = [m for m in _imported_modules(path, unguarded_only=True) if m.split(".")[0] in GUARDED]
    assert not bad, f"{path} imports {bad} outside a try / except ImportError"
