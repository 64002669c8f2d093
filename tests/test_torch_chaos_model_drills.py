"""The port's drills and tools that run a model, on the CPU: ``chaos
dynamics-drill``, ``arena-drill`` and ``multichip-drill`` (the port's
executor as gloo ranks) at small sizes, each a process whose verdict JSON
(the line before the last) is held as the JAX tests hold theirs
(tests/test_parallel_exec.py's multichip drill), and ``dynamics_overhead
--small``, whose summary carries the JAX artifact's keys. Each takes
``--device``: CUDA by default, refused without CUDA unless ``cpu``. The
full-size multichip drill the JAX suite marks ``slow`` is marked ``slow``
here too.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(module, *argv, timeout=600, tmp_path=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if tmp_path is not None:
        env["DISTAR_EXPERIMENTS_ROOT"] = str(tmp_path / "expr")
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=timeout, env=env)
    return out.returncode, out.stdout, out.stdout[-3000:] + out.stderr[-3000:]


def verdict_of(stdout):
    return json.loads(stdout.strip().splitlines()[-2])


def test_dynamics_drill_small(tmp_path):
    rc, out, log = run("distar_tpu_torch.tools.chaos", "dynamics-drill", "--dir", str(tmp_path),
                       "--pre-steps", "2", "--post-steps", "1", "--device", "cpu")
    assert rc == 0, log
    verdict = verdict_of(out)
    assert verdict["failures"] == [] and verdict["module"] == "core_lstm"
    assert verdict["provenance"]["origin"] == "params" and verdict["provenance"]["module"] == "core_lstm"
    assert verdict["anomaly_rule_fired_count"] == 1 and len(verdict["bundles"]) == 1
    assert verdict["exemplar_trace_id"] == f"blackbox:{verdict['bundles'][0]}"
    assert verdict["replay"]["deterministic"] and verdict["replay"]["nonfinite_reproduced"]
    assert verdict["replay"]["device"] == "cpu"


def test_arena_drill_small(tmp_path):
    rc, out, log = run("distar_tpu_torch.tools.chaos", "arena-drill", "--dir", str(tmp_path), "--batches", "3",
                       "--episodes", "2", "--device", "cpu")
    assert rc == 0, log
    verdict = verdict_of(out)
    assert verdict["failures"] == [] and verdict["matches_applied"] == 3 * 2
    assert verdict["replayed_ack_deduped"] is True


def test_multichip_drill_on_gloo_ranks(tmp_path):
    """Killed after a sharded save on dp=2, resumed on fsdp=2, finished
    unassisted (the JAX drill's dp=4,fsdp=2 -> dp=8 at two ranks)."""
    rc, out, log = run("distar_tpu_torch.tools.chaos", "multichip-drill", "--dir", str(tmp_path),
                       "--mesh", "dp=2", "--resume-mesh", "fsdp=2", "--host-devices", "2", "--iters", "2",
                       "--kill-after", "1", "--device", "cpu", tmp_path=tmp_path)
    assert rc == 0, log
    assert "finished unassisted" in out
    verdict = verdict_of(out)
    assert verdict["final_iters"] == 2 and verdict["resume_start_iter"] >= 1
    assert verdict["mesh_resumed"]["fsdp"] == 2 and verdict["resumed_from"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
@pytest.mark.parametrize("argv", [
    ["distar_tpu_torch.tools.chaos", "dynamics-drill", "--dir", "{d}"],
    ["distar_tpu_torch.tools.chaos", "arena-drill", "--dir", "{d}"],
    ["distar_tpu_torch.tools.chaos", "multichip-drill", "--dir", "{d}", "--host-devices", "0"],
    ["distar_tpu_torch.tools.dynamics_overhead", "--small", "--iterations", "1"],
], ids=["dynamics", "arena", "multichip", "dynamics_overhead"])
def test_model_drills_refuse_without_cuda_unless_cpu(tmp_path, argv):
    rc, out, log = run(*[a.format(d=tmp_path) for a in argv], timeout=120)
    assert rc != 0 and "CUDA is not available" in log
    assert "verdict:" not in out


def test_multichip_drill_refuses_gloo_ranks_on_the_card(tmp_path):
    rc, out, log = run("distar_tpu_torch.tools.chaos", "multichip-drill", "--dir", str(tmp_path),
                       "--host-devices", "2", timeout=120)
    assert rc != 0 and "--host-devices runs gloo ranks on the CPU" in log


def test_dynamics_overhead_small_writes_the_jax_artifact_keys(tmp_path):
    artifact = tmp_path / "dyn.json"
    rc, out, log = run("distar_tpu_torch.tools.dynamics_overhead", "--small", "--iterations", "2",
                       "--device", "cpu", "--artifact", str(artifact), tmp_path=tmp_path)
    assert rc in (0, 1), log  # 1: outside the 5% envelope, which a loaded CPU may read
    lines = [json.loads(ln) for ln in artifact.read_text().splitlines()]
    summary = lines[-1]
    with open(os.path.join(REPO, "DYNAMICS_r16.json")) as f:
        jax_keys = set(json.loads(f.read().splitlines()[-1]))
    assert set(summary) == jax_keys
    assert summary["device"] == "cpu" and summary["small_model"] is True and summary["iterations"] == 2
    assert summary["within_envelope"] == (rc == 0)
    arms = [ln for ln in lines[:-1] if ln["metric"] == "dynamics overhead arm"]
    assert [a["case"] for a in arms] == ["dynamics_on", "dynamics_off"] * 2
    assert all(a["step_s"] > 0 for a in arms)


@pytest.mark.slow
def test_chaos_multichip_drill(tmp_path):
    """The JAX drill's shape: killed after a sharded save on dp=4,fsdp=2,
    resumed on dp=8, as eight gloo ranks."""
    rc, out, log = run("distar_tpu_torch.tools.chaos", "multichip-drill", "--dir", str(tmp_path), "--iters", "4",
                       "--kill-after", "2", "--device", "cpu", timeout=1800, tmp_path=tmp_path)
    assert rc == 0, log
    assert "finished unassisted" in out
