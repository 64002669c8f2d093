"""The port stands alone: no module of distar_tpu_torch/ and neither of the
port's root scripts (chip_smoke.py, attention_variants.py) imports jax,
flax, optax or anything of the JAX package distar_tpu."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distar_tpu")
ROOT_SCRIPTS = ("chip_smoke.py", "attention_variants.py")


def _port_files():
    out = [os.path.join(REPO, name) for name in ROOT_SCRIPTS]
    for root, _, files in os.walk(os.path.join(REPO, "distar_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _imported_modules(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), filename=path)
    for node in ast.walk(tree):
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
                   "losses/distill_loss.py", "learner/rl_learner.py", "learner/distill_learner.py"):
        assert os.path.join("distar_tpu_torch", module) in files
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
