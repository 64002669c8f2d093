"""League and arena state pickles across the two packages.

The JAX package journals its league resume file and its arena ledger as
pickles that name ``distar_tpu.league.*`` classes. ``loads`` reads such a
pickle into the port's classes of the same names (``distar_tpu.`` module
paths map to ``distar_tpu_torch.``), so a ledger the JAX package wrote
loads here without importing it. The port's own pickles name the port's
modules, which the JAX package cannot read (ROADMAP Queue 3).
"""
from __future__ import annotations

import io
import pickle

_JAX_PACKAGE = "distar_tpu"
_PORT_PACKAGE = "distar_tpu_torch"


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
        return super().find_class(module, name)


def loads(blob: bytes):
    """``pickle.loads`` with the JAX package's module paths read as the port's."""
    return _PortUnpickler(io.BytesIO(blob)).load()
