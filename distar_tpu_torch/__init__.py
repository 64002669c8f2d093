"""PyTorch/CUDA port of ``distar_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``distar_tpu``'s module names (``lib``, ``utils``,
``ops``, ``model``, ``actor``, ``serve``) so each module's counterpart is
found by name. It imports torch and numpy only; the three Pallas kernels of
the JAX package are hand-written CUDA C++ under ``ops/csrc`` and built at
first use (``ops/build.py``).
"""
