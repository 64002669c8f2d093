"""The port's storage seam (``distar_tpu_torch/utils/storage.py``): the
counterparts of tests/test_storage.py's seven tests on the port's modules
(scheme routing, the atomic local write, the ``mem://`` blob store, the
registered-backend hook with JAX's ``ValueError`` for an unregistered
scheme, the ``gs://`` stub's ``RuntimeError`` guidance, and checkpoints and
payloads riding the seam), then the two packages' errors side by side.
"""
import os

import numpy as np
import pytest

from distar_tpu.utils import storage as jstorage
from distar_tpu_torch.comm.serializer import load_payload, save_payload
from distar_tpu_torch.utils import storage
from distar_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def test_local_roundtrip_atomic(tmp_path):
    path = str(tmp_path / "sub" / "blob.bin")
    storage.write_bytes(path, b"abc")  # creates parent dirs
    assert storage.read_bytes(path) == b"abc"
    assert storage.exists(path)
    assert not [f for f in os.listdir(tmp_path / "sub") if ".tmp." in f]
    storage.write_bytes(path, b"xyz")  # overwrite is atomic replace
    assert storage.read_bytes(path) == b"xyz"
    storage.delete(path)
    assert not storage.exists(path)


def test_file_scheme_is_local(tmp_path):
    path = str(tmp_path / "x.bin")
    storage.write_bytes(f"file://{path}", b"1")
    assert storage.read_bytes(path) == b"1"


def test_mem_backend_roundtrip():
    storage.write_bytes("mem://bucket/a", b"payload")
    assert storage.exists("mem://bucket/a")
    assert storage.read_bytes("mem://bucket/a") == b"payload"
    backend, _ = storage.resolve("mem://bucket/a")
    assert list(backend.list("bucket/")) == ["bucket/a"]
    storage.delete("mem://bucket/a")
    assert not storage.exists("mem://bucket/a")
    with pytest.raises(FileNotFoundError):
        storage.read_bytes("mem://bucket/a")


def test_unknown_scheme_and_custom_registration():
    with pytest.raises(ValueError, match="no storage backend"):
        storage.read_bytes("s3://bucket/key")
    storage.register_backend("s3", storage.MemBackend())
    try:
        storage.write_bytes("s3://bucket/key", b"ok")
        assert storage.read_bytes("s3://bucket/key") == b"ok"
        storage.write_many([("s3://bucket/k2", b"two"), ("mem://bucket/k3", b"three")])
        assert storage.read_bytes("s3://bucket/k2") == b"two"
        assert storage.read_bytes("mem://bucket/k3") == b"three"
    finally:
        del storage._BACKENDS["s3"]
        storage.delete("mem://bucket/k3")


def test_gcs_stub_raises_with_guidance():
    with pytest.raises(RuntimeError, match="google-cloud-storage"):
        storage.read_bytes("gs://bucket/ckpt")


def test_checkpoint_rides_backends():
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": 7}
    save_checkpoint("mem://ckpts/it1", state, metadata={"iter": 1})
    out = load_checkpoint("mem://ckpts/it1")
    np.testing.assert_array_equal(out["state"]["w"], state["w"])
    assert out["metadata"]["iter"] == 1


def test_payload_rides_backends():
    obj = {"traj": np.ones((4, 5), np.float16), "meta": [1, 2, 3]}
    save_payload("mem://payloads/t0", obj)
    back = load_payload("mem://payloads/t0")
    np.testing.assert_array_equal(back["traj"], obj["traj"])
    assert back["meta"] == [1, 2, 3]


@pytest.mark.parametrize("path,error", [("s3://b/k", ValueError), ("gs://b/k", RuntimeError),
                                        ("mem://no/such", FileNotFoundError)])
def test_errors_equal_jax(path, error):
    """Each scheme's failure is the JAX package's: the same type, the same
    message."""
    said = []
    for lib in (storage, jstorage):
        with pytest.raises(error) as e:
            lib.read_bytes(path)
        said.append(str(e.value))
    assert said[0] == said[1]
