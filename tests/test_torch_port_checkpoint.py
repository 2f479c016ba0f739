"""The port's standard-library msgpack reader against flax's, on the CPU.

Equality is exact: every key, every array's shape, dtype and bytes, and
every config value.
"""

import numpy as np
import pytest
from flax import serialization

from isp_tts_tpu.models.base import flatten_state as jax_flatten_state
from isp_tts_tpu_torch.checkpoint import load_checkpoint, msgpack_restore

CKPT = "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"


def _assert_same(a, b, path="root"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), path


def test_committed_checkpoint_reads_as_flax_reads_it():
    data = open(CKPT, "rb").read()
    ref = serialization.msgpack_restore(data)
    _assert_same(msgpack_restore(data), ref)

    ckpt = load_checkpoint(CKPT)
    _assert_same(ckpt["model"]["config"], ref["model"]["config"])
    flat_ref = jax_flatten_state(ref["model"]["state"])
    assert sorted(ckpt["model"]["state"]) == sorted(flat_ref)
    for key, arr in flat_ref.items():
        _assert_same(ckpt["model"]["state"][key], arr, key)


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64", "int8", "int32",
                                   "int64", "uint8", "bool"])
def test_every_msgpack_type_flax_writes(dtype):
    """Every msgpack width the encoder can choose, and flax's extension types."""
    rng = np.random.RandomState(0)
    doc = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "flags": [True, False, None],
        "strs": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000],
        "bins": [b"", b"\x00" * 300, b"\x01" * 70000],
        "nested": {str(i): {"x": i} for i in range(20)},
        "array": (rng.randn(3, 4, 5) * 10).astype(dtype),
        "empty": np.zeros((0, 3), dtype),
        "scalar": np.asarray(3, dtype)[()],
        "complex": 1.5 - 2j,
        "long_list": list(range(70000)),
    }
    data = serialization.msgpack_serialize(doc)
    _assert_same(msgpack_restore(data), serialization.msgpack_restore(data))


def test_bfloat16_arrays_widen_to_float32_exactly():
    import jax.numpy as jnp

    arr = np.asarray(jnp.asarray(np.linspace(-3, 3, 24).reshape(2, 12), jnp.bfloat16))
    data = serialization.msgpack_serialize({"w": arr})
    out = msgpack_restore(data)["w"]
    assert out.dtype == np.float32 and out.shape == (2, 12)
    np.testing.assert_array_equal(out, arr.astype(np.float32))


def test_truncated_document_raises():
    data = serialization.msgpack_serialize({"w": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        msgpack_restore(data[:-3])
