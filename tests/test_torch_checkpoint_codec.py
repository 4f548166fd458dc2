"""The port's flax msgpack codec (``ntxent_tpu_torch.utils.msgpack``)
against flax's own on the CPU.

The port imports neither flax nor msgpack; these tests hold its bytes to
``flax.serialization.to_bytes`` and ``msgpack_serialize`` byte for byte on
the same numpy trees (fp32, bf16, integer, 0-d and scalar leaves, every
msgpack length class, a chunked leaf), and each package's decoder to the
other's bytes. Equality is exact: the format has no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fs

from ntxent_tpu_torch.utils import msgpack

torch.set_num_threads(1)  # see test_torch_training.py


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "step": np.array(7, np.int32),
        "params": {
            "dense": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                      "bias": rng.normal(size=(3,)).astype(np.float32)},
            "emb": np.asarray(jnp.asarray(rng.normal(size=(4, 6)),
                                          jnp.bfloat16)),
            "ids": np.arange(-3, 300, dtype=np.int64),
            "half": np.ones((2, 2), np.float16),
            "bytes8": np.zeros((300,), np.uint8),
        },
        "opt_state": {"0": {"inner_state": {}},
                      "2": {"count": np.array(2**31 - 1, np.int32)}},
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-(2**40)),
                    "flag": np.bool_(True)},
        "plain": {"none": None, "true": True, "false": False,
                  "ints": {str(v): v for v in (0, 127, 128, 255, 256, 65535,
                                               65536, 2**32, -1, -32, -33,
                                               -128, -129, -32769,
                                               -(2**31) - 1)},
                  "float": 1.25, "text": "x" * 40, "long": "y" * 300,
                  "blob": b"\x00\x01" * 200},
        "wide": {str(i): i for i in range(20)},  # a map16 header
        "zero_d": np.array(3.0, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "strided": rng.normal(size=(4, 6)).astype(np.float32).T,
    }


def test_bytes_equal_flax_to_bytes():
    tree = _tree()
    assert msgpack.to_bytes(tree) == fs.to_bytes(tree)
    # flax's msgpack_serialize sorts dict keys (a pytree map) first
    want = fs.msgpack_serialize(tree)
    assert msgpack.to_bytes(_sorted(tree)) == want


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def test_torch_leaves_encode_as_their_numpy_arrays():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = np.asarray(jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16))
    tree_np = {"w": w, "b": b}
    tree_t = {"w": torch.from_numpy(w),
              "b": torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)}
    assert msgpack.to_bytes(tree_t) == fs.to_bytes(tree_np)


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for key in want:
            _assert_same(got[key], want[key])
        return
    if isinstance(got, torch.Tensor):  # bfloat16 decodes to torch
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        return
    assert type(got) is type(want) and got == want


def test_port_decoder_reads_flax_bytes():
    tree = _tree(2)
    _assert_same(msgpack.from_bytes(fs.to_bytes(tree)), tree)


def test_flax_decoder_reads_port_bytes():
    tree = _tree(3)
    back = fs.msgpack_restore(msgpack.to_bytes(tree))
    back["params"]["emb"] = np.asarray(back["params"]["emb"], np.float32)
    tree["params"]["emb"] = np.asarray(tree["params"]["emb"], np.float32)
    _assert_same(back, tree)


def test_chunked_leaves_match_flax(monkeypatch):
    """An array over MAX_CHUNK_SIZE bytes goes out in flax's chunked form
    and comes back whole, from either package's bytes."""
    import flax.serialization as flax_ser

    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(4)
    tree = {"layer": {"kernel": rng.normal(size=(10, 7)).astype(np.float32)},
            "ids": np.arange(33, dtype=np.int32),
            "small": np.ones((4,), np.float32)}
    data = msgpack.to_bytes(_sorted(tree))
    assert data == fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same(msgpack.from_bytes(fs.msgpack_serialize(tree)),
                 _sorted(tree))
    _assert_same(fs.msgpack_restore(data), _sorted(tree))


@pytest.mark.parametrize("bad", [{1: 2}, {"t": (1, 2)}, {"o": object()}])
def test_unsupported_values_raise(bad):
    with pytest.raises(TypeError):
        msgpack.to_bytes(bad)


def test_truncated_and_trailing_bytes_raise():
    data = msgpack.to_bytes(_tree(5))
    with pytest.raises(ValueError):
        msgpack.from_bytes(data[:-10])
    with pytest.raises(ValueError):
        msgpack.from_bytes(data + b"\xc0")
