"""Port parity: `train.flax_msgpack`, the pure-Python reader of Flax msgpack
checkpoints, against `flax.serialization.msgpack_restore` and
`msgpack.unpackb`.

* Every leaf of all seven committed `results/*.msgpack` files bit for bit
  (dtype, shape, bytes); bfloat16 leaves against Flax's after the exact
  upcast to float32.
* Every msgpack type in every width, packed here by `msgpack.packb`:
  fixint, the int / uint widths, float32 / float64, nil, bool, str, bin,
  array and map (fix, 8, 16, 32 as the type has them), fixext 1 / 2 / 4 /
  8 / 16 and ext 8 / 16 / 32; random nested trees (hypothesis).
* Flax's ext codes (ndarray, complex, numpy scalar) and its chunked
  arrays; an unknown ext code or dtype name, or truncated data, raises
  ValueError.
"""

import glob
import os
import struct

import flax.serialization as ser
import msgpack
import numpy as np
import pytest
from flax.traverse_util import flatten_dict
from hypothesis import given, settings, strategies as st

from fresnel_tpu_torch.train import flax_msgpack as fm
from test_torch_threads import _few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(glob.glob(os.path.join(ROOT, "results", "*.msgpack")))


def test_seven_committed_checkpoints():
    assert [os.path.basename(p) for p in CHECKPOINTS] == [
        "exp2_e74_model.msgpack", "exp2_g74zi_model.msgpack",
        "exp2_k8_model.msgpack", "exp2_model.msgpack",
        "exp4_budget_model.msgpack", "exp4_model.msgpack",
        "v2combo_model.msgpack"]


@pytest.mark.parametrize("path", CHECKPOINTS,
                         ids=[os.path.basename(p) for p in CHECKPOINTS])
def test_checkpoint_leaves_bit_for_bit(path):
    with open(path, "rb") as f:
        data = f.read()
    want = flatten_dict(ser.msgpack_restore(data), sep="/")
    got = fm.read_flat(path)
    assert list(got) == list(want)
    n_bf16 = 0
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)          # exact: bf16 is a prefix
            n_bf16 += 1
        g = got[k]
        # A 0-d leaf is an array (ext 1) or a numpy scalar (ext 3), as
        # it was written.
        assert isinstance(g, (np.ndarray, np.generic)), k
        assert isinstance(g, np.ndarray) == isinstance(want[k], np.ndarray), k
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
    thin = "exp2_model" not in path and "exp4" not in path
    assert (n_bf16 == len(want)) == thin


def _roundtrip(obj, **pack_kw):
    data = msgpack.packb(obj, use_bin_type=True, **pack_kw)
    want = msgpack.unpackb(data, raw=False)
    got = fm.unpackb(data)
    assert got == want and type(got) is type(want)
    return data


@pytest.mark.parametrize("value,first", [
    (0, 0x00), (127, 0x7F), (-1, 0xFF), (-32, 0xE0),
    (128, 0xCC), (255, 0xCC), (256, 0xCD), (65535, 0xCD),
    (65536, 0xCE), (2 ** 32 - 1, 0xCE), (2 ** 32, 0xCF), (2 ** 64 - 1, 0xCF),
    (-33, 0xD0), (-128, 0xD0), (-129, 0xD1), (-32768, 0xD1),
    (-32769, 0xD2), (-2 ** 31, 0xD2), (-2 ** 31 - 1, 0xD3), (-2 ** 63, 0xD3),
    (None, 0xC0), (False, 0xC2), (True, 0xC3),
    (1.5, 0xCB), (-2.25e300, 0xCB),
])
def test_scalar_widths(value, first):
    assert _roundtrip(value)[0] == first


def test_float32():
    data = _roundtrip(1.1, use_single_float=True)
    assert data[0] == 0xCA
    assert fm.unpackb(data) == struct.unpack(">f", struct.pack(">f", 1.1))[0]


@pytest.mark.parametrize("n,first", [(0, 0xA0), (31, 0xBF), (32, 0xD9),
                                     (255, 0xD9), (256, 0xDA), (65535, 0xDA),
                                     (65536, 0xDB)])
def test_str_widths(n, first):
    assert _roundtrip("é" * (n // 2) + "a" * (n % 2))[0] == first


@pytest.mark.parametrize("n,first", [(0, 0xC4), (255, 0xC4), (256, 0xC5),
                                     (65535, 0xC5), (65536, 0xC6)])
def test_bin_widths(n, first):
    assert _roundtrip(bytes(range(256)) * (n // 256) + b"x" * (n % 256)
                      )[0] == first


@pytest.mark.parametrize("n,first", [(0, 0x90), (15, 0x9F), (16, 0xDC),
                                     (65535, 0xDC), (65536, 0xDD)])
def test_array_widths(n, first):
    assert _roundtrip(list(range(n)))[0] == first


@pytest.mark.parametrize("n,first", [(0, 0x80), (15, 0x8F), (16, 0xDE),
                                     (65535, 0xDE), (65536, 0xDF)])
def test_map_widths(n, first):
    assert _roundtrip({f"k{i}": i for i in range(n)})[0] == first


def _ndarray_payload(arr, name=None):
    return msgpack.packb((arr.shape, name or arr.dtype.name,
                          arr.tobytes("C")), use_bin_type=True)


@pytest.mark.parametrize("arr,first", [
    (np.arange(6, dtype=np.int8), 0xD8),                # fixext 16
    (np.array(5, np.int8), 0xC7),                       # ext 8
    (np.arange(60, dtype=np.float32), 0xC7),
    (np.arange(300, dtype=np.float64), 0xC8),           # ext 16
    (np.arange(20_000, dtype=np.int32), 0xC9),          # ext 32
])
def test_ndarray_ext_widths(arr, first):
    data = msgpack.packb(msgpack.ExtType(fm.EXT_NDARRAY,
                                         _ndarray_payload(arr)))
    assert data[0] == first
    got = fm.unpackb(data)
    assert got.dtype == arr.dtype and got.shape == arr.shape
    assert np.array_equal(got, arr)


@pytest.mark.parametrize("n,first", [(1, 0xD4), (2, 0xD5), (4, 0xD6),
                                     (8, 0xD7)])
def test_short_fixext_reads_its_code(n, first):
    """Flax writes no ext this short (an ndarray takes 10 bytes at
    least); the code is read at its offset and, unknown, refused."""
    data = msgpack.packb(msgpack.ExtType(9, b"z" * n))
    assert data[0] == first
    with pytest.raises(ValueError, match="ext code 9"):
        fm.unpackb(data)


def test_flax_ext_codes_and_tree():
    tree = {"a": {"w": np.random.default_rng(0).normal(size=(3, 4)).astype(
                np.float32), "empty": {}},
            "s": np.float32(2.5), "i": np.int64(-7), "c": complex(1.5, -2.0),
            "u": np.arange(5, dtype=np.uint16), "b": np.array([True, False]),
            "z": np.ones((2,), np.complex64), "n": None, "t": "text"}
    data = ser.msgpack_serialize(tree)
    want = ser.msgpack_restore(data)
    got = fm.restore(data)
    assert set(got) == set(want) and got["a"]["empty"] == {}
    for k in ("s", "i", "c", "n", "t"):
        assert got[k] == want[k] and type(got[k]) is type(want[k]), k
    for k in ("u", "b", "z"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    assert np.array_equal(got["a"]["w"], want["a"]["w"])
    assert sorted(fm.flatten(got)) == ["a/w", "b", "c", "i", "n", "s", "t",
                                       "u", "z"]


def test_bfloat16_widens_exactly():
    import ml_dtypes
    x = (np.random.default_rng(1).normal(size=200) * 1e3).astype(
        ml_dtypes.bfloat16)
    x[:4] = [np.inf, -np.inf, 0.0, -0.0]
    data = msgpack.packb(msgpack.ExtType(fm.EXT_NDARRAY, _ndarray_payload(
        x, "bfloat16")))
    got = fm.unpackb(data)
    assert got.dtype == np.float32
    assert got.tobytes() == x.astype(np.float32).tobytes()


def test_chunked_arrays_rejoin(monkeypatch):
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "small": np.arange(3, dtype=np.int32)}
    data = ser.msgpack_serialize(tree)
    assert fm.unpackb(data)["big"]["__msgpack_chunked_array__"] is True
    got = fm.restore(data)
    assert np.array_equal(got["big"], tree["big"])
    assert np.array_equal(got["small"], tree["small"])


@pytest.mark.parametrize("data", [
    msgpack.packb(msgpack.ExtType(5, b"abcdefgh")),
    b"\xd6\xff" + struct.pack(">I", 1),          # msgpack's timestamp
    msgpack.packb(msgpack.ExtType(fm.EXT_NDARRAY, _ndarray_payload(
        np.zeros(2, np.uint8), "float8_e4m3fn"))),
    msgpack.packb(msgpack.ExtType(fm.EXT_NDARRAY, _ndarray_payload(
        np.zeros(2, np.uint8), "object"))),
    msgpack.packb([1, 2, 3])[:-1],
    msgpack.packb("abc") + b"\x00",
    b"\xc1",
    b"",
], ids=["ext5", "timestamp", "float8", "object", "truncated", "trailing",
        "reserved", "empty"])
def test_refuses(data):
    with pytest.raises(ValueError):
        fm.unpackb(data)


_leaves = (st.none() | st.booleans()
           | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40)
           | st.binary(max_size=300))
_trees = st.recursive(
    _leaves, lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=8), kids, max_size=20),
    max_leaves=60)


@settings(max_examples=150, deadline=None, database=None)
@given(_trees)
def test_random_trees(tree):
    _roundtrip(tree)
