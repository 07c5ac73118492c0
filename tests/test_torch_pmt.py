"""The port's pmt wire format and CRC32C against the JAX package's: ``pack``
gives the same bytes for scalars, arrays, strings, maps and nested maps, with
and without the CRC trailer; ``unpack`` of either package's bytes gives the
same value; ``scan`` and ``MapView`` agree. Exact: byte for byte."""

import numpy as np
import pytest

from gnuradio4_tpu.core import pmt as jp
from gnuradio4_tpu.core import utils_crc as jcrc
from gnuradio4_tpu_torch.core import pmt as tp
from gnuradio4_tpu_torch.core import utils_crc as tcrc
from gnuradio4_tpu_torch.core.errors import GrError

rng = np.random.default_rng(20261017)

VALUES = {
    "none": None,
    "bool": True,
    "int": -7,
    "big_int": 2**40 + 3,
    "float": 1.25e-3,
    "complex": 1.5 - 2.5j,
    "str": "hello, pmt",
    "empty_str": "",
    "f32_array": rng.standard_normal(17).astype(np.float32),
    "c64_array": (rng.standard_normal(9) + 1j * rng.standard_normal(9)).astype(np.complex64),
    "u8_array": rng.integers(0, 255, 33).astype(np.uint8),
    "i16_array": rng.integers(-300, 300, 5).astype(np.int16),
    "u64_array": rng.integers(0, 2**62, 4).astype(np.uint64),
    "i8": np.int8(-3),
    "u32": np.uint32(7),
    "c64": np.complex64(1j),
    "list": [1.0, 2.5, -3.0],
    "map": {"sample_rate": 48000.0, "signal_name": "ch5", "n": 12},
    "nested_map": {"outer": {"inner": {"taps": np.arange(4, dtype=np.float64),
                                       "flag": False}}, "k": [1, 2]},
    "np_scalar_list": [np.float32(0.5), np.float32(-1.0)],
}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("crc", [False, True], ids=["plain", "crc"])
@pytest.mark.parametrize("name", sorted(VALUES))
def test_pack_bytes_and_unpack_agree(name, crc):
    v = VALUES[name]
    bj = jp.pack(v, crc=crc)
    bt = tp.pack(v, crc=crc)
    assert bt == bj
    for blob in (bj, bt):
        assert _same(tp.unpack(blob), jp.unpack(blob))


def test_maps_scan_and_mapview_agree():
    m = VALUES["nested_map"] | VALUES["map"]
    blob = tp.pack_map(m, crc=True)
    assert blob == jp.pack_map(m, crc=True)
    assert _same(tp.unpack_map(blob), jp.unpack_map(blob))
    stream = tp.pack(1) + tp.pack("two") + tp.pack([3.0, 4.0])
    assert [x for x in tp.scan(stream)] == [x for x in jp.scan(stream)]
    vt, vj = tp.MapView(blob), jp.MapView(blob)
    assert vt.keys() == vj.keys()
    assert _same(vt.to_dict(), vj.to_dict())


def test_heterogeneous_sequences_are_refused_alike():
    for mod in (jp, tp):
        with pytest.raises(Exception, match="heterogeneous"):
            mod.pack([1, "two", 3.0, None])


def test_crc32c_and_corruption():
    data = rng.integers(0, 255, 1000).astype(np.uint8).tobytes()
    assert tcrc.crc32c(data) == jcrc.crc32c(data)
    assert tcrc.crc32c(b"123456789") == 0xE3069283      # the CRC-32C check value
    packed = bytearray(tp.pack({"k": 123}, crc=True))
    packed[-6] ^= 0xFF
    with pytest.raises(GrError):
        tp.unpack(bytes(packed))
