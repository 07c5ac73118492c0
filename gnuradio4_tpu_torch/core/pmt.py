"""PMT — polymorphic value types with a canonical binary wire format.

≈ reference pmt ``Value``/``ValueMap`` (core Value.hpp:31-42, ValueMap.hpp:1742)
and its wire format (WireFormat.hpp:19-46, docs/CORE_WireFormat.md): every value
serializes as a little-endian self-describing **8-byte prefix + payload** so a
whole map packs into one contiguous blob that can be scanned, mmapped, or shipped
over IPC without a schema. This is the settings/message/tag payload codec — the
YAML path (yaml_io.py) is the human-readable alternative.

Prefix layout (8 bytes, little-endian):
    [0:4]  u32  total element size in bytes (prefix + payload, 8-byte aligned)
    [4]    u8   value type  (ValueType)
    [5]    u8   container type (ContainerType: scalar / vector / map / string)
    [6]    u8   flags (bit0: read-only hint, bit1: CRC32C trailer present)
    [7]    u8   payload offset from element start (≥ 8; allows alignment pads)

Maps serialize as a sequence of (key-string element, value element) pairs.
Vectors of numeric types pack their data contiguously (zero-copy viewable via
numpy). An optional CRC32C trailer (4 bytes) protects individual elements.
"""

from __future__ import annotations

import enum
import struct
from typing import Any

import numpy as np

from .errors import GrError
from .utils_crc import crc32c


class ValueType(enum.IntEnum):
    NULL = 0
    BOOL = 1
    INT8 = 2
    UINT8 = 3
    INT16 = 4
    UINT16 = 5
    INT32 = 6
    UINT32 = 7
    INT64 = 8
    UINT64 = 9
    FLOAT32 = 10
    FLOAT64 = 11
    COMPLEX64 = 12
    COMPLEX128 = 13
    STRING = 14
    MAP = 15


class ContainerType(enum.IntEnum):
    SCALAR = 0
    VECTOR = 1
    STRING = 2
    MAP = 3


_NUMPY_OF = {
    ValueType.BOOL: np.dtype(np.bool_),
    ValueType.INT8: np.dtype(np.int8),
    ValueType.UINT8: np.dtype(np.uint8),
    ValueType.INT16: np.dtype(np.int16),
    ValueType.UINT16: np.dtype(np.uint16),
    ValueType.INT32: np.dtype(np.int32),
    ValueType.UINT32: np.dtype(np.uint32),
    ValueType.INT64: np.dtype(np.int64),
    ValueType.UINT64: np.dtype(np.uint64),
    ValueType.FLOAT32: np.dtype(np.float32),
    ValueType.FLOAT64: np.dtype(np.float64),
    ValueType.COMPLEX64: np.dtype(np.complex64),
    ValueType.COMPLEX128: np.dtype(np.complex128),
}
_VT_OF_NUMPY = {v: k for k, v in _NUMPY_OF.items()}

FLAG_READONLY = 0x01
FLAG_CRC = 0x02
FLAG_SI = 0x04      # payload is followed by a u8-length SI-unit UTF-8 string

_PREFIX = struct.Struct("<IBBBB")


def _align8(n: int) -> int:
    return (n + 7) & ~7


class SIValue:
    """A value annotated with an SI unit (≈ the reference's SI-annotation wire
    flag, WireFormat.hpp:43-46): travels through the wire format with the unit
    string attached, compares equal on the value."""

    __slots__ = ("value", "unit")

    def __init__(self, value: Any, unit: str):
        self.value = value
        self.unit = str(unit)

    def __repr__(self) -> str:
        return f"SIValue({self.value!r}, {self.unit!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, SIValue):
            return self.value == other.value and self.unit == other.unit
        return self.value == other


def _classify(value: Any) -> tuple[ValueType, ContainerType]:
    if value is None:
        return ValueType.NULL, ContainerType.SCALAR
    if isinstance(value, bool):
        return ValueType.BOOL, ContainerType.SCALAR
    if isinstance(value, int):
        return ValueType.INT64, ContainerType.SCALAR
    if isinstance(value, float):
        return ValueType.FLOAT64, ContainerType.SCALAR
    if isinstance(value, complex):
        return ValueType.COMPLEX128, ContainerType.SCALAR
    if isinstance(value, str):
        return ValueType.STRING, ContainerType.STRING
    if isinstance(value, bytes):
        return ValueType.UINT8, ContainerType.VECTOR
    if isinstance(value, dict):
        return ValueType.MAP, ContainerType.MAP
    if isinstance(value, (list, tuple, np.ndarray)):
        arr = np.asarray(value)
        if arr.dtype == object or arr.dtype.kind == "U":
            raise GrError(f"cannot pack heterogeneous/str sequence {value!r}")
        vt = _VT_OF_NUMPY.get(arr.dtype)
        if vt is None:
            raise GrError(f"unsupported array dtype {arr.dtype}")
        return vt, ContainerType.VECTOR
    if isinstance(value, np.generic):
        vt = _VT_OF_NUMPY.get(np.dtype(value.dtype))
        if vt is None:
            raise GrError(f"unsupported numpy scalar {value.dtype}")
        return vt, ContainerType.SCALAR
    raise GrError(f"cannot pack value of type {type(value).__name__}")


def pack(value: Any, *, crc: bool = False, readonly: bool = False) -> bytes:
    """Serialize one value (recursively for maps) to the wire format.

    Vector/string payloads lead with a u32 byte-length (padding would otherwise
    make their true extent ambiguous); the optional CRC32C trailer occupies the
    element's last 4 bytes and covers the padded payload region. An
    :class:`SIValue` sets the SI flag and appends a u8-length unit string
    after the payload.
    """
    si_unit = b""
    if isinstance(value, SIValue):
        si_unit = value.unit.encode("utf-8")
        if len(si_unit) > 255:
            raise GrError("SI unit string longer than 255 bytes")
        value = value.value
    vt, ct = _classify(value)
    if si_unit and ct is ContainerType.MAP:
        raise GrError("SI unit annotation applies to scalars/vectors/strings, "
                      "not maps")
    if ct is ContainerType.MAP:
        payload = b"".join(pack(str(k), crc=crc) + pack(v, crc=crc)
                           for k, v in value.items())
    elif ct is ContainerType.STRING:
        raw = value.encode("utf-8")
        payload = struct.pack("<I", len(raw)) + raw
    elif ct is ContainerType.VECTOR:
        arr = np.ascontiguousarray(
            np.frombuffer(value, np.uint8) if isinstance(value, bytes)
            else np.asarray(value))
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        payload = struct.pack("<I", len(raw)) + raw
    elif vt is ValueType.NULL:
        payload = b""
    else:
        dt = {ValueType.BOOL: "<?", ValueType.INT64: "<q",
              ValueType.FLOAT64: "<d"}.get(vt)
        if vt is ValueType.COMPLEX128:
            payload = struct.pack("<dd", value.real, value.imag)
        elif dt is not None:
            payload = struct.pack(dt, value)
        else:  # numpy scalar
            payload = np.asarray(value).astype(
                np.dtype(value.dtype).newbyteorder("<")).tobytes()
    flags = (FLAG_READONLY if readonly else 0) | (FLAG_CRC if crc else 0)
    if si_unit:
        flags |= FLAG_SI
        payload = payload + struct.pack("<B", len(si_unit)) + si_unit
    pay_off = 8
    total = _align8(pay_off + len(payload) + (4 if crc else 0))
    head = _PREFIX.pack(total, int(vt), int(ct), flags, pay_off)
    pad_to = total - (4 if crc else 0)
    body = head + payload + b"\0" * (pad_to - 8 - len(payload))
    if crc:
        body += struct.pack("<I", crc32c(body[pay_off:]))
    return body


_SCALAR_SIZE = {
    ValueType.NULL: 0, ValueType.BOOL: 1, ValueType.INT8: 1,
    ValueType.UINT8: 1, ValueType.INT16: 2, ValueType.UINT16: 2,
    ValueType.INT32: 4, ValueType.UINT32: 4, ValueType.INT64: 8,
    ValueType.UINT64: 8, ValueType.FLOAT32: 4, ValueType.FLOAT64: 8,
    ValueType.COMPLEX64: 8, ValueType.COMPLEX128: 16,
}


def _unpack_one(buf: memoryview, offset: int, *, copy: bool = True
                ) -> tuple[Any, int]:
    if offset + 8 > len(buf):
        raise GrError("truncated pmt element (no prefix)")
    total, vt_b, ct_b, flags, pay_off = _PREFIX.unpack_from(buf, offset)
    if total < 8 or offset + total > len(buf):
        raise GrError(f"corrupt pmt element size {total} at offset {offset}")
    vt, ct = ValueType(vt_b), ContainerType(ct_b)
    end = offset + total
    pay_start = offset + pay_off
    crc_len = 4 if flags & FLAG_CRC else 0
    limit = end - crc_len
    if crc_len:
        stored = struct.unpack_from("<I", buf, end - 4)[0]
        if crc32c(bytes(buf[pay_start:limit])) != stored:
            raise GrError("pmt CRC32C mismatch")
    si_after = pay_start   # where the optional SI unit string starts
    if ct is ContainerType.MAP:
        inner: dict[str, Any] = {}
        pos = pay_start
        # maps contain only whole elements; trailing zero padding < 8 B skipped
        while pos + 8 <= limit:
            k, pos = _unpack_one(buf, pos, copy=copy)
            v, pos = _unpack_one(buf, pos, copy=copy)
            inner[k] = v
        value: Any = inner
    elif ct in (ContainerType.STRING, ContainerType.VECTOR):
        blen = struct.unpack_from("<I", buf, pay_start)[0]
        si_after = pay_start + 4 + blen
        if ct is ContainerType.STRING:
            value = bytes(buf[pay_start + 4: si_after]).decode("utf-8")
        else:
            dt = _NUMPY_OF[vt].newbyteorder("<")
            value = np.frombuffer(buf, dtype=dt, count=blen // dt.itemsize,
                                  offset=pay_start + 4)
            if copy:
                value = value.copy()
    elif vt is ValueType.NULL:
        value = None
        si_after = pay_start
    elif vt is ValueType.BOOL:
        value = bool(buf[pay_start])
        si_after = pay_start + 1
    elif vt is ValueType.INT64:
        value = struct.unpack_from("<q", buf, pay_start)[0]
        si_after = pay_start + 8
    elif vt is ValueType.FLOAT64:
        value = struct.unpack_from("<d", buf, pay_start)[0]
        si_after = pay_start + 8
    elif vt is ValueType.COMPLEX128:
        re, im = struct.unpack_from("<dd", buf, pay_start)
        value = complex(re, im)
        si_after = pay_start + 16
    else:
        value = np.frombuffer(buf, dtype=_NUMPY_OF[vt], count=1,
                              offset=pay_start)[0]
        si_after = pay_start + _SCALAR_SIZE[vt]
    if flags & FLAG_SI and ct is not ContainerType.MAP:
        ulen = buf[si_after]
        unit = bytes(buf[si_after + 1: si_after + 1 + ulen]).decode("utf-8")
        value = SIValue(value, unit)
    return value, end


def unpack(data: bytes | memoryview) -> Any:
    """Deserialize one value from the wire format."""
    value, _ = _unpack_one(memoryview(data), 0)
    return value


def pack_map(d: dict[str, Any], **kw) -> bytes:
    return pack(dict(d), **kw)


def unpack_map(data: bytes) -> dict[str, Any]:
    v = unpack(data)
    if not isinstance(v, dict):
        raise GrError(f"expected map, got {type(v).__name__}")
    return v


def scan(data: bytes | memoryview):
    """Iterate the elements of a packed buffer without materializing payloads
    (≈ wire::nextElement, WireFormat.hpp): yields
    ``(offset, total_size, ValueType, ContainerType)`` per element."""
    buf = memoryview(data)
    offset = 0
    while offset + 8 <= len(buf):
        total, vt_b, ct_b, _flags, _off = _PREFIX.unpack_from(buf, offset)
        if total < 8 or offset + total > len(buf):
            raise GrError(f"corrupt pmt element size {total} at {offset}")
        yield offset, total, ValueType(vt_b), ContainerType(ct_b)
        offset += total


class MapView:
    """Zero-copy lazy view over a packed MAP element (≈ ValueMapView,
    core ValueMap.hpp:1742): the blob is scanned on demand — no values are
    materialized until accessed, and numeric vectors come back as numpy arrays
    ALIASING the underlying buffer (no copy; treat as read-only). This is the
    IPC/mmap consumption path: hand the view a shared buffer and index it.
    """

    def __init__(self, data: bytes | memoryview):
        self._buf = memoryview(data)
        if len(self._buf) < 8:
            raise GrError("buffer too small for a pmt map")
        total, vt_b, ct_b, _flags, pay_off = _PREFIX.unpack_from(self._buf, 0)
        if ContainerType(ct_b) is not ContainerType.MAP:
            raise GrError("MapView requires a MAP root element")
        crc_len = 4 if _flags & FLAG_CRC else 0
        self._pay = pay_off
        self._limit = total - crc_len

    def _entries(self):
        pos = self._pay
        buf = self._buf
        while pos + 8 <= self._limit:
            key, vpos = _unpack_one(buf, pos)
            yield key, vpos
            total = _PREFIX.unpack_from(buf, vpos)[0]
            pos = vpos + total

    def keys(self) -> list[str]:
        return [k for k, _ in self._entries()]

    def __contains__(self, key: str) -> bool:
        return any(k == key for k, _ in self._entries())

    def __getitem__(self, key: str) -> Any:
        for k, vpos in self._entries():
            if k == key:
                value, _ = _unpack_one(self._buf, vpos, copy=False)
                if isinstance(value, dict):
                    # nested map: return a lazy sub-view instead
                    total = _PREFIX.unpack_from(self._buf, vpos)[0]
                    return MapView(self._buf[vpos: vpos + total])
                return value
        raise KeyError(key)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def to_dict(self) -> dict[str, Any]:
        """Materialize (copies vector payloads)."""
        value, _ = _unpack_one(self._buf, 0)
        return value
