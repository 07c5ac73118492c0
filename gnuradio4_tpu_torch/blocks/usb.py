"""User-space USB device access (≈ reference blocks/common USBDevice.hpp +
DeviceRegistry.hpp): sysfs enumeration, a backend protocol for control/bulk
transfers, a Linux usbdevfs implementation (ioctl on /dev/bus/usb/BBB/DDD —
no libusb dependency, same approach as the reference), and a scriptable fake
backend so protocol drivers (rtl2832.py) are fully testable without hardware.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from pathlib import Path
from typing import Any, Callable

from ..core.errors import GrError

# -- enumeration (sysfs; ≈ enumerateUSBDevices, USBDevice.hpp:79) -------------


@dataclasses.dataclass(frozen=True)
class UsbDeviceInfo:
    vid: int
    pid: int
    bus: int
    dev: int
    dev_path: str
    product: str = ""
    manufacturer: str = ""
    serial: str = ""

    @property
    def accessible(self) -> bool:
        return os.access(self.dev_path, os.R_OK | os.W_OK)


def _sysfs_attr(p: Path) -> str:
    try:
        return p.read_text().strip()
    except OSError:
        return ""


def enumerate_usb_devices(vid_pid_filter: tuple[tuple[int, int], ...] = ()
                          ) -> list[UsbDeviceInfo]:
    """List USB devices from /sys/bus/usb/devices (empty off-Linux)."""
    root = Path("/sys/bus/usb/devices")
    out: list[UsbDeviceInfo] = []
    if not root.is_dir():
        return out
    for entry in sorted(root.iterdir()):
        vid_p = entry / "idVendor"
        if not vid_p.exists():
            continue
        try:
            vid = int(_sysfs_attr(vid_p), 16)
            pid = int(_sysfs_attr(entry / "idProduct"), 16)
            bus = int(_sysfs_attr(entry / "busnum"))
            dev = int(_sysfs_attr(entry / "devnum"))
        except ValueError:
            continue
        if vid_pid_filter and (vid, pid) not in vid_pid_filter:
            continue
        out.append(UsbDeviceInfo(
            vid=vid, pid=pid, bus=bus, dev=dev,
            dev_path=f"/dev/bus/usb/{bus:03d}/{dev:03d}",
            product=_sysfs_attr(entry / "product"),
            manufacturer=_sysfs_attr(entry / "manufacturer"),
            serial=_sysfs_attr(entry / "serial")))
    return out


# -- usbdevfs ioctl plumbing (linux/usbdevice_fs.h layouts) -------------------

_IOC_WRITE, _IOC_READ = 1, 2


def _ioc(direction: int, typ: str, nr: int, size: int) -> int:
    return (direction << 30) | (size << 16) | (ord(typ) << 8) | nr


class _CtrlTransfer(ctypes.Structure):
    _fields_ = [("bRequestType", ctypes.c_uint8),
                ("bRequest", ctypes.c_uint8),
                ("wValue", ctypes.c_uint16),
                ("wIndex", ctypes.c_uint16),
                ("wLength", ctypes.c_uint16),
                ("timeout", ctypes.c_uint32),
                ("data", ctypes.c_void_p)]


class _BulkTransfer(ctypes.Structure):
    _fields_ = [("ep", ctypes.c_uint),
                ("len", ctypes.c_uint),
                ("timeout", ctypes.c_uint),
                ("data", ctypes.c_void_p)]


class _DisconnectClaim(ctypes.Structure):
    _fields_ = [("interface", ctypes.c_uint),
                ("flags", ctypes.c_uint),
                ("driver", ctypes.c_char * 256)]


_USBDEVFS_CONTROL = _ioc(_IOC_READ | _IOC_WRITE, "U", 0,
                         ctypes.sizeof(_CtrlTransfer))
_USBDEVFS_BULK = _ioc(_IOC_READ | _IOC_WRITE, "U", 2,
                      ctypes.sizeof(_BulkTransfer))
_USBDEVFS_CLAIMINTERFACE = _ioc(_IOC_READ, "U", 15, ctypes.sizeof(ctypes.c_uint))
_USBDEVFS_RELEASEINTERFACE = _ioc(_IOC_READ, "U", 16,
                                  ctypes.sizeof(ctypes.c_uint))
_USBDEVFS_DISCONNECT_CLAIM = _ioc(_IOC_READ, "U", 27,
                                  ctypes.sizeof(_DisconnectClaim))


class LinuxUsbDevice:
    """usbdevfs backend: control/bulk transfers through ioctl on the device
    node (≈ USBDevice.hpp:124-341 — detach-kernel-driver claim included)."""

    def __init__(self) -> None:
        self._fd = -1
        self._interface = -1

    @property
    def is_open(self) -> bool:
        return self._fd >= 0

    def open(self, info: UsbDeviceInfo, interface: int = 0) -> None:
        import fcntl
        try:
            self._fd = os.open(info.dev_path, os.O_RDWR)
        except OSError as e:
            raise GrError(f"cannot open {info.dev_path}: {e}") from e
        dc = _DisconnectClaim(interface=interface, flags=0, driver=b"")
        try:
            fcntl.ioctl(self._fd, _USBDEVFS_DISCONNECT_CLAIM, dc)
        except OSError:
            # older kernels: plain claim (may fail if a kernel driver holds it)
            try:
                fcntl.ioctl(self._fd, _USBDEVFS_CLAIMINTERFACE,
                            ctypes.c_uint(interface))
            except OSError as e:
                os.close(self._fd)
                self._fd = -1
                raise GrError(f"cannot claim interface {interface} on "
                              f"{info.dev_path}: {e}") from e
        self._interface = interface

    def close(self) -> None:
        import fcntl
        if self._fd >= 0:
            if self._interface >= 0:
                try:
                    fcntl.ioctl(self._fd, _USBDEVFS_RELEASEINTERFACE,
                                ctypes.c_uint(self._interface))
                except OSError:
                    pass
            os.close(self._fd)
            self._fd = -1

    def control_out(self, request_type: int, request: int, value: int,
                    index: int, data: bytes, timeout_ms: int = 300) -> int:
        import fcntl
        buf = ctypes.create_string_buffer(bytes(data), len(data))
        xfer = _CtrlTransfer(bRequestType=request_type, bRequest=request,
                             wValue=value, wIndex=index, wLength=len(data),
                             timeout=timeout_ms,
                             data=ctypes.cast(buf, ctypes.c_void_p))
        return fcntl.ioctl(self._fd, _USBDEVFS_CONTROL, xfer)

    def control_in(self, request_type: int, request: int, value: int,
                   index: int, length: int, timeout_ms: int = 300) -> bytes:
        import fcntl
        buf = ctypes.create_string_buffer(length)
        xfer = _CtrlTransfer(bRequestType=request_type, bRequest=request,
                             wValue=value, wIndex=index, wLength=length,
                             timeout=timeout_ms,
                             data=ctypes.cast(buf, ctypes.c_void_p))
        n = fcntl.ioctl(self._fd, _USBDEVFS_CONTROL, xfer)
        return buf.raw[:n]

    def bulk_read(self, endpoint: int, length: int,
                  timeout_ms: int = 1000) -> bytes:
        import fcntl
        buf = ctypes.create_string_buffer(length)
        xfer = _BulkTransfer(ep=endpoint, len=length, timeout=timeout_ms,
                             data=ctypes.cast(buf, ctypes.c_void_p))
        n = fcntl.ioctl(self._fd, _USBDEVFS_BULK, xfer)
        return buf.raw[:n]


class FakeUsbDevice:
    """Scriptable USB backend for protocol-driver tests: control transfers hit
    user handlers; bulk reads pull from a sample generator."""

    def __init__(self) -> None:
        self.is_open = False
        self.control_log: list[tuple[str, int, int, int, bytes]] = []
        self._in_handler: Callable[[int, int, int], bytes] | None = None
        self._out_handler: Callable[[int, int, int, bytes], None] | None = None
        self._bulk: Callable[[int, int], bytes] | None = None

    def on_control_in(self, fn: Callable[[int, int, int], bytes]) -> None:
        self._in_handler = fn

    def on_control_out(self, fn: Callable[[int, int, int, bytes], None]) -> None:
        self._out_handler = fn

    def on_bulk_read(self, fn: Callable[[int, int], bytes]) -> None:
        self._bulk = fn

    def open(self, info: Any = None, interface: int = 0) -> None:
        self.is_open = True

    def close(self) -> None:
        self.is_open = False

    def control_out(self, request_type: int, request: int, value: int,
                    index: int, data: bytes, timeout_ms: int = 300) -> int:
        self.control_log.append(("out", request, value, index, bytes(data)))
        if self._out_handler:
            self._out_handler(request, value, index, bytes(data))
        return len(data)

    def control_in(self, request_type: int, request: int, value: int,
                   index: int, length: int, timeout_ms: int = 300) -> bytes:
        self.control_log.append(("in", request, value, index, b""))
        if self._in_handler:
            return self._in_handler(value, index, length)
        return b"\x00" * length

    def bulk_read(self, endpoint: int, length: int,
                  timeout_ms: int = 1000) -> bytes:
        if self._bulk:
            return self._bulk(endpoint, length)
        return b"\x80" * length   # mid-scale u8 IQ = silence
