"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Counterpart of gnuradio4_tpu/ops/pallas_kernels.py. Sources live in ``csrc/``
and are compiled for Hopper (``sm_90a``) by ``nvcc`` into one shared library
with a plain C interface, at first use, into ``_build/`` keyed by a hash of the
sources and flags; ``ctypes`` loads it. Nothing is built or imported from CUDA
when this module is imported.

Each kernel has a wrapper that dispatches on its input tensor's device alone:
a CPU tensor takes the plain version beside it; a CUDA tensor launches the
kernel (counting the launch in ``<wrapper>.launches``) or raises. No path falls
back from a failed build or launch to the plain version.

=================  ==============================================  ================
wrapper            replaces (gnuradio4_tpu/ops/pallas_kernels.py)  plain version
=================  ==============================================  ================
fir_banded         fir_planar_pallas, fir_ilv_pallas               fir_banded_ref
nco_mix            nco_mix_pallas                                  nco_mix_ref
iir_sos            iir_sos_pallas                                  iir_sos_ref
fir_demod          fir_demod_planar_pallas                         fir_demod_ref
one_pole           none (ops/iir.py one_pole_apply's XLA ops)      one_pole_ref
=================  ==============================================  ================
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..core.errors import GrError
from .precision import rung_dot
from .signal import MASK32, nco_phases

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
_ANGLE = float(np.float32(2.0 * np.pi)) / 4294967296.0   # f32(2π)·2^-32


@dataclasses.dataclass
class KernelLibrary:
    """The loaded kernel library: its path, the seconds its build and load
    took, whether ``nvcc`` built it in this process (``built``; False when
    the library was already built for these sources and only loaded) and
    the compiler's report (``-Xptxas -v``: registers, shared memory and
    spills per kernel; kept beside the library as ``.log``)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str
    built: bool


_library: KernelLibrary | None = None
_library_lock = threading.Lock()


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise GrError("cannot build the CUDA kernels: no CUDA toolkit found "
                      "(set CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _compile(so: Path) -> str:
    """One ``nvcc -c`` per source, all started together, then one link into
    ``so``. Returns the compilers' output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = so.with_name(f"{so.stem}_{src.stem}.{tag}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit code {proc.returncode})")
    if failed:
        raise GrError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    tmp = so.with_name(f"{so.name}.{tag}")
    proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise GrError(f"linking the kernels failed with exit code "
                      f"{proc.returncode}:\n{log}")
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)
    return log


def build() -> KernelLibrary:
    """Compile ``csrc/*.cu`` (once per source hash) and load the library."""
    global _library
    with _library_lock:
        if _library is not None:
            return _library
        so = BUILD_DIR / f"libgr4kernels_{_source_hash()}.so"
        t0 = time.perf_counter()
        built = not so.exists()
        if not built:
            report = so.with_suffix(".log")
            log = report.read_text() if report.exists() else ""
        else:
            log = _compile(so)
        lib = ctypes.CDLL(str(so))
        lib.gr4_fir_banded.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.gr4_fir_banded.restype = ctypes.c_int
        lib.gr4_nco_mix.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_uint32, ctypes.c_uint32,
                                    ctypes.c_void_p]
        lib.gr4_nco_mix.restype = ctypes.c_int
        set_iir_sos_argtypes(lib)
        lib.gr4_fir_demod.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.gr4_fir_demod.restype = ctypes.c_int
        lib.gr4_one_pole.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.gr4_one_pole.restype = ctypes.c_int
        for fn in ("threads", "stretch", "levels"):
            getattr(lib, f"gr4_one_pole_{fn}").restype = ctypes.c_int
        lib.gr4_one_pole_work_size.argtypes = [ctypes.c_int64]
        lib.gr4_one_pole_work_size.restype = ctypes.c_int64
        lib.gr4_error_string.argtypes = [ctypes.c_int]
        lib.gr4_error_string.restype = ctypes.c_char_p
        _library = KernelLibrary(lib, so, time.perf_counter() - t0, log,
                                 built)
        return _library


def set_iir_sos_argtypes(lib: ctypes.CDLL) -> None:
    """``gr4_iir_sos``'s C signature and its size queries on ``lib``."""
    lib.gr4_iir_sos.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.gr4_iir_sos.restype = ctypes.c_int
    for fn in ("group_size", "chunk", "levels", "launches_per_group"):
        getattr(lib, f"gr4_iir_sos_{fn}").restype = ctypes.c_int
    lib.gr4_iir_sos_work_size.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.gr4_iir_sos_work_size.restype = ctypes.c_int64


def _check(err: int, name: str) -> None:
    if err:
        msg = build().lib.gr4_error_string(err).decode()
        raise GrError(f"{name}: CUDA error {err} ({msg})")


def _require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise GrError(f"{name}: the kernel needs every operand on one CUDA "
                          f"device; got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise GrError(f"{name}: operands must be contiguous")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _host_taps(taps) -> np.ndarray:
    if torch.is_tensor(taps):
        taps = taps.detach().cpu().numpy()
    t = np.asarray(taps)
    return t.astype(np.complex64 if np.iscomplexobj(t) else np.float32)


@functools.lru_cache(maxsize=256)
def _device_constant_cached(key: bytes, dtype: str, device: str) -> torch.Tensor:
    arr = np.frombuffer(key, dtype=dtype).copy()
    return torch.from_numpy(arr).to(device)


# read-only host arrays already uploaded, by (id, device); each entry holds its
# array, so the id cannot be reused while the entry lives
_frozen_uploads: dict[tuple[int, str], tuple[np.ndarray, torch.Tensor]] = {}


def frozen(*arrays: np.ndarray):
    """Mark host constants read-only (what the cached builders return), so
    :func:`device_constant` finds them again by identity."""
    for a in arrays:
        a.flags.writeable = False
    return arrays[0] if len(arrays) == 1 else arrays


def device_constant(arr: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A host constant (taps, weights, code matrices) on ``device``, uploaded
    once: a read-only array (see :func:`frozen`) once per array and device,
    found again by identity without hashing its bytes; any other array once
    per content and device."""
    dev = str(device)
    if isinstance(arr, np.ndarray) and not arr.flags.writeable:
        hit = _frozen_uploads.get((id(arr), dev))
        if hit is None:
            if len(_frozen_uploads) >= 256:
                _frozen_uploads.clear()
            hit = _frozen_uploads[(id(arr), dev)] = (
                arr, torch.from_numpy(np.array(arr, order="C")).to(dev))
        return hit[1]
    a = np.ascontiguousarray(arr)
    return _device_constant_cached(a.tobytes(), a.dtype.str,
                                   dev).reshape(a.shape)


def _device_taps(taps, device: torch.device) -> torch.Tensor:
    """Taps as a contiguous tensor on ``device`` (host taps upload once)."""
    if torch.is_tensor(taps) and taps.device == device:
        return taps.contiguous()
    return device_constant(_host_taps(taps), device)


# -- banded FIR ----------------------------------------------------------------

def fir_banded(x: torch.Tensor, hist: torch.Tensor, taps, decim: int = 1
               ) -> torch.Tensor:
    """Decimating FIR over the history-prefixed stream ``[hist, x]``:
    ``y[..., m] = Σ_k taps[k]·xc[..., m·decim + K−1−k]`` for ``m < T // decim``.

    ``x``: [T] or [C, T], complex64 or float32; ``hist``: [K−1] or [C, K−1] of
    the same dtype; ``taps``: [K] float32 or complex64 (host array or tensor).
    The output is complex64 when the stream or the taps are complex.
    CPU tensors take :func:`fir_banded_ref`; CUDA tensors launch the kernel in
    ``csrc/fir_banded.cu``. A launch that took the phase-grouped loop (long
    decimating filters; the kernel's planner decides and reports it) also
    counts in ``fir_banded.phase_groups``."""
    if x.device.type == "cpu":
        return fir_banded_ref(x, hist, taps, decim)
    name = "fir_banded"
    if x.dtype not in (torch.complex64, torch.float32) or hist.dtype != x.dtype:
        raise GrError(f"{name}: stream and history must both be complex64 or "
                      f"float32; got {x.dtype}, {hist.dtype}")
    dev = _require_cuda(name, x, hist)
    h = _device_taps(taps, dev)
    if h.dtype not in (torch.complex64, torch.float32) or h.ndim != 1:
        raise GrError(f"{name}: taps must be 1-D float32 or complex64")
    _require_cuda(name, x, h)
    k = h.shape[0]
    if decim < 1 or x.ndim not in (1, 2) or hist.ndim != x.ndim \
            or hist.shape[:-1] != x.shape[:-1] or hist.shape[-1] != k - 1:
        raise GrError(f"{name}: bad shapes x{tuple(x.shape)} hist"
                      f"{tuple(hist.shape)} taps[{k}] decim={decim}")
    channels = 1 if x.ndim == 1 else x.shape[0]
    t = x.shape[-1]
    out_dt = torch.complex64 if (x.is_complex() or h.is_complex()) else torch.float32
    y = torch.empty((*x.shape[:-1], t // decim), dtype=out_dt, device=dev)
    if y.numel() == 0:
        return y
    groups = ctypes.c_int(0)
    err = build().lib.gr4_fir_banded(
        x.data_ptr(), hist.data_ptr(), h.data_ptr(), y.data_ptr(),
        channels, t, k, int(decim), int(x.is_complex()), int(h.is_complex()),
        _stream(dev), ctypes.byref(groups))
    _check(err, name)
    fir_banded.launches += 1
    if groups.value > 1:
        fir_banded.phase_groups += 1
    return y


fir_banded.launches = 0
fir_banded.phase_groups = 0


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def _choose_tile(n: int, ntaps: int, decim: int) -> int:
    """Tile length: ≥ ntaps−1 (framing constraint), multiple of decim,
    128–1024-class. The stream is zero-padded up to a tile multiple; a stream
    shorter than one tile gets a single smaller tile, never below ntaps−1 (the
    JAX package's version drops that bound and fails for T < ntaps−1 there)."""
    base = max(128, _next_pow2(ntaps - 1))
    tile = base * decim // math.gcd(base, decim)
    return min(tile, max(_next_pow2(max(n, 1)), decim, _next_pow2(ntaps - 1)))


@functools.lru_cache(maxsize=256)
def _toeplitz_np(taps_key, ntaps: int, tile: int, decim: int) -> np.ndarray:
    """Banded Toeplitz weights W[j, i]: frame[j] → output column i (decimated).

    frame[m, j] = xc[m·L + j]; y[m·L + i·decim] = Σ_k h[k]·xc[m·L + i·decim +
    (K−1) − k]  ⇒  W[j, i] = h[i·decim + K−1 − j] (0 ≤ · < K).
    """
    h = np.asarray(taps_key)
    k = ntaps
    n_out = tile // decim
    w = np.zeros((tile + k - 1, n_out), dtype=h.dtype)
    for i in range(n_out):
        j0 = i * decim
        w[j0: j0 + k, i] = h[::-1]
    return w


@functools.lru_cache(maxsize=64)
def _banded_weights(taps_key, tile: int, decim: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(W_lo, W_hi) [tile, tile/decim], read-only float32 host arrays: the
    real Toeplitz split so that y[m] = A[m] @ W_lo + A[m+1] @ W_hi over rows
    A of the padded stream."""
    k = len(taps_key)
    w = _toeplitz_np(taps_key, k, tile, decim)
    w_hi = np.zeros_like(w[:tile])
    w_hi[: k - 1] = w[tile:]
    return frozen(np.ascontiguousarray(w[:tile], np.float32),
                  np.ascontiguousarray(w_hi, np.float32))


def fir_banded_ref(x: torch.Tensor, hist: torch.Tensor, taps, decim: int = 1,
                   *, mode: str = "highest") -> torch.Tensor:
    """Plain version of :func:`fir_banded`: the JAX package's ``_fir_matmul``
    (gnuradio4_tpu/ops/fir.py) — zero-copy two-view banded matmul. The stream
    ``xc = [hist, x]`` is zero-padded to ``(n+1)`` tiles and viewed as rows
    A [n+1, tile]; ``y[m] = A[m] @ W_lo + A[m+1] @ W_hi`` on real rails
    (complex streams and taps split into re/im), each product through
    :func:`~.precision.rung_dot` at the precision rung ``mode`` (the plain
    version runs ``highest``: full float32)."""
    taps_np = _host_taps(taps)
    squeeze = x.ndim == 1
    x2 = x[None] if squeeze else x
    h2 = hist[None] if squeeze else hist
    xc = torch.cat([h2.to(x2.dtype), x2], dim=-1)
    b, tc = xc.shape
    k = taps_np.shape[-1]
    if h2.shape[-1] != k - 1 or decim < 1:
        raise GrError(f"fir_banded_ref: bad shapes hist{tuple(hist.shape)} "
                      f"taps[{k}] decim={decim}")
    t = tc - (k - 1)
    tile = _choose_tile(t, k, decim)
    n = -(-t // tile)
    total = (n + 1) * tile
    if total != tc:
        xc = torch.cat([xc, xc.new_zeros(b, total - tc)], dim=-1)
    cx_t = np.iscomplexobj(taps_np)
    cx_x = xc.is_complex()

    def banded(rows, h):
        lo, hi = (device_constant(w, xc.device) for w in _banded_weights(
            tuple(h.tolist()), tile, decim))
        return (rung_dot(rows[:, :-1], lo, mode)
                + rung_dot(rows[:, 1:], hi, mode))

    rails = (xc.real, xc.imag) if cx_x else (xc, None)
    ar, ai = (r.to(torch.float32).reshape(b, n + 1, tile)
              if r is not None else None for r in rails)
    if not (cx_x or cx_t):
        y = banded(ar, taps_np)
    elif not cx_t:
        y = torch.complex(banded(ar, taps_np), banded(ai, taps_np))
    elif not cx_x:
        y = torch.complex(banded(ar, taps_np.real), banded(ar, taps_np.imag))
    else:
        y = torch.complex(
            banded(ar, taps_np.real) - banded(ai, taps_np.imag),
            banded(ar, taps_np.imag) + banded(ai, taps_np.real))
    y = y.reshape(b, -1)[:, : t // decim]
    return y[0] if squeeze else y


# -- integer-NCO mixer ---------------------------------------------------------

def nco_mix(x: torch.Tensor, phase0: int, dphi: int
            ) -> tuple[torch.Tensor, int]:
    """``y[..., n] = x[..., n]·e^{j2π((phase0 + n·dphi) mod 2³²)/2³²}`` over the
    last axis of a complex64 ``[T]`` or ``[C, T]`` stream. Returns ``(y, phase)``
    with the continuing phase ``(phase0 + T·dphi) mod 2³²`` computed on the
    host. CPU tensors take :func:`nco_mix_ref`; CUDA tensors launch the kernel
    in ``csrc/nco_mix.cu``."""
    if x.device.type == "cpu":
        return nco_mix_ref(x, phase0, dphi)
    name = "nco_mix"
    if x.dtype != torch.complex64:
        raise GrError(f"{name}: stream must be complex64; got {x.dtype}")
    dev = _require_cuda(name, x)
    t = x.shape[-1]
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y, (int(phase0) + t * int(dphi)) & MASK32
    err = build().lib.gr4_nco_mix(x.data_ptr(), y.data_ptr(), x.numel(), t,
                                  int(phase0) & MASK32, int(dphi) & MASK32,
                                  _stream(dev))
    _check(err, name)
    nco_mix.launches += 1
    return y, (int(phase0) + t * int(dphi)) & MASK32


nco_mix.launches = 0


def nco_mix_ref(x: torch.Tensor, phase0: int, dphi: int
                ) -> tuple[torch.Tensor, int]:
    """Plain version of :func:`nco_mix`, per sample in the same form as the
    kernel: angle = f32(phase)·f32(2π)·2⁻³², then cos/sin and a complex
    multiply."""
    t = x.shape[-1]
    ang = nco_phases(phase0, dphi, t, x.device).to(torch.float32) * _ANGLE
    c, s = torch.cos(ang), torch.sin(ang)
    xr, xi = x.real, x.imag
    y = torch.complex(xr * c - xi * s, xr * s + xi * c)
    return y, (int(phase0) + t * int(dphi)) & MASK32


# -- cascaded biquads ------------------------------------------------------------

def iir_sos(x: torch.Tensor, sos, state: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cascaded-biquad IIR (transposed DF-II) over the last axis of a float32
    ``[T]`` or ``[C, T]`` stream. ``sos``: [S, 6] host coefficients; ``state``:
    [S, 2] or [C, S, 2] float32. Returns ``(y, new_state)``. CPU tensors take
    :func:`iir_sos_ref`; CUDA tensors run the chunked scan in
    ``csrc/iir_sos.cu``: per group of up to 16 sections, in order, three
    launches (reduce, carry, rerun), each group after the first filtering
    ``y`` in place; each launch counts. The chunk transitions' powers
    (ops/iir.py ``sos_chunk_powers``) are uploaded once per coefficient set.
    A stream cut into two calls with the state carried agrees with one call
    within f32 rounding, not bit for bit: the chunk grid starts at each
    call's first sample."""
    if x.device.type == "cpu":
        return iir_sos_ref(x, sos, state)
    from .iir import sos_coefficients
    name = "iir_sos"
    if x.dtype != torch.float32 or state.dtype != torch.float32:
        raise GrError(f"{name}: stream and state must be float32; got "
                      f"{x.dtype}, {state.dtype}")
    dev = _require_cuda(name, x, state)
    co = sos_coefficients(sos)
    n_sec = co.shape[0]
    if x.ndim not in (1, 2) or state.shape != (*x.shape[:-1], n_sec, 2):
        raise GrError(f"{name}: bad shapes x{tuple(x.shape)} state"
                      f"{tuple(state.shape)} for {n_sec} sections")
    channels = 1 if x.ndim == 1 else x.shape[0]
    t = x.shape[-1]
    y = torch.empty_like(x)
    new_state = torch.empty_like(state)
    if channels == 0 or t == 0:
        new_state.copy_(state)
        return y, new_state
    lib = _iir_sos_lib()
    phi = device_constant(sos_carry_table(co), dev)
    work = torch.empty(lib.gr4_iir_sos_work_size(channels, t, n_sec), device=dev)
    err = lib.gr4_iir_sos(x.data_ptr(), y.data_ptr(), state.data_ptr(),
                          new_state.data_ptr(), co.ctypes.data, phi.data_ptr(),
                          work.data_ptr(), channels, t, n_sec, _stream(dev))
    _check(err, name)
    iir_sos.launches += -(-n_sec // lib.gr4_iir_sos_group_size()) \
        * lib.gr4_iir_sos_launches_per_group()
    return y, new_state


iir_sos.launches = 0


def _iir_sos_lib() -> ctypes.CDLL:
    """The library, after checking that its chunked scan uses the chunk,
    group and table sizes of ops/iir.py (the host builds the tables)."""
    from .iir import SOS_CARRY_LEVELS, SOS_CHUNK, SOS_GROUP
    lib = build().lib
    got = (lib.gr4_iir_sos_chunk(), lib.gr4_iir_sos_group_size(),
           lib.gr4_iir_sos_levels())
    if got != (SOS_CHUNK, SOS_GROUP, SOS_CARRY_LEVELS):
        raise GrError(f"iir_sos: csrc/iir_sos.cu has (chunk, group, levels) "
                      f"{got}, ops/iir.py {(SOS_CHUNK, SOS_GROUP, SOS_CARRY_LEVELS)}")
    return lib


@functools.lru_cache(maxsize=64)
def _carry_table(co_key: bytes, n_sec: int) -> np.ndarray:
    from .iir import SOS_GROUP, sos_chunk_powers
    co = np.frombuffer(co_key, np.float32).reshape(n_sec, 5)
    return frozen(np.concatenate([sos_chunk_powers(co[k0:k0 + SOS_GROUP]).ravel()
                                  for k0 in range(0, n_sec, SOS_GROUP)]))


def sos_carry_table(co: np.ndarray) -> np.ndarray:
    """The kernel's ``phi`` argument, read-only and cached per coefficient
    set: for each group of up to 16 sections in order, its chunk transition's
    powers (ops/iir.py ``sos_chunk_powers``), flattened."""
    co = np.ascontiguousarray(co, np.float32)
    return _carry_table(co.tobytes(), co.shape[0])


def iir_sos_ref(x: torch.Tensor, sos, state: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`iir_sos`: ops/iir.py ``sos_apply``, a loop over
    time in the kernel's update order."""
    from .iir import sos_apply
    return sos_apply(x, sos, state)


# -- fused FIR + quadrature demod ----------------------------------------------

def fir_demod(xc: torch.Tensor, taps, decim: int, prev: torch.Tensor,
              gain: float) -> torch.Tensor:
    """Decimating FIR fused with the quadrature demod: ``v = FIR(xc)`` as
    :func:`fir_banded` frames it, then ``gain·arg(v[m]·conj v[m−1])`` with
    ``v[−1] = prev``. ``xc``: history-prefixed complex64 ``[T+K−1]`` or
    ``[C, T+K−1]``; ``taps``: [K] float32 or complex64; ``prev``: complex64
    ``[]`` or ``[C]``. Returns float32 ``[..., T // decim]``. CPU tensors take
    :func:`fir_demod_ref`; CUDA tensors launch the kernel in
    ``csrc/fir_demod.cu``."""
    if xc.device.type == "cpu":
        return fir_demod_ref(xc, taps, decim, prev, gain)
    name = "fir_demod"
    if xc.dtype != torch.complex64 or prev.dtype != torch.complex64:
        raise GrError(f"{name}: stream and prev must be complex64; got "
                      f"{xc.dtype}, {prev.dtype}")
    dev = _require_cuda(name, xc, prev)
    h = _device_taps(taps, dev)
    if h.dtype not in (torch.complex64, torch.float32) or h.ndim != 1:
        raise GrError(f"{name}: taps must be 1-D float32 or complex64")
    k = h.shape[0]
    t = xc.shape[-1] - (k - 1)
    if decim < 1 or xc.ndim not in (1, 2) or t < 0 \
            or prev.shape != xc.shape[:-1]:
        raise GrError(f"{name}: bad shapes xc{tuple(xc.shape)} prev"
                      f"{tuple(prev.shape)} taps[{k}] decim={decim}")
    channels = 1 if xc.ndim == 1 else xc.shape[0]
    y = torch.empty((*xc.shape[:-1], t // decim), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    err = build().lib.gr4_fir_demod(
        xc.data_ptr(), h.data_ptr(), prev.data_ptr(), y.data_ptr(), channels, t,
        k, int(decim), int(h.is_complex()), float(gain), _stream(dev))
    _check(err, name)
    fir_demod.launches += 1
    return y


fir_demod.launches = 0


def fir_demod_ref(xc: torch.Tensor, taps, decim: int, prev: torch.Tensor,
                  gain: float) -> torch.Tensor:
    """Plain version of :func:`fir_demod`: :func:`fir_banded_ref` then
    ops/demod.py ``quadrature_demod``."""
    from .demod import quadrature_demod
    k = len(_host_taps(taps))
    v = fir_banded_ref(xc[..., k - 1:], xc[..., : k - 1], taps, decim)
    y, _ = quadrature_demod(v, prev, gain=float(np.float32(gain)))
    return y


# -- first-order recurrence ------------------------------------------------------

# csrc/one_pole.cu's geometry (its wrapper checks that the library reports the
# same): threads a block, samples a thread, and powers p^(2^j) in its table
ONE_POLE_THREADS = 256
ONE_POLE_STRETCH = 16
ONE_POLE_LEVELS = 32


@functools.lru_cache(maxsize=64)
def one_pole_powers(pole, cx: bool) -> np.ndarray:
    """[ONE_POLE_LEVELS] p^(2^j), read-only and cached per pole: the pole
    rounded to complex64 (``cx``) or float32, squared in float64 and each
    power rounded back. Entry 0 is the rounded pole itself."""
    p = np.complex128(np.complex64(pole) if cx else np.float32(complex(pole).real))
    out = np.empty(ONE_POLE_LEVELS, np.complex128)
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        for j in range(ONE_POLE_LEVELS):
            out[j] = p
            p = p * p
    return frozen(out.astype(np.complex64) if cx else out.real.astype(np.float32))


@functools.lru_cache(maxsize=1)
def _one_pole_lib() -> ctypes.CDLL:
    """The library, after checking that csrc/one_pole.cu has this module's
    geometry (the host builds the table, the plain version mirrors the
    tiles)."""
    lib = build().lib
    got = (lib.gr4_one_pole_threads(), lib.gr4_one_pole_stretch(),
           lib.gr4_one_pole_levels())
    want = (ONE_POLE_THREADS, ONE_POLE_STRETCH, ONE_POLE_LEVELS)
    if got != want:
        raise GrError(f"one_pole: csrc/one_pole.cu has (threads, stretch, levels) "
                      f"{got}, ops/cuda_kernels.py {want}")
    return lib


# the look-back's workspaces, zeroed once, by (device, stream): launches on one
# stream never overlap, and each advances its workspace's epoch itself
_one_pole_work: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}


def _one_pole_workspace(lib: ctypes.CDLL, dev: torch.device, stream: int,
                        tiles: int) -> tuple[torch.Tensor, int]:
    key = (dev.index, stream)
    work, cap = _one_pole_work.get(key, (None, 0))
    if cap < tiles:
        cap = max(tiles, 2 * cap)
        work = torch.zeros(-(-lib.gr4_one_pole_work_size(cap) // 4),
                           dtype=torch.int32, device=dev)
        _one_pole_work[key] = (work, cap)
    return work, cap


def one_pole(x: torch.Tensor, pole, state: torch.Tensor, gain_x: float = 0.0,
             gain_u: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The first-order recurrence ``u[n] = p·u[n−1] + x[n]`` over the last
    axis, with ``u[−1] = state``, and ``y = gain_x·x + gain_u·u``. ``x``:
    float32 (a real pole) or complex64 ``[..., T]``; ``state``: ``x.shape[:-1]``
    of the same type; the pole a host constant, rounded to the stream's type;
    the gains real. Returns ``(y, u[..., T−1])``. CPU tensors take
    :func:`one_pole_ref`; CUDA tensors launch the kernel in
    ``csrc/one_pole.cu``: one launch a call, whatever the shape."""
    if x.device.type == "cpu":
        return one_pole_ref(x, pole, state, gain_x, gain_u)
    name = "one_pole"
    if x.dtype not in (torch.float32, torch.complex64) or state.dtype != x.dtype:
        raise GrError(f"{name}: stream and state must both be float32 or "
                      f"complex64; got {x.dtype}, {state.dtype}")
    cx = x.is_complex()
    if not cx and complex(pole).imag != 0.0:
        raise GrError(f"{name}: a complex pole needs a complex64 stream")
    dev = _require_cuda(name, x, state)
    if x.ndim < 1 or state.shape != x.shape[:-1]:
        raise GrError(f"{name}: bad shapes x{tuple(x.shape)} state"
                      f"{tuple(state.shape)}")
    t = x.shape[-1]
    channels = state.numel()
    y = torch.empty_like(x)
    new_state = torch.empty_like(state)
    if channels == 0 or t == 0:
        new_state.copy_(state)
        return y, new_state
    lib = _one_pole_lib()
    stream = _stream(dev)
    tiles = channels * -(-t // (ONE_POLE_THREADS * ONE_POLE_STRETCH))
    work, cap = _one_pole_workspace(lib, dev, stream, tiles)
    err = lib.gr4_one_pole(x.data_ptr(), y.data_ptr(), state.data_ptr(),
                           new_state.data_ptr(), one_pole_powers(pole, cx).ctypes.data,
                           work.data_ptr(), cap, channels, t, int(cx),
                           float(gain_x), float(gain_u), stream)
    _check(err, name)
    one_pole.launches += 1
    return y, new_state


one_pole.launches = 0


def one_pole_ref(x: torch.Tensor, pole, state: torch.Tensor, gain_x: float = 0.0,
                 gain_u: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`one_pole`: the kernel's algorithm in PyTorch,
    which ``chip_smoke.py`` holds the kernel to on the card. Each channel is cut into tiles of THREADS·STRETCH samples
    (the last padded with zeros), each tile into warps of 32 stretches of
    STRETCH samples; every stretch runs from the zero state; a scan over the
    warp's stretches, then over the tile's warps, with the powers of
    :func:`one_pole_powers`, gives each stretch's zero-state entering state;
    the tiles' entering states chain from ``state`` with p^tile; every
    stretch runs again from its full entering state and gives y. The same
    result as the sequential loop in exact arithmetic."""
    cx = x.is_complex()
    pw = [complex(v) if cx else float(v) for v in one_pole_powers(pole, cx)]
    p, r, lanes = pw[0], ONE_POLE_STRETCH, 32
    warps = ONE_POLE_THREADS // lanes
    tile = ONE_POLE_THREADS * r
    r_log, t_log = int(math.log2(r)), int(math.log2(tile))

    def power(base: int, n: int):
        v = 1.0
        for b in range(n.bit_length()):
            if n >> b & 1:
                v = v * pw[base + b]
        return v

    def scan(v: torch.Tensor, base: int) -> torch.Tensor:
        """Inclusive scan over the last axis of w_i = P·w_(i−1) + v_i, P the
        table's power ``base`` (one element apart)."""
        d, j = 1, 0
        while d < v.shape[-1]:
            nxt = v.clone()
            nxt[..., d:] = v[..., d:] + pw[base + j] * v[..., :-d]
            v, d, j = nxt, 2 * d, j + 1
        return v

    t = x.shape[-1]
    c = state.numel()
    if c == 0 or t == 0:
        return x.clone(), state.clone()
    k = -(-t // tile)
    xs = torch.nn.functional.pad(x.reshape(c, t), (0, k * tile - t))
    xs = xs.reshape(c, k, warps, lanes, r)
    u = torch.zeros(xs.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(r):
        u = p * u + xs[..., j]
    w = scan(u, r_log)                                     # in each warp
    before = torch.nn.functional.pad(w[..., :-1], (1, 0))
    v = scan(w[..., -1], r_log + 5)                        # over the warps
    warp_in = torch.nn.functional.pad(v[..., :-1], (1, 0))
    enter = [state.reshape(c).to(x.dtype)]
    for i in range(k - 1):
        enter.append(pw[t_log] * enter[-1] + v[:, i, -1])
    tile_in = torch.stack(enter, dim=1)                    # [C, K]
    warp_pow = torch.tensor([power(r_log + 5, i) for i in range(warps)],
                            dtype=x.dtype, device=x.device)
    lane_pow = torch.tensor([power(r_log, i) for i in range(lanes)],
                            dtype=x.dtype, device=x.device)
    into_warp = warp_in + warp_pow * tile_in[..., None]
    u = before + lane_pow * into_warp[..., None]
    us, ys = [], []
    for j in range(r):
        u = p * u + xs[..., j]
        us.append(u)
        ys.append(gain_u * u + gain_x * xs[..., j] if gain_x else gain_u * u)
    y = torch.stack(ys, dim=-1).reshape(c, k * tile)[:, :t]
    last = torch.stack(us, dim=-1).reshape(c, k * tile)[:, t - 1]
    return y.reshape(x.shape), last.reshape(state.shape)


KERNELS = (fir_banded, nco_mix, iir_sos, fir_demod, one_pole)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    fir_banded.phase_groups = 0


def launch_counts() -> dict[str, int]:
    """Launches by wrapper, and ``fir_banded.phase_groups``: those of
    ``fir_banded``'s launches that took its phase-grouped path."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts["fir_banded.phase_groups"] = fir_banded.phase_groups
    return counts
