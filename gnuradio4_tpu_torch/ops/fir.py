"""FIR filtering (overlap-save, decimating, frequency-translating, polyphase).

Reference capability: per-sample FIR with a HistoryBuffer of tap history
(blocks/filter/include/gnuradio-4.0/filter/time_domain_filter.hpp:24 ``fir_filter``;
history: core HistoryBuffer.hpp:68).

Overlap-save over time blocks: the carried state is the last ``ntaps-1`` input
samples (the exact analog of the HistoryBuffer tail); each step filters
``[state, x]`` "valid", producing ``len(x) // decim`` outputs.

``fir_apply``'s lowerings, selected by ``method``:

- ``pallas`` / ``pallas_ilv`` (and ``auto`` on every device), for real and
  complex streams: :func:`~.cuda_kernels.fir_banded`, the hand-written CUDA
  kernel for a CUDA tensor, its plain banded-matmul version for a CPU tensor;
- ``matmul``: the banded-Toeplitz ``torch.matmul`` form (the JAX package's
  ``_fir_matmul``: :func:`~.cuda_kernels.fir_banded_ref` at the precision
  rung, see ``ops/precision.py``);
- ``matmul_int8``: the same product with row-quantized int8 frames against
  a globally scaled int8 Toeplitz (:func:`_fir_matmul_int8`);
- ``matmul_ilv``: the same product on the ``view_as_real`` of a complex
  stream against the interleaved Toeplitz (a real stream takes ``matmul``);
- ``fft``: FFT overlap-save over ``torch.fft``;
- ``conv``: ``F.conv1d`` with the decimation as its stride, with cuDNN's
  TF32 off for the call.

:func:`fir_quad_demod_fused` is the FIR fused with the quadrature demod
(:func:`~.cuda_kernels.fir_demod`); :func:`fir_interpolate` and
:func:`fir_resample_matmul` are the polyphase interpolator and the one-matmul
rational resampler.

The precision rungs (``precision=``, the JAX package's ladder): an explicit
rung with host taps and K ≤ 512 takes ``matmul`` (``int8`` takes
``matmul_int8``); any other explicit rung raises. With no rung, ``matmul``
and ``matmul_ilv`` run at the process-wide mode ``GR4TPU_FIR_PRECISION``,
read as the JAX package reads it; its default here is ``highest`` (full
float32), where the JAX package's is ``high``.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import GrError
from ..core.stream import torch_dtype
from .cuda_kernels import (_choose_tile, _host_taps, _next_pow2,
                           _toeplitz_np, device_constant, fir_banded,
                           fir_banded_ref, fir_demod, frozen)
from .precision import RUNGS, int8_mm, quant_rows, rung_dot

# the precision rungs a block may name
PRECISIONS = ("auto", "default", "high", "highest", "bf16", "int8")
METHODS = ("auto", "conv", "fft", "matmul", "matmul_ilv", "matmul_int8",
           "pallas", "pallas_ilv")


def _live_mode() -> str:
    """The process-wide rung of the matmul paths: GR4TPU_FIR_PRECISION, read
    when the call runs (as the JAX package's ``_live_mode`` reads it); its
    default here is ``highest``, where the JAX package's is ``high``."""
    return os.environ.get("GR4TPU_FIR_PRECISION", "highest").lower()


def _rung(precision: str | None) -> str:
    """The pass-count rung of a matmul-path call: an explicit rung, else the
    live mode; a name that is no pass count (``int8``, unknown) → highest."""
    mode = _live_mode() if precision in (None, "auto") else precision
    return mode if mode in RUNGS else "highest"


def fir_init_state(channels: int, ntaps: int, dtype,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Zero prehistory of ``ntaps-1`` samples (≈ HistoryBuffer zero-init)."""
    shape = (ntaps - 1,) if channels == 0 else (channels, ntaps - 1)
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=device)


def _pad_right(xc: torch.Tensor, n: int) -> torch.Tensor:
    return xc if n == 0 else torch.cat([xc, xc.new_zeros(xc.shape[0], n)], -1)


def _conv1d_f32(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``F.conv1d`` in full float32: cuDNN takes TF32 under PyTorch's
    default flags, so TF32 is off for this call, every other flag as set."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv1d(x, w, stride=stride)


def _conv_valid(xc: torch.Tensor, taps_np: np.ndarray, stride: int) -> torch.Tensor:
    """``xc`` [B, T'] → [B, (T'−K)//stride + 1] through ``F.conv1d`` (a
    correlation, so the taps are flipped). Complex data or taps run as one real
    conv with two feature planes (re, im): y_r = x_r*t_r − x_i*t_i,
    y_i = x_r*t_i + x_i*t_r."""
    if not xc.is_complex() and not np.iscomplexobj(taps_np):
        w = device_constant(taps_np[::-1].astype(np.float32).reshape(1, 1, -1),
                            xc.device)
        return _conv1d_f32(xc[:, None, :], w, stride)[:, 0, :]
    t = np.asarray(taps_np, np.complex64)[::-1]
    tr, ti = t.real, t.imag
    w = device_constant(np.stack([np.stack([tr, -ti]), np.stack([ti, tr])]
                                 ).astype(np.float32), xc.device)
    xr = xc.real if xc.is_complex() else xc
    xi = xc.imag if xc.is_complex() else torch.zeros_like(xc)
    y = _conv1d_f32(torch.stack([xr, xi], dim=1), w, stride)
    return torch.complex(y[:, 0, :], y[:, 1, :])


def _frame_overlapping_general(xc: torch.Tensor, step: int, width: int
                               ) -> torch.Tensor:
    """Overlapping frames [B, n, width] at hop ``step`` of ``xc`` [B, T], with
    n = (T − (width − step)) // step; any overlap, a strided view."""
    return xc.unfold(-1, width, step)


def _fir_fft(xc: torch.Tensor, taps_np: np.ndarray, decim: int) -> torch.Tensor:
    """FFT overlap-save: frame step L, FFT size N = L + K − 1 (a power of two
    ≥ max(4K, 1024)); the valid region is the last L samples of each inverse
    transform."""
    b, tc = xc.shape
    k = taps_np.shape[-1]
    t = tc - (k - 1)
    cx = xc.is_complex() or np.iscomplexobj(taps_np)
    out_dt = torch.complex64 if cx else xc.dtype
    if t <= 0:
        return xc.new_zeros((b, 0), dtype=out_dt)
    nfft = 1 << int(np.ceil(np.log2(max(4 * k, 1024))))
    step = nfft - (k - 1)
    frames = _frame_overlapping_general(_pad_right(xc, (-t) % step), step, nfft)
    h = torch.fft.fft(device_constant(
        taps_np.astype(np.complex64 if cx else np.float32), xc.device), n=nfft)
    spec = torch.fft.fft(frames, n=nfft, dim=-1) * h
    y = torch.fft.ifft(spec, dim=-1)[..., k - 1:]
    y = y.reshape(b, -1)[:, :t]
    y = y.to(torch.complex64) if cx else y.real.to(xc.dtype)
    return y[:, ::decim] if decim > 1 else y


@lru_cache(maxsize=128)
def _toeplitz_ilv_np(taps_key, ntaps: int, tile: int, decim: int) -> np.ndarray:
    """Interleaved banded Toeplitz: works on the float32 view of a complex64
    stream (z[2m] = re x[m], z[2m+1] = im x[m]) and gives the float32 view of
    the complex output. Column 2i/2i+1 hold re/im of output i; row parity
    selects the input component: W[2j,2i] = +h_re, W[2j+1,2i] = −h_im,
    W[2j,2i+1] = +h_im, W[2j+1,2i+1] = +h_re, over the band h[i·decim+K−1−j]."""
    h = np.asarray(taps_key)           # complex128 (imag 0 for real taps)
    t_re = _toeplitz_np(tuple(h.real.tolist()), ntaps, tile, decim)
    t_im = _toeplitz_np(tuple(h.imag.tolist()), ntaps, tile, decim)
    rows, cols = t_re.shape
    w = np.zeros((2 * rows, 2 * cols), np.float32)
    w[0::2, 0::2] = t_re
    w[1::2, 0::2] = -t_im
    w[0::2, 1::2] = t_im
    w[1::2, 1::2] = t_re
    return w


@lru_cache(maxsize=64)
def _ilv_weights(taps_key, tile: int, decim: int) -> tuple[np.ndarray, np.ndarray]:
    """(W_lo, W_hi) [2·tile, 2·tile/decim] of the interleaved Toeplitz,
    read-only host arrays: y[m] = z[m] @ W_lo + z[m+1] @ W_hi over rows z of
    the padded float32 view."""
    k = len(taps_key)
    w = _toeplitz_ilv_np(taps_key, k, tile, decim)
    w_hi = np.zeros_like(w[: 2 * tile])
    w_hi[: 2 * (k - 1)] = w[2 * tile:]
    return frozen(np.ascontiguousarray(w[: 2 * tile]), w_hi)


def _fir_matmul_ilv(xc: torch.Tensor, taps_np: np.ndarray, decim: int
                    ) -> torch.Tensor:
    """Interleaved-rail banded matmul: ``view_as_real`` of the complex64
    stream (a free view: torch stores complex interleaved), two banded
    products against the interleaved Toeplitz, ``view_as_complex`` back."""
    b, tc = xc.shape
    k = taps_np.shape[-1]
    t = tc - (k - 1)
    tile = _choose_tile(t, k, decim)
    n = -(-t // tile)
    xc = _pad_right(xc.to(torch.complex64), (n + 1) * tile - tc)
    key = tuple(np.asarray(taps_np, np.complex128).tolist())
    w_lo, w_hi = (device_constant(w, xc.device)
                  for w in _ilv_weights(key, tile, decim))
    z = torch.view_as_real(xc).reshape(b, n + 1, 2 * tile)
    mode = _rung(None)
    y = rung_dot(z[:, :-1], w_lo, mode) + rung_dot(z[:, 1:], w_hi, mode)
    n_out = t // decim
    y = y.reshape(b, -1)[:, : 2 * n_out].reshape(b, n_out, 2)
    return torch.view_as_complex(y.contiguous())


@lru_cache(maxsize=64)
def _int8_weights(taps_key, ntaps: int, tile: int, decim: int
                  ) -> tuple[np.ndarray, float]:
    """The full banded Toeplitz [tile+K−1, tile/decim] quantized with one
    global scale (the taps are constants): (read-only int8 W, scale)."""
    w = _toeplitz_np(taps_key, ntaps, tile, decim)
    s = float(np.max(np.abs(w))) / 127.0 or 1.0
    return frozen(np.round(w / s).astype(np.int8)), s


def _fir_matmul_int8(xc: torch.Tensor, taps_np: np.ndarray, decim: int
                     ) -> torch.Tensor:
    """Quantized path (the JAX package's ``_fir_matmul_int8``): overlapping
    frames [B, n, tile+K−1], each row quantized to int8 with its own scale,
    times the globally scaled int8 Toeplitz, int32 sums, rescaled to
    float32. ``xc`` = [B, K−1+T]; returns [B, T // decim]."""
    b, tc = xc.shape
    k = taps_np.shape[-1]
    t = tc - (k - 1)
    tile = _choose_tile(t, k, decim)
    xc = _pad_right(xc, -(-t // tile) * tile - t)
    cx_t = np.iscomplexobj(taps_np)
    cx_x = xc.is_complex()

    def quant_w(h: np.ndarray):
        wq, s = _int8_weights(tuple(h.tolist()), k, tile, decim)
        return device_constant(wq, xc.device), s

    def qdot(frames: torch.Tensor, w) -> torch.Tensor:
        wq, w_scale = w
        fq, row_scale = quant_rows(frames)
        acc = int8_mm(fq.reshape(-1, fq.shape[-1]), wq)
        acc = acc.reshape(*fq.shape[:-1], wq.shape[-1])
        return acc.to(torch.float32) * (row_scale * float(np.float32(w_scale)))

    def frames_of(v: torch.Tensor) -> torch.Tensor:
        return _frame_overlapping_general(v.to(torch.float32), tile,
                                          tile + k - 1)

    if cx_x or cx_t:
        xr = xc.real if cx_x else xc
        fr = frames_of(xr)
        fi = frames_of(xc.imag if cx_x else torch.zeros_like(xr))
        if cx_t:
            wr, wi = quant_w(taps_np.real), quant_w(taps_np.imag)
            yr = qdot(fr, wr) - qdot(fi, wi)
            yi = qdot(fr, wi) + qdot(fi, wr)
        else:
            wr = quant_w(taps_np)
            yr, yi = qdot(fr, wr), qdot(fi, wr)
        y = torch.complex(yr, yi)
    else:
        y = qdot(frames_of(xc), quant_w(taps_np)).to(xc.dtype)
    return y.reshape(b, -1)[:, : t // decim]


def _check_method(method: str, precision: str | None) -> None:
    if method not in METHODS:
        raise GrError(f"fir_apply: unknown method {method!r}; known: {METHODS}")
    if precision is not None and precision not in PRECISIONS:
        raise GrError(f"fir_apply: unknown precision {precision!r}; known: "
                      f"{PRECISIONS}")


def fir_apply(x: torch.Tensor, taps, state: torch.Tensor, *, decim: int = 1,
              method: str = "auto", precision: str | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Overlap-save FIR step.

    ``x``: [T] or [C, T] (complex64 or float32); ``taps``: [K] real or complex
    (host array, uploaded once per device); ``state``: prehistory [*, K-1].
    Returns ``(y, new_state)`` with ``y`` of length T//decim (on the decimated
    grid aligned to the first input sample) and new_state = last K-1 inputs.
    A real stream with complex taps stays real (its history too); its output
    is complex. ``method``: see the module docstring. ``auto`` and ``pallas*``
    are the banded kernel for every stream on every device (its plain version
    on the CPU: the reference's ``matmul``, which its ``pallas*`` also takes
    for a real stream). A real stream with ``matmul_ilv`` takes ``matmul``,
    and one tap is every ``decim``-th sample, scaled, as in the reference.
    ``precision``: an explicit rung (``auto`` included) sends ``auto`` to
    ``matmul`` (``int8``: ``matmul_int8``) when the taps are host values and
    K ≤ 512, and raises ``GrError`` otherwise, as the reference does.
    """
    _check_method(method, precision)
    host_taps = not torch.is_tensor(taps)
    taps_np = _host_taps(taps)
    k = taps_np.shape[-1]
    x = x.contiguous()
    state = state.to(x.dtype).contiguous()
    squeeze = x.ndim == 1
    if method == "auto" and precision is not None:
        # an explicit precision rung is a matmul-path request (conv, fft and
        # the kernel have no pass-count ladder)
        if not (host_taps and k <= 512):
            raise GrError(
                f"fir_apply: precision={precision!r} requires the matmul "
                f"path (host taps, ntaps<=512; got ntaps={k}, "
                f"host_taps={host_taps}). Drop the explicit precision "
                f"setting (use 'auto') to run the default lowering at full "
                f"precision.")
        method = "matmul_int8" if precision == "int8" else "matmul"
    if method == "matmul_ilv" and not x.is_complex():
        method = "matmul"
    if precision == "int8" and method == "matmul":
        method = "matmul_int8"          # per-call quantized path
    if method == "auto":       # the banded kernel for real and complex streams
        method = "pallas"
    mode = _rung(precision)
    if k == 1:
        # the reference's conv with one tap: every decim-th sample, scaled
        h0 = taps_np[0].item()
        y = x[..., ::decim] * h0
        y = y.to(torch.complex64 if y.is_complex() else x.dtype)
    elif method in ("pallas", "pallas_ilv"):
        y = fir_banded(x, state, taps_np, decim)
    elif method == "matmul":
        y = fir_banded_ref(x, state, taps_np, decim, mode=mode)
    else:
        x2 = x[None] if squeeze else x
        st2 = state[None] if squeeze else state
        xc = torch.cat([st2, x2], dim=-1)
        if method == "matmul_int8":
            y = _fir_matmul_int8(xc, taps_np, decim)
        elif method == "matmul_ilv":
            y = _fir_matmul_ilv(xc, taps_np, decim)
        elif method == "fft":
            y = _fir_fft(xc, taps_np, decim)
        else:
            y = _conv_valid(xc, taps_np, decim)
        y = y[0] if squeeze else y
    t = x.shape[-1]
    if k == 1:
        new_state = x[..., :0].clone()
    elif t >= k - 1:
        new_state = x[..., t - (k - 1):].clone()
    else:
        new_state = torch.cat([state, x], dim=-1)[..., -(k - 1):]
    return y, new_state


@lru_cache(maxsize=128)
def _resample_toeplitz_np(taps_key, ntaps: int, interp: int, decim: int,
                          tile: int) -> np.ndarray:
    """Banded float32 weights W[j, i] (read-only) for rational L/M
    resampling as one matmul.

    frame[t][j] = xc[t·B + j] (xc = [K_p−1 prehistory, x]); output column
    i ∈ [0, B·L/M) of tile t is global output m = t·B·L/M + i, upsampled
    index u = m·M, phase p = u mod L = (i·M) mod L (tile-invariant), input
    n_local = (i·M)//L. Then y[m] = L·Σ_k h[k·L+p]·x[n−k] ⇒
    W[n_local + (K_p−1) − k, i] = L·h[k·L + p]."""
    h = np.asarray(taps_key)
    pad = (-len(h)) % interp
    hp = np.pad(h, (0, pad)).reshape(-1, interp)   # hp[k, p] = h[k·L + p]
    k_per_phase = hp.shape[0]
    n_out = tile * interp // decim
    w = np.zeros((tile + k_per_phase - 1, n_out), dtype=h.dtype)
    for i in range(n_out):
        p = (i * decim) % interp
        n_local = (i * decim) // interp
        for k in range(k_per_phase):
            w[n_local + (k_per_phase - 1) - k, i] = interp * hp[k, p]
    return frozen(w.astype(np.float32))


def fir_resample_matmul(xc: torch.Tensor, taps_np: np.ndarray, interp: int,
                        decim: int) -> torch.Tensor:
    """One-matmul rational resampler: frames [B, n, tile+K_p−1] @ W →
    [B, n·tile·L/M], trimmed to T·L/M. ``xc`` = [channels, (K_p−1) + T] with T
    divisible by ``decim``; ``taps_np`` host NumPy (the weights are built on
    the host and uploaded once per device). The last tile is zero-padded.
    The products run at the live rung (``GR4TPU_FIR_PRECISION``, through
    :func:`~.precision.rung_dot`), as the JAX package's ``_banded_dot``
    does; ``highest`` is the plain float32 matmul, guarded by
    :func:`~.precision.check_f32_matmul` in ``rung_dot``."""
    mode = _rung(None)
    dot = lambda a, w: rung_dot(a, w, mode)
    b, tc = xc.shape
    k_total = taps_np.shape[-1]
    k_per_phase = -(-k_total // interp)
    t = tc - (k_per_phase - 1)
    base = max(128, _next_pow2(k_per_phase - 1))
    tile = base * decim // math.gcd(base, decim)
    tile = min(tile, max(_next_pow2(max(t, 1)), decim))
    xc = _pad_right(xc, -(-t // tile) * tile - t)
    n_out_true = t * interp // decim
    cx_t = np.iscomplexobj(taps_np)
    mk = lambda arr: device_constant(_resample_toeplitz_np(
        tuple(arr.tolist()), k_total, interp, decim, tile), xc.device)
    wr = mk(taps_np.real if cx_t else taps_np)
    wi = mk(taps_np.imag) if cx_t else None
    frame_len = tile + k_per_phase - 1
    if xc.is_complex() or cx_t:
        xr = xc.real if xc.is_complex() else xc
        fr = _frame_overlapping_general(xr.float(), tile, frame_len)
        fi = (_frame_overlapping_general(xc.imag.float(), tile, frame_len)
              if xc.is_complex() else None)
        if wi is None:
            yr, yi = dot(fr, wr), dot(fi, wr)
        elif fi is None:
            yr, yi = dot(fr, wr), dot(fr, wi)
        else:
            yr = dot(fr, wr) - dot(fi, wi)
            yi = dot(fr, wi) + dot(fi, wr)
        y = torch.complex(yr, yi)
    else:
        y = dot(_frame_overlapping_general(xc, tile, frame_len).float(), wr
                ).to(xc.dtype)
    return y.reshape(b, -1)[:, :n_out_true]


def fir_interpolate(x: torch.Tensor, taps, state: torch.Tensor, interp: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Polyphase interpolating FIR: T inputs → T·interp outputs.

    The taps split into ``interp`` phases on the host; each phase filters the
    input stream through :func:`fir_apply` (the banded kernel on the card),
    and the outputs interleave."""
    taps_h = _host_taps(taps)
    pad = (-taps_h.shape[-1]) % interp
    phases = np.pad(taps_h, (0, pad)).reshape(-1, interp).T   # [interp, K_p]
    k_per_phase = phases.shape[1]
    squeeze = x.ndim == 1
    x2 = x[None] if squeeze else x
    st2 = state[None] if squeeze else state
    outs = [fir_apply(x2, np.ascontiguousarray(ph), st2)[0] for ph in phases]
    y = torch.stack(outs, dim=-1).reshape(x2.shape[0], -1) * interp
    xc = torch.cat([st2.to(x2.dtype), x2], dim=-1)
    new_state = xc[:, xc.shape[-1] - (k_per_phase - 1):].clone()
    if squeeze:
        return y[0], new_state[0]
    return y, new_state


def freq_xlating_taps(taps: np.ndarray, center_freq: float, sample_rate: float
                      ) -> np.ndarray:
    """Heterodyne low-pass taps up to ``center_freq`` (frequency-xlating FIR design)."""
    n = np.arange(len(taps), dtype=np.float64)
    rot = np.exp(1j * 2.0 * np.pi * center_freq / sample_rate * n)
    return (np.asarray(taps, dtype=np.float64) * rot).astype(np.complex64)


def fir_quad_demod_fused(xc: torch.Tensor, taps_np: np.ndarray, decim: int,
                         prev: torch.Tensor, gain: float) -> torch.Tensor:
    """Decimating FIR fused with the quadrature demod: only the float32 demod
    output is written, the complex FIR output never reaches device memory.
    ``xc``: [1, T + K - 1] (or [C, T + K - 1]) history-prefixed complex64
    stream; ``prev``: the last FIR output of the previous chunk, v[-1]
    (complex scalar, or [C]). Returns [1, T // decim] float32. No carry is
    returned: the caller keeps the FIR history and v[-1] itself.

    A CUDA tensor launches the ``fir_demod`` kernel, which takes every shape;
    a CPU tensor takes its plain version (FIR then demod)."""
    xc = xc.to(torch.complex64).contiguous()
    prev = torch.as_tensor(prev, dtype=torch.complex64, device=xc.device)
    if prev.shape != xc.shape[:-1]:
        prev = prev.reshape(()).expand(xc.shape[:-1])
    return fir_demod(xc, taps_np, int(decim), prev.contiguous(), gain)
