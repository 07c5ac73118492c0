"""Fourier blocks (≈ reference blocks/fourier/fft.hpp:33).

The FFT block consumes ``k·fft_size`` samples per step and emits the spectra as a
stream (one spectrum per chunk, concatenated), through ``torch.fft.fft`` or,
with ``engine="matmul_exact"|"matmul"|"matmul_bf16"``, the four-step matmul
FFT (ops/fft.py ``matmul_fft``) at the precision rung ``highest``, ``high``
or ``bf16``. ``IFFT`` is the inverse (complex in, complex out); its ``auto``
engine is decided from the device.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..core.stream import torch_dtype
from ..ops.fft import (MATMUL_ENGINES, fftshift, magnitude, magnitude_db,
                       matmul_fft, spectrum_scale)
from ..ops.windows import WINDOWS, make_window


def _matmul_size(n: int) -> bool:
    """The matmul FFT's sizes: powers of two 64..65536 (the reference's
    bounds: its factor matrices are dense host constants); others take
    torch.fft under every engine."""
    return 64 <= n <= 65536 and n & (n - 1) == 0


def _fft(frames: torch.Tensor, n: int, engine: str) -> torch.Tensor:
    """Forward transform of the last axis by ``engine``."""
    if engine in MATMUL_ENGINES and _matmul_size(n):
        return matmul_fft(frames, n, mode=MATMUL_ENGINES[engine])
    return torch.fft.fft(frames, dim=-1)


@register_block("FFT")
class FFT(Block):
    """Windowed chunked FFT (≈ blocks/fourier FFT).

    outputs per chunk of ``fft_size`` inputs: ``fft_size`` output samples on the
    selected view — complex spectrum, magnitude, dB, or power. ``shift`` centers DC.
    """

    IN = (Port("in"),)
    OUT = (Port("out"),)
    fft_size = Setting(default=1024, kind="static", limits=(2, 1 << 24))
    stride = Setting(default=0, kind="static", limits=(0, 1 << 24),
                     description="hop between windows; 0/fft_size = back-to-back,"
                                 " < fft_size = overlapping (≈ Stride NTTP)")
    window = Setting(default="Hann", kind="static", choices=WINDOWS + ("none",))
    output = Setting(default="magnitude", kind="static",
                     choices=("complex", "magnitude", "magnitude_db", "power"))
    shift = Setting(default=False, kind="static", description="fftshift spectra")
    calibrate = Setting(default=True, kind="static",
                        description="scale by window coherent gain / N")
    engine = Setting(default="auto", kind="static",
                     choices=("auto", "xla", "matmul", "matmul_exact",
                              "matmul_bf16"),
                     description="auto/xla → torch.fft; matmul_exact → "
                                 "four-step float32 matmul FFT (power-of-two "
                                 "sizes 64..65536, else torch.fft); matmul "
                                 "→ the same at the 'high' rung (bf16×3 on "
                                 "the card), matmul_bf16 → one bf16 pass")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._windows: dict[tuple, torch.Tensor | None] = {}

    def absorb_rotation(self, desc, port) -> bool:
        """Rotation-absorption consumer hook: a residual linear phase
        e^{j2π·frac32(m·dphi)/2³²} factors per frame into (unit phasor) ×
        e^{j…·l} — the phasor cancels in magnitude-class views and the ramp
        folds into a COMPLEX window at zero runtime cost. Complex output
        keeps the phase, so it cannot absorb."""
        return str(self.settings.get("output")) in ("magnitude",
                                                    "magnitude_db", "power")

    def _rotation_window(self, win_np, n: int):
        """Fold the absorbed residual rotation into the window (exact uint32
        phase grid, host float64). ``win_np``: host real window or None."""
        desc = (getattr(self, "_absorbed_rotation", None) or {}).get("in")
        if desc is None:
            return win_np
        ph = (np.arange(n, dtype=np.uint64) * np.uint64(
            desc["dphi_out"] % 4294967296)) & np.uint64(0xFFFFFFFF)
        ramp = np.exp(2j * np.pi * (ph.astype(np.float64) / 4294967296.0))
        w = ramp if win_np is None else np.asarray(win_np, np.float64) * ramp
        return w.astype(np.complex64)

    def _window(self, n: int, device: torch.device) -> torch.Tensor | None:
        """The (possibly rotation-folded) window on ``device``, uploaded once."""
        wname = str(self.settings.get("window"))
        desc = (getattr(self, "_absorbed_rotation", None) or {}).get("in")
        key = (str(device), wname, n, None if desc is None else desc["dphi_out"])
        if key not in self._windows:
            win_np = None if wname.lower() in ("none", "") else make_window(wname, n)
            win_np = self._rotation_window(win_np, n)
            self._windows[key] = None if win_np is None \
                else torch.from_numpy(np.ascontiguousarray(win_np)).to(device)
        return self._windows[key]

    def _stride(self) -> int:
        s = int(self.settings.get("stride"))
        return s if s > 0 else int(self.settings.get("fft_size"))

    @property
    def ratio(self):
        n = int(self.settings.get("fft_size"))
        s = self._stride()
        return Fraction(n, s)

    @property
    def alignment(self):
        return self._stride()

    def out_dtype(self, port, in_dtypes):
        return np.dtype(np.complex64 if self.settings.get("output") == "complex"
                        else np.float32)

    def init_state(self, ctx):
        n = int(self.settings.get("fft_size"))
        s = self._stride()
        if s >= n:
            return None
        ch = ctx.channels.get("in", 0)
        shape = (n - s,) if ch == 0 else (ch, n - s)
        return torch.zeros(shape, dtype=torch_dtype(ctx.dtype("in")),
                           device=ctx.device)

    def sp_halo(self, ctx):
        # overlap state is the last fft_size−stride inputs → default halo
        # converters apply (back-to-back windows are stateless/time-local)
        n = int(self.settings.get("fft_size"))
        s = self._stride()
        return 0 if s >= n else n - s

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("fft_size"))
        s = self._stride()
        win = self._window(n, x.device)
        if s >= n:
            frames = x.reshape(*x.shape[:-1], -1, n)
        else:
            # overlapping windows: carried (n−s)-sample history + strided view
            xc = torch.cat([state.to(x.dtype), x], dim=-1)
            frames = xc.unfold(-1, n, s)                # [..., k, n] view
            state = xc[..., xc.shape[-1] - (n - s):].clone()
        if win is not None:     # float32, or complex64 with an absorbed ramp
            frames = frames * win
        spec = _fft(frames, n, str(self.settings.get("engine")))
        if self.settings.get("shift"):
            spec = fftshift(spec)
        scale = 1.0
        if self.settings.get("calibrate"):
            # the ORIGINAL real window decides calibration (an absorbed
            # rotation ramp is unit-modulus — it moves the peak, not the gain)
            wname = str(self.settings.get("window"))
            wnp = None if wname.lower() in ("none", "") \
                else np.asarray(make_window(wname, n))
            scale = spectrum_scale(n, wnp, power=False, density=False,
                                   sample_rate=ctx.sample_rate)
        view = self.settings.get("output")
        if view == "complex":
            out = spec * complex(np.complex64(scale))
        elif view == "magnitude":
            out = magnitude(spec)
            if scale != 1.0:
                out = out * float(np.float32(scale))
        elif view == "magnitude_db":
            out = magnitude_db(spec * complex(np.complex64(scale)))
        elif view == "power":
            out = (spec.real ** 2 + spec.imag ** 2) * float(np.float32(scale * scale))
        else:
            raise ValueError(f"unknown output view {view}")
        # flatten chunk axis back into the stream: [..., n_chunks, n] → [..., T]
        return state, {"out": out.reshape(*x.shape[:-1], -1)}


@register_block("IFFT")
class IFFT(Block):
    """Inverse chunked FFT (complex in → complex out). ``engine=matmul*``
    runs the inverse as the conjugate of the four-step transform at that
    engine's rung (IFFT(x) = conj(FFT(conj(x)))/N). ``auto`` is torch.fft on every device:
    the JAX package's CPU choice, and on CUDA (cuFFT) the faster engine. cuFFT
    against the float32 matmul inverse over 2^22 samples on an NVIDIA H100
    80GB HBM3, 700.00 W (PERF.md §6): 0.0528 / 0.5515 ms at fft_size 1024,
    0.3205 / 1.6338 at 4096, 0.0593 / 0.6644 at 16384."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    fft_size = Setting(default=1024, kind="static", limits=(2, 1 << 24))
    engine = Setting(default="auto", kind="static",
                     choices=("auto", "xla", "matmul", "matmul_exact",
                              "matmul_bf16"))

    @property
    def alignment(self):
        return int(self.settings.get("fft_size"))

    def init_state(self, ctx):
        return None

    def apply(self, state, ins, ctx):
        x = ins["in"]
        n = int(self.settings.get("fft_size"))
        xr = x.reshape(*x.shape[:-1], -1, n)
        eng = str(self.settings.get("engine"))
        if eng in MATMUL_ENGINES and _matmul_size(n):
            y = torch.conj(matmul_fft(torch.conj(xr).resolve_conj(), n,
                                      mode=MATMUL_ENGINES[eng])) \
                * float(np.float32(1.0 / n))
        else:
            y = torch.fft.ifft(xr, dim=-1)
        return state, {"out": y.to(torch.complex64).reshape(*x.shape[:-1], -1)}
