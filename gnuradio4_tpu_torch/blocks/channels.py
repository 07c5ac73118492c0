"""Channel simulation models (≈ GNU Radio's gr-channels; the JAX package's
``blocks/channels.py``), all on the device so impairments run beside the
receiver under test.

- :class:`ChannelModel`: AWGN (the threefry stream of ``ops/noise.py``, key
  in state) + carrier frequency offset (a uint32 integer-NCO phase, carried
  as a host int, drift-free) + static multipath taps (FIR with carried
  history).
- :class:`FadingModel`: flat Rayleigh/Rician fading by the Jakes
  sum-of-sinusoids method; the per-sinusoid phases ride in state (mod 2π).
- :class:`SelectiveFadingModel`: per-tap independent Jakes processes on a
  static delay line (a time-varying FIR as a weighted sum of delayed copies).
- :class:`PhaseNoise` (a Wiener phase walk) and :class:`IqImbalanceGen`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block, Port
from ..core.registry import register_block
from ..core.settings import Setting
from ..ops.cuda_kernels import device_constant
from ..ops.noise import gaussian, noise_init_state, split
from ..ops.signal import MASK32
from .basic import phase_state

_TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def _jakes_params(n_sinusoids: int, seed: int, tap: int = 0):
    """Random arrival angles + phases for one Jakes process (host, static)."""
    rng = np.random.default_rng((seed << 8) ^ tap)
    alpha = rng.uniform(0.0, 2.0 * np.pi, n_sinusoids)
    phi = rng.uniform(0.0, 2.0 * np.pi, n_sinusoids)
    psi = rng.uniform(0.0, 2.0 * np.pi, n_sinusoids)
    return (alpha.astype(np.float32), phi.astype(np.float32),
            psi.astype(np.float32))


def _jakes_w(fd: float, alpha: np.ndarray) -> np.ndarray:
    return (2.0 * np.pi * fd * np.cos(alpha)).astype(np.float32)


def _jakes_gain(arg0: torch.Tensor, w: np.ndarray, T: int, phi, psi
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex Jakes gain for ``T`` samples from carried per-sinusoid
    phases ``arg0`` [N]; returns (gain [T], new arg0). Carrying phases
    (mod 2π) instead of absolute time keeps precision on unbounded
    streams. E[|g|²] = 1."""
    dev = arg0.device
    n = len(w)
    w_d = device_constant(w, dev)
    idx = torch.arange(T, dtype=torch.float32, device=dev)
    arg = arg0[None, :] + idx[:, None] * w_d[None, :]
    s = float(np.float32(np.sqrt(2.0 * n)))
    re = torch.cos(arg + device_constant(phi, dev)[None, :]) / s
    im = torch.sin(arg + device_constant(psi, dev)[None, :]) / s
    g = torch.complex(re.sum(-1), im.sum(-1)) * float(np.float32(np.sqrt(2.0)))
    new0 = torch.remainder(arg0 + w_d * float(T), _TWO_PI_F32)
    return g, new0


@register_block("ChannelModel")
class ChannelModel(Block):
    """AWGN + CFO + static multipath (≈ gr::channels::channel_model).

    ``noise_voltage`` is the per-component std of the complex AWGN;
    ``frequency_offset`` is normalized (cycles/sample, like the GNU Radio
    block); ``taps`` is the static channel impulse response. The noise key
    advances by two draws each step whatever the voltage; at voltage 0 the
    draws themselves (which would add zeros) are skipped, as is the mixer at
    a zero offset (a product with 1 + 0j)."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    noise_voltage = Setting(default=0.0)
    frequency_offset = Setting(default=0.0,
                               description="normalized CFO, cycles/sample")
    seed = Setting(default=0, kind="static")
    taps = Setting(default=(1.0 + 0.0j,), kind="static")

    SAMPLE_ACCURATE = frozenset()

    def _taps(self) -> np.ndarray:
        return np.atleast_1d(np.asarray(
            self.settings.get("taps"), np.complex64))

    def prepare_params(self, params):
        cfo = float(self.settings.get("frequency_offset"))
        params = dict(params)
        params["cfo_inc"] = np.uint32(int(round((cfo % 1.0) * (1 << 32)))
                                      & 0xFFFFFFFF)
        return params

    def init_state(self, ctx):
        taps = self._taps()
        return {"key": noise_init_state(int(self.settings.get("seed")),
                                        ctx.device),
                "phase": phase_state(),
                "hist": torch.zeros(max(len(taps) - 1, 1),
                                    dtype=torch.complex64, device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        t = x.shape[-1]
        taps = self._taps()
        nt = len(taps)
        hist = state["hist"]
        if nt > 1:
            # multipath: carried history keeps the convolution seamless
            ext = torch.cat([hist[-(nt - 1):], x])
            y = torch.zeros_like(x)
            for k in range(nt):
                y = y + complex(taps[k]) * ext[nt - 1 - k:nt - 1 - k + t]
            new_hist = ext[-(nt - 1):]
        else:
            y = complex(taps[0]) * x
            new_hist = hist
        # CFO: the uint32 phase accumulator, masked to 32 bits; the increment
        # is derived on the host in float64 (prepare_params)
        inc = int(ctx.p("cfo_inc", 0))
        ph0 = int(state["phase"])
        if inc:
            idx = torch.arange(1, t + 1, dtype=torch.int64, device=x.device)
            ang = ((ph0 + inc * idx) & MASK32).to(torch.float32) \
                * float(np.float32(2.0 * np.pi / (1 << 32)))
            y = y * torch.complex(torch.cos(ang), torch.sin(ang))
        # AWGN: two normal draws, each from the second key of a split
        nv = float(np.float32(ctx.p("noise_voltage", 0.0)))
        key = state["key"]
        if nv:
            re, key = gaussian(key, x.shape)
            im, key = gaussian(key, x.shape)
            y = y + torch.complex(re * nv, im * nv)
        else:
            key = split(split(key)[0])[0]
        return ({"key": key, "phase": phase_state(ph0 + inc * t),
                 "hist": new_hist}, {"out": y})


@register_block("FadingModel")
class FadingModel(Block):
    """Flat Rayleigh/Rician fading (Jakes sum-of-sinusoids,
    ≈ gr::channels::fading_model). ``fD`` is the normalized maximum Doppler
    (cycles/sample); ``K`` the Rician LOS factor (0 = Rayleigh);
    E[|gain|²] = 1 either way."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    fD = Setting(default=1e-4, kind="static",
                 description="normalized max Doppler (cycles/sample)")
    K = Setting(default=0.0, kind="static",
                description="Rician K factor (0 = Rayleigh)")
    n_sinusoids = Setting(default=8, kind="static")
    los_doppler = Setting(default=0.7, kind="static",
                          description="LOS Doppler as a fraction of fD")
    seed = Setting(default=0, kind="static")

    def init_state(self, ctx):
        ns = int(self.settings.get("n_sinusoids"))
        return {"arg": torch.zeros(ns, dtype=torch.float32, device=ctx.device),
                "los": torch.zeros((), dtype=torch.float32, device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        T = x.shape[-1]
        alpha, phi, psi = _jakes_params(int(self.settings.get("n_sinusoids")),
                                        int(self.settings.get("seed")))
        fd = float(self.settings.get("fD"))
        g, arg = _jakes_gain(state["arg"], _jakes_w(fd, alpha), T, phi, psi)
        K = float(self.settings.get("K"))
        new_los = state["los"]
        if K > 0.0:
            los_w = float(np.float32(2.0 * np.pi * fd
                                     * float(self.settings.get("los_doppler"))))
            idx = torch.arange(T, dtype=torch.float32, device=x.device)
            ph = state["los"] + idx * los_w
            los = torch.complex(torch.cos(ph), torch.sin(ph))
            g = (g + los * float(np.float32(np.sqrt(K)))) \
                / float(np.float32(np.sqrt(1.0 + K)))
            new_los = torch.remainder(state["los"] + los_w * T, _TWO_PI_F32)
        return ({"arg": arg, "los": new_los},
                {"out": (x * g).to(torch.complex64)})


@register_block("SelectiveFadingModel")
class SelectiveFadingModel(Block):
    """Frequency-selective fading (≈ gr::channels::selective_fading_model):
    a static delay line (``delays`` in samples, ``mags`` per-tap amplitudes)
    whose taps fade as independent Jakes processes — a time-varying FIR as
    a weighted sum of delayed copies, history carried in state."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    fD = Setting(default=1e-4, kind="static")
    n_sinusoids = Setting(default=8, kind="static")
    delays = Setting(default=(0, 3, 7), kind="static")
    mags = Setting(default=(1.0, 0.6, 0.3), kind="static")
    seed = Setting(default=0, kind="static")

    def _pdp(self):
        d = np.asarray(self.settings.get("delays"), np.int64)
        m = np.asarray(self.settings.get("mags"), np.float32)
        m = m / np.sqrt(np.sum(m ** 2))          # unit average power
        return d, m

    def init_state(self, ctx):
        d, _ = self._pdp()
        ns = int(self.settings.get("n_sinusoids"))
        return {"arg": torch.zeros((len(d), ns), dtype=torch.float32,
                                   device=ctx.device),
                "hist": torch.zeros(max(int(d.max()), 1), dtype=torch.complex64,
                                    device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        T = x.shape[-1]
        d, m = self._pdp()
        dmax = int(d.max())
        ext = torch.cat([state["hist"][-dmax:], x]) if dmax else x
        fd = float(self.settings.get("fD"))
        ns = int(self.settings.get("n_sinusoids"))
        y = torch.zeros_like(x)
        args = []
        for k, (dk, mk) in enumerate(zip(d, m)):
            alpha, phi, psi = _jakes_params(ns, int(self.settings.get("seed")),
                                            tap=k + 1)
            g, a = _jakes_gain(state["arg"][k], _jakes_w(fd, alpha), T,
                               phi, psi)
            args.append(a)
            xk = ext[dmax - int(dk):dmax - int(dk) + T] if dmax else x
            y = y + g * float(mk) * xk
        new_hist = ext[-dmax:] if dmax else state["hist"]
        return ({"arg": torch.stack(args), "hist": new_hist},
                {"out": y.to(torch.complex64)})


@register_block("PhaseNoise")
class PhaseNoise(Block):
    """Oscillator phase noise (≈ gr::channels::phase_noise_gen): a Wiener
    random walk, φ[n] = φ[n−1] + N(0, std²), applied as e^{jφ}. The walk
    value and PRNG key carry in state, so the trajectory is continuous
    across steps and reproducible by seed."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    std = Setting(default=0.001,
                  description="per-sample phase-increment std (radians)")
    seed = Setting(default=0, kind="static")

    def init_state(self, ctx):
        return {"key": noise_init_state(int(self.settings.get("seed")),
                                        ctx.device),
                "phi": torch.zeros((), dtype=torch.float32, device=ctx.device)}

    def apply(self, state, ins, ctx):
        x = ins["in"]
        std = float(np.float32(ctx.p("std", 0.0)))
        dphi, key = gaussian(state["key"], x.shape[-1:])
        walk = state["phi"] + torch.cumsum(dphi * std, dim=-1)
        y = x * torch.complex(torch.cos(walk), torch.sin(walk))
        # wrap the carried phase so an unbounded stream never loses precision
        new_phi = torch.remainder(walk[-1], _TWO_PI_F32)
        return {"key": key, "phi": new_phi}, {"out": y}


@register_block("IqImbalanceGen")
class IqImbalanceGen(Block):
    """Transmit-side IQ imbalance (≈ gr::channels::iqbal_gen): amplitude
    skew ``magnitude`` (dB) and ``phase`` (degrees) applied to the I rail —
    the image-generating impairment an RX-side corrector undoes."""

    IN = (Port("in", dtype="complex64"),)
    OUT = (Port("out", dtype="complex64"),)
    magnitude = Setting(default=0.0, description="amplitude skew (dB)")
    phase = Setting(default=0.0, description="phase skew (degrees)")

    def apply(self, state, ins, ctx):
        x = ins["in"]
        f32 = np.float32
        mag = float(f32(10.0) ** (f32(ctx.p("magnitude", 0.0)) / f32(20.0)))
        tan = float(np.tan(f32(ctx.p("phase", 0.0)) * f32(np.pi / 180.0)))
        i = x.real * mag
        q = x.imag + x.real * tan * mag
        return state, {"out": torch.complex(i, q)}
