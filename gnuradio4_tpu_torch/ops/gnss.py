"""GNSS (GPS L1 C/A) signal processing: Gold codes + FFT acquisition.

Beyond-reference model family — and, unlike the host-side frame decoders,
a DEVICE-side workload: acquisition is a 2-D search over Doppler × code
phase, evaluated as a batch of FFT circular correlations (one [D, N]
element-wise wipe + FFT per coherent block), and the whole constellation is
one [P, D, K, N] batch. Tracking is one Python loop over 1 ms blocks with
the channels as a batch axis. The code tables, the stimulus and the bit
decisions after tracking are host NumPy.

The entry points run on the card unless ``device="cpu"`` is asked for
(``device=None`` is :func:`~gnuradio4_tpu_torch.core.compiler.default_device`).

C/A codes are the standard 1023-chip Gold codes (IS-GPS-200: G1 = 1+x³+x¹⁰,
G2 = 1+x²+x³+x⁶+x⁸+x⁹+x¹⁰ with per-PRN G2 phase taps), validated against the
published first-10-chips octal table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.compiler import default_device
from ..core.errors import GrError
from .cuda_kernels import device_constant, frozen

# per-PRN G2 phase-select taps (IS-GPS-200 table 3-I, PRN 1..32)
_G2_TAPS = [(2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8), (2, 9),
            (3, 10), (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10),
            (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9), (1, 3), (4, 6),
            (5, 7), (6, 8), (7, 9), (8, 10), (1, 6), (2, 7), (3, 8), (4, 9)]

CHIP_RATE = 1.023e6
CODE_LEN = 1023


@functools.lru_cache(maxsize=None)
def ca_code(prn: int) -> np.ndarray:
    """1023-chip C/A Gold code for PRN 1..32, as ±1 float32."""
    if not 1 <= prn <= 32:
        raise ValueError("PRN must be 1..32")
    t1, t2 = _G2_TAPS[prn - 1]
    g1 = [1] * 10
    g2 = [1] * 10
    chips = np.empty(CODE_LEN, np.float32)
    for i in range(CODE_LEN):
        out = g1[9] ^ (g2[t1 - 1] ^ g2[t2 - 1])
        chips[i] = 1.0 - 2.0 * out          # 0 → +1, 1 → −1
        new1 = g1[2] ^ g1[9]
        new2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = [new1] + g1[:9]
        g2 = [new2] + g2[:9]
    return chips


def ca_code_first_octal(prn: int) -> int:
    """First 10 chips as the IS-GPS-200 octal check value."""
    chips = ca_code(prn)[:10]
    bits = (chips < 0).astype(int)          # −1 ↔ chip value 1
    return int("".join(map(str, bits)), 2)


def sampled_code(prn: int, fs: float, n: int) -> np.ndarray:
    """C/A code resampled to ``fs`` over ``n`` samples (code repeats each ms)."""
    chips = ca_code(prn)
    idx = (np.arange(n) * (CHIP_RATE / fs)).astype(np.int64) % CODE_LEN
    return chips[idx]


@functools.lru_cache(maxsize=64)
def _code_table(prns: tuple[int, ...], fs: float, n: int) -> np.ndarray:
    """[P, n] sampled codes of ``prns``, built once per (prns, fs, n) and
    read-only, so :func:`device_constant` uploads it once per device."""
    return frozen(np.stack([sampled_code(p, fs, n) for p in prns]))


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def doppler_grid(doppler_max: float, doppler_step: float) -> np.ndarray:
    """The float32 Doppler bins, Hz (the JAX package's ``jnp.arange(...,
    dtype=float32)``, which is NumPy's)."""
    return np.arange(-doppler_max, doppler_max + doppler_step / 2,
                     doppler_step, dtype=np.float32)


def _iq_tensor(iq, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(iq):
        return iq.to(device=device, dtype=torch.complex64)
    return torch.from_numpy(np.ascontiguousarray(iq, np.complex64)).to(device)


def acquire_metric(iq: torch.Tensor, code: torch.Tensor,
                   dopplers: torch.Tensor, *, fs: float,
                   n_coherent: int = 1) -> torch.Tensor:
    """Doppler × code-phase search surface [D, N] (on ``iq``'s device).

    For each Doppler bin: wipe the carrier, circularly correlate with the
    local code via FFT, magnitude-square; non-coherently sum ``n_coherent``
    consecutive 1-code blocks (robust to data-bit flips). A ``code`` of
    shape [P, N] gives [P, D, N]: the wiped spectra are computed once and
    the P correlations are one batched [P, D, K, N] inverse FFT.
    """
    n = code.shape[-1]
    x = iq[:n * n_coherent].reshape(n_coherent, n)
    t = (torch.arange(n * n_coherent, dtype=torch.float32, device=iq.device)
         / fs).reshape(n_coherent, n)
    # the JAX package's exp(-2j·π·f·t): the phase is (−2π·f)·t in float32
    theta = (dopplers * (-2.0 * np.pi))[:, None, None] * t[None]
    xw = x[None] * torch.polar(torch.ones_like(theta), theta)    # [D, K, N]
    # the wiped spectra do not depend on the code: P codes share them
    xf = torch.fft.fft(xw, dim=-1)
    cf = torch.conj(torch.fft.fft(code.to(torch.complex64), dim=-1))
    if code.ndim == 2:
        xf, cf = xf[None], cf[:, None, None, :]
    corr = torch.fft.ifft(xf * cf, dim=-1)
    return torch.sum(torch.abs(corr) ** 2, dim=-2)


def acquire(iq, prn: int, *, fs: float,
            doppler_max: float = 5000.0, doppler_step: float = 250.0,
            n_coherent: int = 2, threshold: float = 2.5,
            device=None) -> dict | None:
    """Acquire one PRN → {prn, doppler, code_phase, metric} or None.

    ``metric`` is peak / (second peak outside ±1 chip) — the standard
    acquisition quality ratio; ``threshold`` gates detection. ``iq`` (NumPy
    or a tensor) is searched on ``device``: :func:`acquire_all` for one PRN.
    """
    found = acquire_all(iq, fs=fs, prns=(prn,), doppler_max=doppler_max,
                        doppler_step=doppler_step, n_coherent=n_coherent,
                        threshold=threshold, device=device)
    return found[0] if found else None


def synthesize(prns_dopplers_phases: list[tuple], *,
               fs: float, n_ms: int = 4, amplitude: float = 1.0,
               rng: np.random.Generator | None = None,
               noise_std: float = 0.0) -> np.ndarray:
    """Composite baseband: Σ satellites (PRN, Doppler Hz, code-phase samples
    [, 50 bps nav bits]) + complex AWGN. Test/simulation stimulus. Nav bits
    BPSK-modulate the code at the 20 ms cadence."""
    n = int(round(fs * 1e-3)) * n_ms
    spms = int(round(fs * 1e-3))
    t = np.arange(n) / fs
    out = np.zeros(n, np.complex128)
    for sat in prns_dopplers_phases:
        prn, dopp, phase = sat[:3]
        nav = np.asarray(sat[3], np.int8) if len(sat) > 3 else None
        rolled = np.roll(np.tile(sampled_code(prn, fs, spms), n_ms),
                         phase)[:n]
        if nav is not None:
            ms_bit = (np.arange(n) // (20 * spms)) % len(nav)
            rolled = rolled * (1.0 - 2.0 * nav[ms_bit])
        out += amplitude * rolled * np.exp(2j * np.pi * dopp * t)
    if noise_std > 0.0:
        rng = rng or np.random.default_rng(0)
        out += noise_std * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
    return out.astype(np.complex64)


def _track_scan(iq_blocks: torch.Tensor, codes: torch.Tensor,
                init_code_phase: torch.Tensor, init_freq: torch.Tensor, *,
                fs: float, dll_gain: float = 0.05, pll_alpha: float = 0.6,
                pll_beta: float = 30.0):
    """Closed-loop C/A tracking of C channels over [n_ms, N] 1 ms blocks:
    one Python loop over the blocks, the channels a batch axis ([C, N]).

    Per block: early/prompt/late code correlators (±0.5 chip) after carrier
    wipe; a normalized early-late envelope DLL steers the code phase, a
    Costas atan PLL steers carrier phase/frequency. ``codes`` [C, 1023]
    (±1), ``init_code_phase`` and ``init_freq`` [C] float32. Everything
    stays on the blocks' device; nothing is read back inside the loop.

    Returns (prompt I+jQ [C, n_ms], code phases [C, n_ms], freqs [C, n_ms]).
    """
    dev = iq_blocks.device
    n = iq_blocks.shape[-1]
    c = codes.shape[0]
    t = torch.arange(n, dtype=torch.float32, device=dev) / fs
    base_idx = torch.arange(n, dtype=torch.float32, device=dev) \
        * (CHIP_RATE / fs)
    # early, prompt, late: the three replicas as one [C, 3, N] gather
    offsets = torch.tensor([-0.5, 0.0, 0.5], dtype=torch.float32, device=dev)
    table = codes.to(torch.float32)[:, None, :].expand(c, 3, codes.shape[-1])
    code_chips = (init_code_phase * (CHIP_RATE / fs)) % CODE_LEN
    phase = torch.zeros(c, dtype=torch.float32, device=dev)
    freq = init_freq.to(torch.float32)
    ones = torch.ones(c, n, dtype=torch.float32, device=dev)
    prompts, chips, freqs = [], [], []
    for x in iq_blocks:
        # exp(−j(2π·f·t + φ)): negating the constant and φ negates the
        # rounded sum exactly
        carrier = torch.polar(ones, (-2.0 * np.pi) * freq[:, None] * t
                              - phase[:, None])
        wiped = x * carrier
        idx = torch.floor(base_idx + (code_chips[:, None] + offsets)[..., None]) \
            % CODE_LEN
        replicas = torch.gather(table, 2, idx.to(torch.int64))
        epl = torch.sum(wiped[:, None, :] * replicas, dim=-1)   # [C, 3]
        p = epl[:, 1]
        # DLL: normalized early-late envelope
        ae, al = torch.abs(epl[:, ::2]).unbind(1)
        dll = (ae - al) / torch.clamp_min(ae + al, 1e-12)
        code_chips = (code_chips - dll_gain * dll) % CODE_LEN
        # Costas PLL (data-bit insensitive); phase advances with the
        # frequency that was actually applied during the block — advancing
        # with the freshly-updated one injects a bias proportional to the
        # error and the loop settles tens of Hz off
        # atan(Q/I), NOT atan2: the half-plane discriminator is what makes
        # Costas insensitive to the 180-degree data-bit flips
        re = p.real
        err = torch.atan(p.imag / torch.where(re.abs() < 1e-20, 1e-20, re))
        phase = (phase + 2.0 * np.pi * freq * n / fs
                 + pll_alpha * err) % (2.0 * np.pi)
        freq = freq + pll_beta * err
        prompts.append(p)
        chips.append(code_chips)
        freqs.append(freq)
    if not prompts:
        empty = torch.zeros(c, 0, device=dev)
        return empty.to(torch.complex64), empty, empty
    return (torch.stack(prompts, dim=1), torch.stack(chips, dim=1),
            torch.stack(freqs, dim=1))


def _blocks(iq, total: int, spms: int, dev: torch.device) -> torch.Tensor:
    return _iq_tensor(iq, dev)[:total * spms].reshape(total, spms)


def track(iq, prn: int, *, fs: float, code_phase: int,
          doppler: float, n_ms: int | None = None, device=None) -> dict:
    """Track one acquired satellite → prompt correlator series + nav bits.

    ``code_phase``/``doppler`` come from :func:`acquire`. Nav bits are the
    sign of the prompt I arm after settling, grouped at the 50 bps (20 ms)
    cadence with the bit boundary found from sign transitions. The loop runs
    on ``device``; the bit decisions on the host.
    """
    dev = _device(device)
    spms = int(round(fs * 1e-3))
    total = len(iq) // spms if n_ms is None else n_ms
    blocks = _blocks(iq, total, spms, dev)
    code = torch.from_numpy(ca_code(prn)).to(dev)[None]
    prompts, code_chips, freqs = _track_scan(
        blocks, code,
        torch.tensor([-code_phase], dtype=torch.float32, device=dev),
        torch.tensor([doppler], dtype=torch.float32, device=dev), fs=fs)
    return _finish_track(prompts[0].cpu().numpy(), code_chips[0].cpu().numpy(),
                         freqs[0].cpu().numpy(), total)


def track_channels(iq, acquisitions: list[dict], *, fs: float,
                   device=None) -> list[dict]:
    """Parallel tracking channels: one loop over the 1 ms blocks tracks every
    acquired satellite at once (a receiver's channel bank as a batch axis,
    not threads)."""
    if not acquisitions:
        return []
    dev = _device(device)
    spms = int(round(fs * 1e-3))
    total = len(iq) // spms
    blocks = _blocks(iq, total, spms, dev)
    codes = torch.from_numpy(np.stack([ca_code(a["prn"])
                                       for a in acquisitions])).to(dev)
    phases = torch.tensor([-a["code_phase"] for a in acquisitions],
                          dtype=torch.float32, device=dev)
    freqs = torch.tensor([a["doppler"] for a in acquisitions],
                         dtype=torch.float32, device=dev)
    prompts, chips, f = (a.cpu().numpy() for a in _track_scan(
        blocks, codes, phases, freqs, fs=fs))
    out = []
    for k, a in enumerate(acquisitions):
        r = _finish_track(prompts[k], chips[k], f[k], total)
        r["prn"] = a["prn"]
        out.append(r)
    return out


def _finish_track(prompts: np.ndarray, code_chips: np.ndarray,
                  freqs: np.ndarray, total: int) -> dict:
    settle = min(30, total // 4)
    sgn = np.sign(np.real(prompts))
    trans = np.nonzero(sgn[settle + 1:] != sgn[settle:-1])[0] + settle + 1
    boundary = int(np.argmax(np.bincount(trans % 20, minlength=20))) \
        if len(trans) else 0
    bits = []
    k = boundary if boundary > settle else boundary + 20 * (
        (settle - boundary + 19) // 20)
    while k + 20 <= total:
        bits.append(1 if np.sum(np.real(prompts[k:k + 20])) >= 0 else 0)
        k += 20
    return {"prompts": prompts, "doppler": freqs, "code_chips": code_chips,
            "bits": np.asarray(bits, np.uint8), "bit_boundary": boundary}


def acquire_all(iq, *, fs: float, prns=range(1, 33),
                doppler_max: float = 5000.0, doppler_step: float = 250.0,
                n_coherent: int = 2, threshold: float = 2.5,
                mesh=None, device=None) -> list[dict]:
    """Sky search: acquire every PRN in one batched program on ``device``.

    The PRN axis is a batch: the wiped spectra are computed once and the
    [P, D, K, N] correlations are one inverse FFT. Each PRN's peak, code
    phase and second peak are found on the device, so only [P] numbers come
    back. Under a ``mesh`` (``parallel.mesh.Mesh``; ``device`` must then be
    None) the PRN axis is split over the mesh's last axis: each device
    searches its slice of the constellation (no collective in the hot
    loop), and the peaks are joined on the host."""
    prns = list(prns)
    n = int(round(fs * 1e-3))
    dopplers = doppler_grid(doppler_max, doppler_step)
    spc = int(round(fs / CHIP_RATE))
    if mesh is None:
        parts = [(prns, _device(device))]
    else:
        from ..parallel.mesh import Mesh
        if not isinstance(mesh, Mesh) or device is not None:
            raise GrError("acquire_all: pass a mesh (parallel.mesh.Mesh) or "
                          "a device, not both")
        devs = mesh.axis_devices(mesh.axis_names[-1])
        parts = [([int(p) for p in c], d) for c, d in
                 zip(np.array_split(np.asarray(prns), len(devs)), devs)
                 if len(c)]
    found = []
    for part, dev in parts:
        codes = device_constant(_code_table(tuple(part), fs, n), dev)
        surfs = acquire_metric(_iq_tensor(iq, dev), codes,
                               device_constant(dopplers, dev), fs=fs,
                               n_coherent=n_coherent)             # [P, D, N]
        found.append(_peaks(surfs, spc))
    d_idx, c_idx, peak, second = (np.concatenate(a) for a in zip(*found))
    out = []
    for k, prn in enumerate(prns):
        metric = float(peak[k] / max(second[k], 1e-30))
        if metric >= threshold:
            out.append({"prn": prn, "doppler": float(dopplers[d_idx[k]]),
                        "code_phase": int(c_idx[k]), "metric": metric})
    return out


def _peaks(surfs: torch.Tensor, spc: int):
    """The peak search of every surface of [P, D, N], on its device: the
    first maximum's Doppler row and code phase, the peak, and the row's
    maximum outside ±``spc`` samples of it, circularly (the JAX package
    zeroes that span on the host). Host arrays of [P]."""
    p, _, n = surfs.shape
    flat = torch.argmax(surfs.reshape(p, -1), dim=1)
    d_idx, c_idx = flat // n, flat % n
    rows = surfs[torch.arange(p, device=surfs.device), d_idx]       # [P, N]
    peak = rows.gather(1, c_idx[:, None])[:, 0]
    dist = (torch.arange(n, device=surfs.device)[None] - c_idx[:, None]) % n
    near = (dist <= spc) | (dist >= n - spc)
    second = torch.where(near, 0.0, rows).amax(dim=1)
    d_idx, c_idx, peak, second = torch.stack(
        [d_idx.to(torch.float64), c_idx.to(torch.float64),
         peak.to(torch.float64), second.to(torch.float64)]).cpu().numpy()
    return (d_idx.astype(np.int64), c_idx.astype(np.int64),
            peak.astype(np.float32), second.astype(np.float32))
