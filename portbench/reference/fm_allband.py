"""Plain reference of fm_allband, in float64 PyTorch (bfloat16 operands for
the control). It imports nothing of the program: it works the bank and the
receivers out again from the input samples and the taps the benchmark
designed.

The bank is computed straight from its definition, with no polyphase form
and no FFT. For hop D = M/O, channel m, absolute input index i and absolute
frame n, with i = (n+1)·D − M − jM + p:

    y[n, m] = Σ_{j<P, p<M} h[jM + p] · x[i] · e^{−j2π·m·i/M}

Frame n reads the P·M input samples ending at (n+1)·D − 1. Each frame is
unfolded (its samples oldest first, q = (P−1−j)·M + p), multiplied by the
[P·M, M] matrix ``h[jM + p]·e^{−j2π·m·p/M}``, and by the frame's phase
``e^{−j2π·m·(n+1)·D/M}``, which is the mix by absolute index (i ≡ (n+1)·D + p
mod M). A step's frame count is a whole number of the phase's period, so a
step's first frame has the phase of absolute frame 0.

Then, on the station rows, by the definitions of the blocks:

- the discriminator: ``d[q] = gain·arg(y[q]·conj(y[q−1]))``;
- the audio FIR: ``a[j] = Σ_k g[k]·d[D2·j − k]``, D2 the audio decimation;
- the de-emphasis: ``e[j] = b0·(a[j] + a[j−1]) + p1·e[j−1]``, GNU Radio's
  ``fm_deemph``, started ``DEEMPH_SETTLE`` audio samples before the step
  from rest: p1^DEEMPH_SETTLE is far below float64's resolution.

The FIR sums run tap by tap over shifted slices; the one-pole recurrence
runs as a scan by doubling.
"""

from __future__ import annotations

import math

import torch

DEEMPH_SETTLE = 128
FRAMES = 1 << 16           # frames a block of the dense product


def _sizes(cfg: dict) -> tuple[int, int, int, int, int]:
    """(M, P, D, D2, K2): channels, taps a phase, hop, audio decimation,
    audio taps."""
    c = cfg["channelizer"]
    m, p = c["n_channels"], c["taps_per_phase"]
    d = m // c["oversample_rate"]
    d2 = cfg["wfm_rcv"]["audio_decimation"]
    quad = cfg["sample_rate"] / d
    n = int(53.0 * quad / (22.0 * (quad / d2 / 32.0)))
    return m, p, d, d2, (n if n & 1 else n + 1)


def _period(m: int, d: int) -> int:
    return m // math.gcd(m, d)


def _chain_frames(cfg: dict) -> int:
    """Channel samples before the step that the step's audio depends on
    (the de-emphasis's to float64 resolution)."""
    _m, _p, _d, d2, k2 = _sizes(cfg)
    return d2 * DEEMPH_SETTLE + (k2 - 1) + 1


def history(cfg: dict) -> int:
    """Input samples before the step that the step's outputs depend on."""
    m, p, d, _d2, _k2 = _sizes(cfg)
    return d * _chain_frames(cfg) + p * m - d


def _fir(x: torch.Tensor, h: torch.Tensor, n_out: int, decim: int = 1
         ) -> torch.Tensor:
    """``y[..., j] = Σ_k h[k]·x[..., (K−1) + decim·j − k]`` for j < n_out:
    ``x`` carries K−1 samples of history before the first output's own
    sample."""
    k = h.shape[0]
    span = decim * (n_out - 1) + 1
    acc = None
    for i in range(k):
        seg = x[..., k - 1 - i: k - 1 - i + span: decim] * h[i]
        acc = seg if acc is None else acc + seg
    return acc


def _one_pole(u: torch.Tensor, p: float) -> torch.Tensor:
    """``e[j] = u[j] + p·e[j−1]`` along the last axis from ``e[−1] = 0``,
    by doubling: after the pass of span s, ``acc[j]`` holds the sum over the
    last 2s terms."""
    acc = u.clone()
    s = 1
    while s < acc.shape[-1]:
        nxt = acc.clone()
        nxt[..., s:] += (p ** s) * acc[..., :-s]
        acc = nxt
        s *= 2
    return acc


def _deemph(a: torch.Tensor, audio_rate: float, tau: float) -> torch.Tensor:
    w_ca = 2.0 * audio_rate * math.tan(1.0 / tau / (2.0 * audio_rate))
    k = -w_ca / (2.0 * audio_rate)
    p1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    u = b0 * (a[..., 1:] + a[..., :-1])
    return _one_pole(u, p1)


def _bank(x: torch.Tensor, h: torch.Tensor, m: int, p: int, d: int,
          first: int, cdt: torch.dtype) -> torch.Tensor:
    """The channels ``[frames, M]`` of every frame of ``x`` (frame r reads
    ``x[r·D : r·D + P·M]``), the first of absolute index ``first`` (its
    phase's, modulo the period)."""
    dev = x.device
    rdt = torch.float32 if cdt == torch.complex64 else torch.float64
    q = torch.arange(p * m, device=dev)
    jj, pp = p - 1 - q // m, q % m
    ch = torch.arange(m, device=dev)
    ang = (-2.0 * math.pi / m) * ((pp[:, None] * ch[None, :]) % m).to(torch.float64)
    w = (h[jj * m + pp].to(torch.float64)[:, None]
         * torch.polar(torch.ones_like(ang), ang)).to(cdt)      # [P·M, M]
    n_frames = (x.shape[0] - p * m) // d + 1
    out = torch.empty(n_frames, m, dtype=cdt, device=dev)
    period = _period(m, d)
    for r0 in range(0, n_frames, FRAMES):
        r1 = min(n_frames, r0 + FRAMES)
        u = x.as_strided((r1 - r0, p * m), (d, 1),
                         x.storage_offset() + r0 * d).contiguous()
        s = (torch.arange(r0, r1, device=dev) + first + 1) % period
        ph_ang = (-2.0 * math.pi / m) * ((s[:, None] * d * ch[None, :]) % m
                                         ).to(torch.float64)
        ph = torch.polar(torch.ones_like(ph_ang), ph_ang).to(cdt)
        out[r0:r1] = (u @ w) * ph
        del u
    return out.to(torch.complex128 if rdt == torch.float64 else cdt)


def outputs(x_ext: torch.Tensor, cfg: dict, block_len: int, consts: dict,
            dtype: torch.dtype = torch.float64) -> dict[str, torch.Tensor]:
    """The sinks' inputs for one step: ``{"channels": [M, T/D, 2]`` (real
    and imaginary parts), ``"audio": [S, T/(D·D2)]}`` (the station rows),
    float64. With ``dtype`` bfloat16 (the control) the input and the taps
    are rounded to bfloat16 and the arithmetic runs in float32: one bfloat16
    pass into float32 sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    low = dtype != torch.float64
    rdt = torch.float32 if low else torch.float64
    cdt = torch.complex64 if low else torch.complex128
    m, p, d, d2, _k2 = _sizes(cfg)
    t = block_len
    if t % (d * _period(m, d)):
        raise ValueError(f"block_len {t} is not a whole number of the bank's "
                         f"phase period ({d * _period(m, d)} samples)")
    dev = x_ext.device

    def rnd(v: torch.Tensor) -> torch.Tensor:
        """Complex or real values rounded to ``dtype``, held in rdt/cdt."""
        if v.is_complex():
            r = torch.view_as_real(v.to(torch.complex128))
            return torch.view_as_complex(r.to(dtype).to(rdt).contiguous())
        return v.to(dtype).to(rdt)

    x = rnd(x_ext)
    h = rnd(torch.as_tensor(consts["prototype"], dtype=torch.float64, device=dev))
    g = rnd(torch.as_tensor(consts["audio"], dtype=torch.float64, device=dev))
    hc = _chain_frames(cfg)
    y = _bank(x, h, m, p, d, -hc, cdt)                     # [Hc + F, M]
    del x
    f = t // d
    channels = torch.view_as_real(y[hc:].t().contiguous().to(torch.complex128))
    # the receivers of the station rows, over the channel samples the
    # discriminator, the audio FIR and the de-emphasis need before the step
    z = y[:, torch.as_tensor(consts["rows"], device=dev)].t()   # [S, Hc + F]
    del y
    prod = z[:, 1:] * z[:, :-1].conj()
    dq = torch.atan2(prod.imag, prod.real) * consts["gain"]    # [S, Hc − 1 + F]
    k2 = g.shape[0]
    hd = hc - 1                          # discriminator outputs before the step
    lead = hd - (k2 - 1) - d2 * DEEMPH_SETTLE
    n_audio = DEEMPH_SETTLE + f // d2
    a = _fir(dq[:, lead:], g, n_audio, d2)
    audio_rate = cfg["sample_rate"] / d / d2
    e = _deemph(a, audio_rate, cfg["wfm_rcv"]["deemph_tau_s"])
    return {"channels": channels.to(torch.float64).contiguous(),
            "audio": e[:, -(f // d2):].to(torch.float64).contiguous()}
