"""Plain reference of fm_monitor, in float64 PyTorch (bfloat16 operands for
the control). It imports nothing of the program: it works the chain out
again from the input samples and the taps the benchmark designed.

For one step of ``T`` input samples it takes ``x_ext``, the step's input
preceded by ``history(cfg)`` earlier samples of the stream, and computes,
by the definitions of the blocks (D1, D2 the two decimations):

- the spectrum: ``|FFT(w·x)|`` over consecutive frames of ``n`` input
  samples, w the symmetric Blackman-harris window, no scaling;
- the frequency-translating FIR: ``y[q] = Σ_k h[k]·x[D1·q−k]·e^{−jω(D1·q−k)}``,
  ω = 2π·center/fs (the mix's phase at the step's first sample is taken as
  0: the discriminator does not see a phase constant over a step);
- the discriminator: ``d[q] = gain·arg(y[q]·conj(y[q−1]))``;
- the audio FIR: ``a[j] = Σ_k g[k]·d[D2·j − k]``;
- the de-emphasis: ``e[j] = b0·(a[j] + a[j−1]) + p1·e[j−1]``, GNU Radio's
  ``fm_deemph`` (the bilinear transform of a one-pole low-pass with the
  corner pre-warped), started ``DEEMPH_SETTLE`` audio samples before the
  step from rest: p1^DEEMPH_SETTLE is far below float64's resolution.

The FIR sums run tap by tap over shifted slices; the one-pole recurrence
runs as a scan by doubling.
"""

from __future__ import annotations

import math

import torch

DEEMPH_SETTLE = 128
FRAMES = 1 << 14          # FFT frames a block of the spectrum


def _rates(cfg: dict) -> tuple[int, int, float]:
    d1 = cfg["xlating_fir"]["decim"]
    d2 = cfg["wfm_rcv"]["audio_decimation"]
    return d1, d2, cfg["sample_rate"] / d1 / d2


def history(cfg: dict) -> int:
    """Input samples before the step that the step's outputs depend on
    (the de-emphasis's to float64 resolution)."""
    d1, d2, _ = _rates(cfg)
    k1 = _ntaps(cfg)
    k2 = _audio_ntaps(cfg)
    return d1 * (d2 * DEEMPH_SETTLE + (k2 - 1) + 1) + (k1 - 1)


def _ntaps(cfg: dict) -> int:
    x = cfg["xlating_fir"]
    n = int(53.0 * cfg["sample_rate"] / (22.0 * x["transition_hz"]))
    return n if n & 1 else n + 1


def _audio_ntaps(cfg: dict) -> int:
    d1, d2, audio = _rates(cfg)
    quad = cfg["sample_rate"] / d1
    n = int(53.0 * quad / (22.0 * (audio / 32.0)))
    return n if n & 1 else n + 1


def _fir(x: torch.Tensor, h: torch.Tensor, n_out: int, decim: int = 1
         ) -> torch.Tensor:
    """``y[j] = Σ_k h[k]·x[(K−1) + decim·j − k]`` for j < n_out: ``x`` carries
    K−1 samples of history before the first output's own sample."""
    k = h.shape[0]
    span = decim * (n_out - 1) + 1
    acc = None
    for i in range(k):
        seg = x[k - 1 - i: k - 1 - i + span: decim] * h[i]
        acc = seg if acc is None else acc + seg
    return acc


def _one_pole(u: torch.Tensor, p: float) -> torch.Tensor:
    """``e[j] = u[j] + p·e[j−1]`` from ``e[−1] = 0``, by doubling: after
    the pass of span s, ``acc[j]`` holds the sum over the last 2s terms."""
    acc = u.clone()
    s = 1
    while s < acc.shape[0]:
        nxt = acc.clone()
        nxt[s:] += (p ** s) * acc[:-s]
        acc = nxt
        s *= 2
    return acc


def _deemph(a: torch.Tensor, audio_rate: float, tau: float) -> torch.Tensor:
    w_ca = 2.0 * audio_rate * math.tan(1.0 / tau / (2.0 * audio_rate))
    k = -w_ca / (2.0 * audio_rate)
    p1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    u = b0 * (a[1:] + a[:-1])
    return _one_pole(u, p1)


def _window(n: int, dtype, device) -> torch.Tensor:
    """The symmetric Blackman-harris window (GNU Radio's 92 dB form)."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    x = 2.0 * math.pi * k / (n - 1)
    w = (0.35875 - 0.48829 * torch.cos(x) + 0.14128 * torch.cos(2.0 * x)
         - 0.01168 * torch.cos(3.0 * x))
    return w.to(dtype)


def outputs(x_ext: torch.Tensor, cfg: dict, block_len: int, consts: dict,
            dtype: torch.dtype = torch.float64) -> dict[str, torch.Tensor]:
    """The sinks' inputs for one step: ``{"spectrum": [T], "audio":
    [T/(D1·D2)]}`` (float64). With ``dtype`` bfloat16 (the control) the
    input, the window and the taps are rounded to bfloat16 and the
    arithmetic runs in float32: one bfloat16 pass into float32 sums."""
    low = dtype != torch.float64
    rdt = torch.float32 if low else torch.float64
    cdt = torch.complex64 if low else torch.complex128
    t = block_len
    dev = x_ext.device
    d1, d2, audio_rate = _rates(cfg)
    hist = history(cfg)

    def rnd(v: torch.Tensor) -> torch.Tensor:
        """Complex or real values rounded to ``dtype``, held in rdt/cdt."""
        if v.is_complex():
            r = torch.view_as_real(v.to(torch.complex128))
            return torch.view_as_complex(r.to(dtype).to(rdt).contiguous())
        return v.to(dtype).to(rdt)

    x = rnd(x_ext)
    # the spectrum of the step's own samples, a block of frames at a time
    n_fft = cfg["fft"]["size"]
    win = rnd(_window(n_fft, torch.float64, dev))
    frames = x[hist:].reshape(-1, n_fft)
    spectrum = torch.empty(frames.shape[0], n_fft, dtype=torch.float64, device=dev)
    for f0 in range(0, frames.shape[0], FRAMES):
        fr = frames[f0:f0 + FRAMES] * win
        spectrum[f0:f0 + FRAMES] = torch.fft.fft(fr, dim=-1).abs()
    # the channel: mixed, filtered, decimated, over the quad samples the
    # discriminator, the audio FIR and the de-emphasis need before the step
    h = rnd(torch.as_tensor(consts["xlating"], dtype=torch.float64, device=dev))
    g = rnd(torch.as_tensor(consts["audio"], dtype=torch.float64, device=dev))
    k1, k2 = h.shape[0], g.shape[0]
    w = 2.0 * math.pi * cfg["xlating_fir"]["center_hz"] / cfg["sample_rate"]
    m = torch.arange(-hist, t, dtype=torch.float64, device=dev)
    mix = torch.polar(torch.ones_like(m), torch.remainder(-w * m, 2.0 * math.pi))
    xm = x * mix.to(cdt)
    del mix, m
    n_quad = (hist - (k1 - 1)) // d1 + t // d1
    y = _fir(xm, h.to(cdt), n_quad, d1)
    del xm
    prod = y[1:] * y[:-1].conj()
    d = torch.atan2(prod.imag, prod.real) * consts["gain"]
    n_audio = (d.shape[0] - (k2 - 1) - 1) // d2 + 1
    a = _fir(d, g, n_audio, d2)
    e = _deemph(a, audio_rate, cfg["wfm_rcv"]["deemph_tau_s"])
    audio = e[-(t // (d1 * d2)):]
    return {"spectrum": spectrum.reshape(-1),
            "audio": audio.to(torch.float64)}
