"""fm_monitor: a monitor of the whole FM band and a broadcast receiver on
one station, GNU Radio's ``wfm_rcv`` behind a frequency-translating FIR, on
a 20 MS/s complex capture of 88–108 MHz.

ReplaySource → {FFT(1024, Blackman-harris, magnitude) → KeepSink "spectrum";
 FreqXlatingFir(firdes low-pass 100/50 kHz, +3.1 MHz, ÷40) →
 QuadratureDemod(500 kS/s / (2π·75 kHz)) → FirFilter(wfm_rcv's audio
 low-pass, ÷10) → FmDeemphasis(75 µs) → KeepSink "audio"}, all float32,
through the port's blocks. The sizes and settings are ``fm_monitor.json``;
the plain reference is ``reference/fm_monitor.py``.
"""

from __future__ import annotations

import math

import torch

from portbench import dsp, yardstick
from portbench.blocks import KeepSink, ReplaySource

CHUNK = 1 << 20


def rates(cfg: dict) -> tuple[float, float]:
    """(quad_rate, audio_rate) in Hz."""
    quad = cfg["sample_rate"] / cfg["xlating_fir"]["decim"]
    return quad, quad / cfg["wfm_rcv"]["audio_decimation"]


def constants(cfg: dict) -> dict:
    """What the benchmark hands to both the program and the reference: the
    two FIRs' taps, designed as GNU Radio's ``firdes.low_pass`` designs them
    (float32), and the discriminator's gain."""
    fs = cfg["sample_rate"]
    x, w = cfg["xlating_fir"], cfg["wfm_rcv"]
    quad, audio = rates(cfg)
    tw = audio / 32.0
    return {"xlating": dsp.firdes_lowpass(1.0, fs, x["cutoff_hz"],
                                          x["transition_hz"], x["window"]),
            "audio": dsp.firdes_lowpass(1.0, quad, audio / 2.0 - tw, tw,
                                        w["window"]),
            "gain": quad / (2.0 * math.pi * w["max_dev_hz"])}


def build(cfg: dict, replay: torch.Tensor, sampler, precision: str | None = None):
    """The graph over ``replay``. Returns (graph, sinks by name, every
    block by name). The configuration runs every FIR in full float32 (the
    port's own lower rungs take at most 512 taps): ``precision`` must be
    None."""
    from gnuradio4_tpu_torch import Graph
    from gnuradio4_tpu_torch.blocks.filter import FirFilter, FreqXlatingFir
    from gnuradio4_tpu_torch.blocks.fourier import FFT
    from gnuradio4_tpu_torch.blocks.sdr import FmDeemphasis, QuadratureDemod

    if precision is not None:
        raise ValueError("fm_monitor runs its FIRs in float32 only")
    t = constants(cfg)
    x, f, w = cfg["xlating_fir"], cfg["fft"], cfg["wfm_rcv"]
    _quad, audio = rates(cfg)
    blocks = {
        "replay": ReplaySource(replay, name="replay"),
        "fft": FFT(name="fft", fft_size=f["size"], window=f["window"],
                   output=f["output"], calibrate=f["calibrate"]),
        "xlating_fir": FreqXlatingFir(
            name="xlating_fir", taps=t["xlating"], center_freq=x["center_hz"],
            sample_rate_in=cfg["sample_rate"], decim=x["decim"]),
        "demod": QuadratureDemod(name="demod", gain=t["gain"]),
        "audio_fir": FirFilter(name="audio_fir", taps=t["audio"],
                               decim=w["audio_decimation"]),
        "deemph": FmDeemphasis(name="deemph", tau=w["deemph_tau_s"],
                               sample_rate_in=audio),
        "spectrum": KeepSink(sampler, name="spectrum"),
        "audio": KeepSink(sampler, name="audio"),
    }
    b = blocks
    g = Graph()
    g.connect(b["replay"], b["fft"])
    g.connect(b["fft"], b["spectrum"])
    g.connect(b["replay"], b["xlating_fir"])
    g.connect_chain(b["xlating_fir"], b["demod"], b["audio_fir"], b["deemph"],
                    b["audio"])
    return g, {"spectrum": b["spectrum"], "audio": b["audio"]}, blocks


def _stations(cfg: dict, g: torch.Generator, device):
    """The band's stations from the seed: (offset Hz [S], amplitude [S],
    tone frequency Hz [S, tones], phase deviation rad [S, tones], tone phase
    [S, tones]). The tuned station is first."""
    bd = cfg["band"]
    s, n_t, tuned = bd["stations"], bd["tones"], bd["tuned_channel"]
    allowed = [c for c in range(1, bd["channels"] - 1) if abs(c - tuned) > 1]
    pick = torch.randperm(len(allowed), generator=g, device=device)[: s - 1]
    chans = torch.tensor([tuned] + [allowed[i] for i in pick.tolist()],
                         dtype=torch.float64, device=device)
    offset = bd["first_offset_hz"] + bd["raster_hz"] * chans
    u = torch.rand(4, s, n_t, generator=g, dtype=torch.float64, device=device)
    amp = bd["amp_lo"] + u[3, :, 0] * (bd["amp_hi"] - bd["amp_lo"])
    amp[0] = 1.0
    f_tone = bd["tone_lo_hz"] + u[0] * (bd["tone_hi_hz"] - bd["tone_lo_hz"])
    share = u[1] / u[1].sum(dim=1, keepdim=True)
    beta = bd["deviation_hz"] * share / f_tone
    return offset, amp, f_tone, beta, 2.0 * math.pi * u[2]


def make_input(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` complex64 samples on ``device`` from ``seed``: every station
    a carrier at its offset whose phase is the integral of its message, so
    its instantaneous frequency swings by up to the deviation, plus white
    complex Gaussian noise. Phases in float64, all stations of a chunk in
    one call each."""
    bd = cfg["band"]
    fs = cfg["sample_rate"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    offset, amp, f_tone, beta, theta = _stations(cfg, g, device)
    w_st = (2.0 * math.pi * offset / fs)[:, None]             # [S, 1]
    w_tone = (2.0 * math.pi * f_tone / fs)[:, :, None]        # [S, tones, 1]
    out = torch.empty(n, dtype=torch.complex64, device=device)
    for c0 in range(0, n, CHUNK):
        m = torch.arange(c0, min(n, c0 + CHUNK), dtype=torch.float64,
                         device=device)
        phi = torch.remainder(w_st * m, 2.0 * math.pi)        # [S, L]
        phi += (beta[:, :, None] * torch.sin(w_tone * m + theta[:, :, None])).sum(1)
        sig = (amp[:, None] * torch.polar(torch.ones_like(phi), phi)).sum(0)
        noise = torch.randn(m.shape[0], 2, generator=g, dtype=torch.float32,
                            device=device) * (bd["noise_rms"] / math.sqrt(2.0))
        out[c0:c0 + m.shape[0]] = sig.to(torch.complex64) + torch.view_as_complex(noise)
    return out


def least_work(cfg: dict, block_len: int) -> tuple[float, float]:
    """(FLOPs, bytes) that one step of ``block_len`` input samples needs at
    the least arithmetic of each block. FFT: the real window (2 a sample),
    5·n·log2 n a frame, the magnitude (3 a bin, the square root not
    counted); FreqXlatingFir: 4 FLOPs a real tap on complex data an output
    and the 6-FLOP mix an output (the mix moved behind the decimation);
    QuadratureDemod: the conjugate product (6) and the gain (1), atan2 not
    counted; FirFilter: 2 FLOPs a tap an output; FmDeemphasis: 5 an output.
    Bytes: the graph's input read once and its outputs written once."""
    t = block_len
    k1 = len(dsp.firdes_lowpass(1.0, cfg["sample_rate"],
                                cfg["xlating_fir"]["cutoff_hz"],
                                cfg["xlating_fir"]["transition_hz"]))
    d1 = cfg["xlating_fir"]["decim"]
    d2 = cfg["wfm_rcv"]["audio_decimation"]
    k2 = len(constants(cfg)["audio"])
    n = cfg["fft"]["size"]
    q = t // d1
    flops = (t * (2.0 + 5.0 * math.log2(n) + 3.0)
             + yardstick.fir_work((t,), True, False, k1, d1)[0] + 6.0 * q
             + 7.0 * q
             + yardstick.fir_work((q,), False, False, k2, d2)[0]
             + 5.0 * (q // d2))
    nbytes = 8.0 * t + 4.0 * t + 4.0 * (q // d2)
    return flops, nbytes
