"""fm_allband: every station of the FM band from one wideband capture, GNU
Radio's ``pfb_channelizer_ccf`` at ``oversample_rate`` 2 feeding ``wfm_rcv``
on each of its 100 channels, on a 20 MS/s complex capture of 88–108 MHz.

ReplaySource → PFBChannelizer(100 channels, O 2, 10 taps a phase, fm's
963-tap channel filter as prototype) → {BandSink "channels";
 QuadratureDemod(400 kS/s / (2π·75 kHz)) → FirFilter(wfm_rcv's audio
 low-pass, ÷8) → FmDeemphasis(75 µs) → BandSink "audio" (the station rows)},
all float32 on [100, T] streams, through the port's blocks. The sizes and
settings are ``fm_allband.json``; the plain reference is
``reference/fm_allband.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import dsp, yardstick
from portbench.blocks import KeepSink, ReplaySource

CHUNK = 1 << 20


def hop(cfg: dict) -> int:
    """The bank's hop D = M/O in input samples."""
    c = cfg["channelizer"]
    return c["n_channels"] // c["oversample_rate"]


def rates(cfg: dict) -> tuple[float, float]:
    """(quad_rate, audio_rate) in Hz: a channel's rate and its audio's."""
    quad = cfg["sample_rate"] / hop(cfg)
    return quad, quad / cfg["wfm_rcv"]["audio_decimation"]


def station_rows(cfg: dict) -> list[int]:
    """The bank's channels that carry a station: raster channel c lies at
    ``first_offset + c·raster`` = (c − M/2)·fs/M, bank channel (c − M/2) mod M."""
    bd = cfg["band"]
    m = cfg["channelizer"]["n_channels"]
    chans = range(bd["first_station"], bd["channels"], bd["station_step"])
    return sorted((c - m // 2) % m for c in chans)


def constants(cfg: dict) -> dict:
    """What the benchmark hands to both the program and the reference: the
    prototype and the audio FIR, designed as GNU Radio's ``firdes.low_pass``
    designs them (float32), the discriminator's gain and the station rows.

    The prototype is zero-padded to M·P and handed over with each block of
    M taps reversed. The port's bank gives branch p the samples x[nM + p]
    and the taps h[jM + p]; GNU Radio's commutator runs the other way round.
    In this order each channel is the prototype's own convolution, so its
    response is the firdes design's (−0.37 dB at ±75 kHz, −28 dB at
    ±125 kHz). In GNU Radio's order each block would act mirrored in time
    (−11 dB at ±75 kHz, −1.3 dB at ±125 kHz)."""
    c, w = cfg["channelizer"], cfg["wfm_rcv"]
    quad, audio = rates(cfg)
    tw = audio / 32.0
    proto = dsp.firdes_lowpass(1.0, cfg["sample_rate"], c["cutoff_hz"],
                               c["transition_hz"], c["window"])
    m, p = c["n_channels"], c["taps_per_phase"]
    proto = np.pad(proto, (0, m * p - len(proto)))
    return {"prototype": np.ascontiguousarray(proto.reshape(p, m)[:, ::-1].reshape(-1)),
            "audio": dsp.firdes_lowpass(1.0, quad, audio / 2.0 - tw, tw,
                                        w["window"]),
            "gain": quad / (2.0 * math.pi * w["max_dev_hz"]),
            "rows": station_rows(cfg)}


class BandSink(KeepSink):
    """A ``KeepSink`` whose kept steps come out as real tensors (a complex
    stream as its real and imaginary parts, ``[..., 2]``), of the ``rows``
    of the channel axis only where given. The selection is made when the
    comparison reads them, not in the window."""

    def __init__(self, sampler, rows=None, name: str | None = None):
        super().__init__(sampler, name=name)
        self.rows = rows

    def outputs(self) -> dict[int, torch.Tensor]:
        out = {}
        for step, t in super().outputs().items():
            if self.rows is not None:
                t = t[torch.as_tensor(self.rows, device=t.device)]
            out[step] = torch.view_as_real(t) if t.is_complex() else t
        return out


def build(cfg: dict, replay: torch.Tensor, sampler, precision: str | None = None):
    """The graph over ``replay``. Returns (graph, sinks by name, every
    block by name). Every block runs in float32: ``precision`` must be
    None."""
    from gnuradio4_tpu_torch import Graph
    from gnuradio4_tpu_torch.blocks.channelizer import PFBChannelizer
    from gnuradio4_tpu_torch.blocks.filter import FirFilter
    from gnuradio4_tpu_torch.blocks.sdr import FmDeemphasis, QuadratureDemod

    if precision is not None:
        raise ValueError("fm_allband runs in float32 only")
    t = constants(cfg)
    c, w = cfg["channelizer"], cfg["wfm_rcv"]
    _quad, audio = rates(cfg)
    blocks = {
        "replay": ReplaySource(replay, name="replay"),
        "pfb": PFBChannelizer(name="pfb", n_channels=c["n_channels"],
                              taps_per_phase=c["taps_per_phase"],
                              oversample_rate=c["oversample_rate"],
                              taps=tuple(float(v) for v in t["prototype"])),
        "demod": QuadratureDemod(name="demod", gain=t["gain"]),
        "audio_fir": FirFilter(name="audio_fir", taps=t["audio"],
                               decim=w["audio_decimation"]),
        "deemph": FmDeemphasis(name="deemph", tau=w["deemph_tau_s"],
                               sample_rate_in=audio),
        "channels": BandSink(sampler, name="channels"),
        "audio": BandSink(sampler, rows=t["rows"], name="audio"),
    }
    b = blocks
    g = Graph()
    g.connect_chain(b["replay"], b["pfb"], b["channels"])
    g.connect_chain(b["pfb"], b["demod"], b["audio_fir"], b["deemph"],
                    b["audio"])
    return g, {"channels": b["channels"], "audio": b["audio"]}, blocks


def _stations(cfg: dict, g: torch.Generator, device):
    """The band's stations from the seed: (offset Hz [S], amplitude [S],
    tone frequency Hz [S, tones], phase deviation rad [S, tones], tone phase
    [S, tones])."""
    bd = cfg["band"]
    chans = torch.arange(bd["first_station"], bd["channels"], bd["station_step"],
                         dtype=torch.float64, device=device)
    s, n_t = chans.shape[0], bd["tones"]
    offset = bd["first_offset_hz"] + bd["raster_hz"] * chans
    u = torch.rand(4, s, n_t, generator=g, dtype=torch.float64, device=device)
    amp = bd["amp_lo"] + u[3, :, 0] * (bd["amp_hi"] - bd["amp_lo"])
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


def bank_least_work(cfg: dict, block_len: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the oversampled bank in one step of ``block_len``
    input samples: P multiply-adds of a real tap on complex data (4 FLOPs)
    for each of a frame's M branches and the M-point FFT (5·M·log2 M) a
    frame; the input read once (8 B a sample) and the channels written once
    (M/D complex64 a sample: 16 B at O 2). The per-frame shift is not
    counted."""
    c = cfg["channelizer"]
    m, p = c["n_channels"], c["taps_per_phase"]
    frames = block_len // hop(cfg)
    flops = frames * (4.0 * m * p + 5.0 * m * math.log2(m))
    return flops, 8.0 * block_len + 8.0 * m * frames


def least_work(cfg: dict, block_len: int) -> tuple[float, float]:
    """(FLOPs, bytes) that one step needs at the least arithmetic of each
    block: the bank (:func:`bank_least_work`); on each of the M channels
    QuadratureDemod's conjugate product and gain (7 an output, atan2 not
    counted), FirFilter's 2 FLOPs a tap an output and FmDeemphasis's 5 an
    output. Bytes: the graph's input read once and its outputs written
    once: the channels, and the audio of every channel."""
    m = cfg["channelizer"]["n_channels"]
    q = block_len // hop(cfg)
    d2 = cfg["wfm_rcv"]["audio_decimation"]
    k2 = len(constants(cfg)["audio"])
    flops, nbytes = bank_least_work(cfg, block_len)
    flops += (7.0 * m * q + yardstick.fir_work((m, q), False, False, k2, d2)[0]
              + 5.0 * m * (q // d2))
    return flops, nbytes + 4.0 * m * (q // d2)
