"""pfb_channelizer: CHIME's F-engine bank, a critically sampled polyphase
analysis bank of 2048 points and 4 taps a phase over 800 MS/s of real
digitiser samples.

ReplaySource → PFBChannelizer(2048 channels, 4 taps a phase, the 8192-tap
prototype designed by the benchmark) → Abs → KeepSink "channels", through
the port's blocks. The sizes and settings are ``pfb_channelizer.json``; the
plain reference is ``reference/pfb_channelizer.py``.
"""

from __future__ import annotations

import math

import torch

from portbench import dsp
from portbench.blocks import KeepSink, ReplaySource

BLOCK = 1 << 13            # samples per row of the tone synthesis
ROWS = 1024                # rows per chunk


def constants(cfg: dict) -> dict:
    """What the benchmark hands to both the program and the reference: the
    M·P-tap prototype low-pass (float32), cut off at half the channel
    spacing."""
    m, p = cfg["n_channels"], cfg["taps_per_phase"]
    pr = cfg["prototype"]
    return {"prototype": dsp.lowpass(m * p, 0.5 * cfg["sample_rate"] / m,
                                     cfg["sample_rate"], pr["window"])}


def build(cfg: dict, replay: torch.Tensor, sampler, precision: str | None = None):
    """The graph over ``replay``: (graph, sinks by name, blocks by name).
    The channelizer has no precision setting: ``precision`` must be None."""
    from gnuradio4_tpu_torch import Graph
    from gnuradio4_tpu_torch.blocks.channelizer import PFBChannelizer
    from gnuradio4_tpu_torch.blocks.math import Abs

    if precision is not None:
        raise ValueError("pfb_channelizer has no precision setting")
    blocks = {
        "replay": ReplaySource(replay, name="replay"),
        "pfb": PFBChannelizer(name="pfb", n_channels=cfg["n_channels"],
                              taps_per_phase=cfg["taps_per_phase"],
                              taps=tuple(float(v) for v in constants(cfg)["prototype"])),
        "abs": Abs(name="abs"),
        "channels": KeepSink(sampler, name="channels"),
    }
    g = Graph()
    g.connect_chain(blocks["replay"], blocks["pfb"], blocks["abs"],
                    blocks["channels"])
    return g, {"channels": blocks["channels"]}, blocks


def make_input(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` real digitiser samples from ``seed``, as complex64 with a zero
    imaginary part, on ``device``: a tone for each of the M/2 channels below
    fs/2, tone k at ``(k + δ_k)/M`` cycles a sample (δ_k within ±offset),
    amplitude and phase drawn from the seed, plus white Gaussian noise. The
    tones are summed as the real part of a product of per-row phasors
    [rows, M/2] with one row of per-sample phasors [M/2, BLOCK], in
    complex128."""
    m_ch = cfg["n_channels"]
    m = m_ch // 2
    tn = cfg["tones"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    u = torch.rand(3, m, generator=g, dtype=torch.float64, device=device)
    freq = (torch.arange(m, dtype=torch.float64, device=device)
            + tn["offset"] * (2.0 * u[0] - 1.0)) / m_ch
    amp = tn["amp_lo"] + u[1] * (tn["amp_hi"] - tn["amp_lo"])
    theta = 2.0 * math.pi * u[2]
    k = torch.arange(BLOCK, dtype=torch.float64, device=device)
    base = torch.polar(torch.ones(m, BLOCK, dtype=torch.float64, device=device),
                       2.0 * math.pi * torch.frac(freq[:, None] * k[None, :]))
    out = torch.empty(n, dtype=torch.complex64, device=device)
    n_rows = -(-n // BLOCK)
    for r0 in range(0, n_rows, ROWS):
        r = torch.arange(r0, min(n_rows, r0 + ROWS), dtype=torch.float64,
                         device=device)
        ph = theta[None, :] + 2.0 * math.pi * torch.frac(
            freq[None, :] * (r[:, None] * BLOCK))
        coef = torch.polar(amp[None, :].expand(r.shape[0], m).contiguous(), ph)
        x = (coef @ base).reshape(-1)
        s0 = r0 * BLOCK
        x = x[: min(n, s0 + x.shape[0]) - s0]
        noise = torch.randn(x.shape[0], generator=g, dtype=torch.float32,
                            device=device) * tn["noise_rms"]
        out[s0:s0 + x.shape[0]] = torch.complex(
            x.real.to(torch.float32) + noise, torch.zeros_like(noise))
    return out


def least_work(cfg: dict, block_len: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one step of ``block_len`` input samples: the branch
    FIRs' P multiply-adds of a real tap on complex data (4 FLOPs) a sample,
    the M-point FFT of each row (5·M·log2 M a row), and Abs (3 a sample, the
    square root not counted). Bytes: the input read once (8 a sample) and
    the float32 magnitudes written once (4 a sample)."""
    t = block_len
    m, p = cfg["n_channels"], cfg["taps_per_phase"]
    flops = t * 4.0 * p + (t // m) * 5.0 * m * math.log2(m) + 3.0 * t
    return flops, 12.0 * t
