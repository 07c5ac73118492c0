"""Plain reference of pfb_channelizer, in float64 PyTorch (bfloat16 for the
control). It imports nothing of the program: it works the bank out again
from the input samples and the prototype the benchmark designed.

The analysis bank of M channels and P taps a phase, for one step of T input
samples preceded by ``history(cfg)`` = (P−1)·M earlier samples:

    X[n, p] = x[n·M + p]                         (rows of M samples)
    v[n, p] = Σ_j h[j·M + p] · X[n − j, p]       (branch FIRs)
    y[n, m] = Σ_p v[n, p] · e^{−j2π·p·m/M}       (DFT across the branches)

and the Abs block's ``|y|``, laid out [M, T/M] (channel m centred at
m·fs/M). This is the convention of the port's PFBChannelizer.
"""

from __future__ import annotations

import torch


def history(cfg: dict) -> int:
    return (cfg["taps_per_phase"] - 1) * cfg["n_channels"]


def outputs(x_ext: torch.Tensor, cfg: dict, block_len: int, consts: dict,
            dtype: torch.dtype = torch.float64) -> dict[str, torch.Tensor]:
    """``{"channels": [M, T/M]}`` (float64). With ``dtype`` bfloat16 the
    input, the taps and every multiply-add are rounded to bfloat16, the DFT
    runs in float32 on those values (no bfloat16 FFT), and the magnitudes are
    rounded to bfloat16."""
    m, p = cfg["n_channels"], cfg["taps_per_phase"]
    r = block_len // m
    dev = x_ext.device
    low = dtype != torch.float64
    rd = dtype if low else torch.float64
    h = torch.as_tensor(consts["prototype"], dtype=torch.float64, device=dev)
    hp = h.reshape(p, m).to(rd)                                  # [P, M]
    xr = torch.view_as_real(x_ext.to(torch.complex128)).to(rd)   # [N, 2]
    rows = xr.reshape(-1, m, 2)                                  # [P−1+R, M, 2]
    acc = None
    for j in range(p):
        term = rows[p - 1 - j: p - 1 - j + r] * hp[j][None, :, None]
        acc = term if acc is None else acc + term
    v = torch.view_as_complex(acc.to(torch.float32 if low else torch.float64)
                              .contiguous())
    y = torch.fft.fft(v, dim=-1).abs()                           # [R, M]
    if low:
        y = y.to(dtype)
    return {"channels": y.t().to(torch.float64).contiguous()}
