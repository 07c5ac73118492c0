"""Sharded wideband receiver: the flagship multi-device pipeline (BASELINE
configs 4–5).

Structure of one step over a ``(dp, sp)`` mesh (shard ``(d, s)`` holds
streams ``d·B/dp …`` and time block ``s`` of ``T/sp`` samples):

  x [B, T] complex  — B streams split over ``dp``, time split over ``sp``
    │ corner turn  [B, M, R]          (local reshape)
    │ branch FIR   (P−1)-row halo from the left time neighbour  (halo_left)
    │ FFT across branches → channels [B, M, R_local]   (local torch.fft)
    │ all_to_all over sp: channel-shard ↔ time-gather (the corner turn)
    │ per-channel quadrature demod (carried last-sample state)
    │ per-channel audio FIR + decimation (carried history; ``fir_apply``,
    │   the ``fir_banded`` kernel on the card)
    │ pmean output power monitor (a scalar)
  audio [B, M, R/decim] — channels split over sp

Shards are lists of tensors, one per mesh position, and the collectives are
the list functions of ``parallel/collectives.py`` (the JAX package runs this
step inside ``shard_map``). The carried state is held whole on the mesh's
home device and split per shard each step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.errors import GrError
from ..ops import filter_design as fd
from ..ops.channelizer import design_pfb_taps
from ..ops.fir import fir_apply
from .collectives import all_to_all, pmean
from .halo import halo_left, last_shard_tail
from .mesh import Mesh, NamedSharding, PartitionSpec as P


@dataclasses.dataclass
class ShardedRxConfig:
    n_channels: int = 64
    taps_per_phase: int = 8
    audio_decim: int = 4
    audio_ntaps: int = 32
    batch: int = 2
    block_len: int = 1 << 16       # per stream, per step (total time samples)
    demod_gain: float = 1.0


def _grouped_branch_fir(rT: torch.Tensor, hp: torch.Tensor) -> torch.Tensor:
    """rT: [B, M, R'] complex rows-with-halo; hp: [P, M] real branch taps →
    [B, M, R' − P + 1] via P shift-MAC slices (as the JAX package: plain
    elementwise ops, no kernel)."""
    p = hp.shape[0]
    r = rT.shape[-1] - (p - 1)
    acc = None
    for j in range(p):
        term = rT[..., (p - 1 - j): (p - 1 - j) + r] * hp[j][None, :, None]
        acc = term if acc is None else acc + term
    return acc


def build_sharded_rx(mesh: Mesh, cfg: ShardedRxConfig):
    """Returns ``(step, init_state, x_sharding)``.

    ``step(state, x) → (state', audio, power)``: ``x`` is a ``[B, T]``
    complex64 tensor (split by ``x_sharding``, the ``(dp, sp)`` layout, onto
    the mesh's devices) or an already split grid (``x_sharding.split(x)``);
    ``audio`` ``[B, M, T/M/decim]`` and ``power`` (a 0-d tensor) come back
    on the mesh's home device, as do the state's tensors."""
    if mesh.process_count > 1:
        raise GrError("build_sharded_rx runs in one process; a mesh that "
                      "spans processes shards a graph (Scheduler(mesh=))")
    if "dp" not in mesh.axis_names or "sp" not in mesh.axis_names:
        raise GrError(f"build_sharded_rx needs a mesh with 'dp' and 'sp' "
                      f"axes; got {mesh.axis_names}")
    m = cfg.n_channels
    p_ = cfg.taps_per_phase
    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    if m % sp != 0:
        raise ValueError(f"n_channels {m} must be divisible by sp axis {sp}")
    if cfg.batch % dp != 0:
        raise ValueError(f"batch {cfg.batch} must be divisible by dp axis {dp}")
    if cfg.block_len % (m * sp) != 0:
        raise ValueError("block_len must be divisible by n_channels·sp")
    home = mesh.home
    kd, ks = mesh.axis_names.index("dp"), mesh.axis_names.index("sp")
    hp_np = design_pfb_taps(m, p_).astype(np.float32).reshape(p_, m)
    # audio LP at 0.4·channel-rate/decim; host NumPy, as fir_apply wants
    audio_taps = fd.design_fir(
        "lowpass", cfg.audio_ntaps, sample_rate=1.0,
        f_low=0.4 / cfg.audio_decim, window="Hamming").astype(np.float32)
    k = audio_taps.shape[0]
    hp_dev: dict[torch.device, torch.Tensor] = {}
    gain = float(np.float32(cfg.demod_gain))
    x_sharding = NamedSharding(mesh, P("dp", "sp"))
    # the state's layouts (replicated over sp where no axis names it)
    pfb_sharding = NamedSharding(mesh, P("dp", None, None))
    chan_sharding = NamedSharding(mesh, P("dp", "sp"))

    def pos(d: int, s: int) -> tuple:
        idx = [0] * len(mesh.axis_names)
        idx[kd], idx[ks] = d, s
        return tuple(idx)

    def taps_on(dev: torch.device) -> torch.Tensor:
        if dev not in hp_dev:
            hp_dev[dev] = torch.from_numpy(hp_np).to(dev)
        return hp_dev[dev]

    def step(state, x):
        grid = x if isinstance(x, np.ndarray) else x_sharding.split(
            x.to(torch.complex64))
        pfb = pfb_sharding.split(state["pfb"])
        last = chan_sharding.split(state["demod_last"])
        hist = chan_sharding.split(state["audio_hist"])
        new_pfb = np.empty(grid.shape, dtype=object)
        new_last = np.empty(grid.shape, dtype=object)
        new_hist = np.empty(grid.shape, dtype=object)
        audio = np.empty(grid.shape, dtype=object)
        powers = []
        for d in range(dp):
            cells = [pos(d, s) for s in range(sp)]
            xs = [grid[c] for c in cells]
            b_l, t_l = xs[0].shape
            r_l = t_l // m
            # corner turn: [B, R_l, M] → branch-major [B, M, R_l]
            rows = [x.reshape(b_l, r_l, m).transpose(1, 2) for x in xs]
            halos = halo_left(rows, p_ - 1, pfb[cells[0]])
            chans = []
            for c, r, h in zip(cells, rows, halos):
                v = _grouped_branch_fir(torch.cat([h, r], dim=-1),
                                        taps_on(r.device))    # [B, M, R_l]
                f = torch.fft.fft(v.transpose(1, 2), dim=-1)  # [B, R_l, M]
                chans.append(f.transpose(1, 2).to(torch.complex64))
            # the corner turn across shards: channel-shard, time-gather
            if sp > 1:
                chans = all_to_all(chans, 1, 2)              # [B, M/sp, R]
            sq = []
            for c, ch in zip(cells, chans):
                # per-channel FM discriminator (carried last sample)
                prev = torch.cat([last[c][..., None].to(ch.device),
                                  ch[..., :-1]], dim=-1)
                dd = ch * prev.conj()
                au = torch.atan2(dd.imag, dd.real) * gain
                new_last[c] = ch[..., -1]
                # audio low-pass + decimate (overlap-save, carried history)
                flat = au.reshape(-1, au.shape[-1])
                y2, h2 = fir_apply(flat, audio_taps,
                                   hist[c].reshape(-1, k - 1).to(au.device),
                                   decim=cfg.audio_decim)
                audio[c] = y2.reshape(*au.shape[:-1], -1)
                new_hist[c] = h2.reshape(*au.shape[:-1], k - 1)
                sq.append(torch.mean(audio[c] * audio[c]))
            # new PFB edge: the global last P−1 rows, from the last sp shard
            tail = last_shard_tail(rows, p_ - 1)
            for c in cells:
                new_pfb[c] = tail
            powers.append(pmean(sq)[0].to(home))
        power = torch.stack(powers).mean()
        new_state = {"pfb": pfb_sharding.gather(new_pfb),
                     "demod_last": chan_sharding.gather(new_last),
                     "audio_hist": chan_sharding.gather(new_hist)}
        return new_state, chan_sharding.gather(audio), power

    def init_state():
        b = cfg.batch
        return {
            "pfb": torch.zeros((b, m, p_ - 1), dtype=torch.complex64,
                               device=home),
            "demod_last": torch.ones((b, m), dtype=torch.complex64,
                                     device=home),
            "audio_hist": torch.zeros((b, m, cfg.audio_ntaps - 1),
                                      dtype=torch.float32, device=home),
        }

    return step, init_state, x_sharding
