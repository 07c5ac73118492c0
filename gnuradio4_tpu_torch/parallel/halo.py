"""Time-axis (sequence) sharding with halo exchange, over shard lists.

When a stream's time axis is sharded, each shard needs the last ``K−1``
samples of its *left* neighbour as convolution prehistory (the reference's
carried HistoryBuffer, core HistoryBuffer.hpp:68). Every function here takes
a sharded value as a list of per-shard tensors (``parallel/collectives.py``)
and returns lists; the JAX package's versions run inside ``shard_map`` with
``ppermute``/``psum``. A carried state that leaves these functions is one
tensor on the first shard's device (the mesh's home), where block states
live.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.errors import GrError
from .collectives import ShardAxis, ppermute


def halo_left(xs: Sequence[torch.Tensor], n: int,
              edge_state: torch.Tensor | None = None) -> list[torch.Tensor]:
    """The last ``n`` samples (trailing axis) of each shard's left
    neighbour: shard 0 receives ``edge_state`` (the carried history of the
    previous scheduler step) or zeros. Returns one ``[..., n]`` per shard.
    A shard shorter than ``n`` raises ``GrError``."""
    if n > xs[0].shape[-1]:
        raise GrError(f"local shard length {xs[0].shape[-1]} < halo {n}; "
                      f"increase block_len")
    tails = [x[..., x.shape[-1] - n:] for x in xs]
    # each shard sends its tail to its right neighbour
    out = ppermute(tails, [(i, i + 1) for i in range(len(xs) - 1)])
    if edge_state is not None:
        out[0] = edge_state.to(device=xs[0].device, dtype=xs[0].dtype)
    return out


def last_shard_tail(xs: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """The global stream's trailing ``n`` samples: the last shard's tail, as
    one tensor on the first shard's device (a carried state)."""
    x = xs[-1]
    return x[..., x.shape[-1] - n:].to(xs[0].device).clone()


def nco_shard_apply(block, state, ins: Sequence[dict], local_ctx: Sequence,
                    axis: ShardAxis, dphi: int, n_local: int):
    """``block.apply`` of an integer-NCO block on each time shard.

    The NCO phase is a pure function of global sample position, so shard
    ``i`` starts from ``state + i·n_local·dphi`` (mod 2³²: bit-identical to
    the unsharded stream). Returns the advanced *global* phase and one
    output dict per shard. Shared by SignalGenerator, Rotator and friends."""
    from ..blocks.basic import phase_state
    base = int(state)
    outs = []
    for i in range(axis.size):
        _, o = block.apply(phase_state(base + int(dphi) * i * n_local),
                           ins[i], local_ctx[i])
        outs.append(o)
    return phase_state(base + int(dphi) * axis.size * n_local), outs


def fir_timeshard(xs: Sequence[torch.Tensor], taps,
                  edge_state: torch.Tensor | None = None, *, decim: int = 1,
                  precision: str | None = None
                  ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Overlap-save FIR on a time-sharded stream: each shard filters with its
    left neighbour's halo through ``fir_apply`` (the ``fir_banded`` kernel on
    the card). Returns ``(ys, new_edge_state)``: one ``[..., T_local//decim]``
    per shard, and the global stream's tail, the next step's shard-0 halo.
    ``precision`` goes to ``fir_apply``."""
    from ..ops.fir import fir_apply
    k = np.asarray(taps).shape[-1] if not torch.is_tensor(taps) \
        else taps.shape[-1]
    hists = halo_left(xs, k - 1, edge_state) if k > 1 \
        else [x[..., :0] for x in xs]
    ys = [fir_apply(x, taps, h, decim=decim, precision=precision)[0]
          for x, h in zip(xs, hists)]
    return ys, last_shard_tail(xs, k - 1)


def quadrature_demod_timeshard(xs: Sequence[torch.Tensor],
                               edge_last: torch.Tensor, *, gain
                               ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """FM discriminator on a time-sharded complex stream (1-sample halo).
    Returns one output per shard and the global stream's last sample."""
    from ..ops.demod import quadrature_demod
    prevs = halo_left(xs, 1, edge_last[..., None])
    ys = [quadrature_demod(x, p[..., 0], gain=gain)[0]
          for x, p in zip(xs, prevs)]
    return ys, last_shard_tail(xs, 1)[..., 0]
