"""Multi-shard dry run: the JAX package's ``__graft_entry__.dryrun_multichip``
for the port.

Runs the wideband receiver chain through the ``Scheduler`` over an
``n``-shard mesh (every shard on ``device``: a mesh of one card, or of the
CPU) in the same three topologies at the same sizes, and checks each
against the unsharded run on ``device``: within max|Δ| 1e-4, with tags at
the same indices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.compiler import default_device
from ..core.errors import GrError


def dryrun_multichip(n: int, device: torch.device | str | None = None
                     ) -> list[dict]:
    """The three topologies: ``FreqXlatingFir → PFB16 → demod → FIR`` on an
    ``(sp, chan)`` mesh and on an ``sp`` mesh (the latter with async
    delivery), and suite config 5's shape (PFB32 → demod → tags) on ``sp``
    at ``batch_steps=2``. Raises ``GrError`` on a mismatch; returns one
    record per topology (mesh shape, output shape, max|Δ|, tags)."""
    import gnuradio4_tpu_torch as gt
    from ..blocks.testing import VectorSink, VectorSource
    from ..core.tags import Tag
    from ..ops import filter_design as fd
    from .mesh import make_mesh

    dev = default_device() if device is None else torch.device(device)
    devs = [dev] * n
    meshes = [make_mesh((n,), ("sp",), devices=devs)]
    if n % 2 == 0 and n > 2:
        meshes.insert(0, make_mesh((n // 2, 2), ("sp", "chan"), devices=devs))

    m = 16
    nn = m * n * 64 * 2                 # two scheduler steps
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal(nn) + 1j * rng.standard_normal(nn)
          ).astype(np.complex64)
    audio_taps = tuple(fd.design_fir("lowpass", 17, sample_rate=1.0,
                                     f_low=0.1, window="Hamming").tolist())

    def build():
        g = gt.Graph()
        src = g.emplace("VectorSource", data=iq)
        fx = g.emplace("FreqXlatingFir", center_freq=0.05, sample_rate_in=1.0,
                       decim=1, taps=tuple(np.hamming(9) / np.hamming(9).sum()))
        chan = g.emplace("PFBChannelizer", n_channels=m, taps_per_phase=4)
        dem = g.emplace("QuadratureDemod", gain=1.0)
        fir = g.emplace("FirFilter", taps=audio_taps, decim=2)
        snk = g.emplace("VectorSink")
        g.connect_chain(src, fx, chan, dem, fir, snk)
        return g, snk

    g_ref, snk_ref = build()
    gt.Scheduler(g_ref, block_len=nn // 2, pipeline_depth=1,
                 device=dev).run_and_wait()
    ref = snk_ref.data()

    records = []
    for i, mesh in enumerate(meshes):
        # the async sink-delivery path on one topology too (the FIFO
        # delivery worker must compose with sharded step outputs)
        async_delivery = (i == len(meshes) - 1)
        g_sp, snk_sp = build()
        gt.Scheduler(g_sp, block_len=nn // 2, mesh=mesh, pipeline_depth=1,
                     async_delivery=async_delivery).run_and_wait()
        out = snk_sp.data()
        if out.shape != ref.shape:
            raise GrError(f"dryrun: shapes {out.shape} vs {ref.shape}")
        err = float(np.max(np.abs(out - ref)))
        if not err < 1e-4:
            raise GrError(f"dryrun: sharded/unsharded mismatch: {err}")
        print(f"dryrun_multichip OK: mesh={tuple(mesh.shape.items())} on "
              f"{dev} via Scheduler(async_delivery={async_delivery}), "
              f"chain=FreqXlatingFir→PFB{m}→demod→FIR, out={tuple(out.shape)},"
              f" max|Δ|={err:.2e}")
        records.append({"mesh": dict(mesh.shape), "out": tuple(out.shape),
                        "max_abs_err": err, "async": async_delivery})

    # topology 3: the config-5 shape — wideband channelizer → per-channel
    # demod → tag propagation — under sp over the full mesh with step
    # batching (batch_steps=2): tags must arrive at the sink at the same
    # absolute indices as the unsharded run
    mc = 32
    nc = mc * n * 8 * 4                 # 4 logical steps (2 batches of 2)
    iq5 = (rng.standard_normal(nc) + 1j * rng.standard_normal(nc)
           ).astype(np.complex64)
    marks = [Tag(7, {"burst": 1}), Tag(nc // 2 + 3, {"burst": 2})]

    def build5():
        g = gt.Graph()
        src = VectorSource(iq5, tags=[Tag(t.index, dict(t.map))
                                      for t in marks])
        g.add(src)
        chan = g.emplace("PFBChannelizer", n_channels=mc, taps_per_phase=4)
        dem = g.emplace("QuadratureDemod", gain=1.0)
        snk = VectorSink()
        g.add(snk)
        g.connect_chain(src, chan, dem, snk)
        return g, snk

    def bursts(snk):
        return [(int(t.index), t.map.get("burst"))
                for t in snk.tags if "burst" in t.map]

    g5_ref, snk5_ref = build5()
    gt.Scheduler(g5_ref, block_len=nc // 4, pipeline_depth=1,
                 device=dev).run_and_wait()
    ref5 = snk5_ref.data()
    mesh5 = make_mesh((n,), ("sp",), devices=devs)
    g5, snk5 = build5()
    gt.Scheduler(g5, block_len=nc // 4, mesh=mesh5, pipeline_depth=1,
                 batch_steps=2).run_and_wait()
    out5 = snk5.data()
    if out5.shape != ref5.shape:
        raise GrError(f"dryrun config 5: shapes {out5.shape} vs {ref5.shape}")
    err5 = float(np.max(np.abs(out5 - ref5)))
    if not err5 < 1e-4:
        raise GrError(f"dryrun config 5: sharded/unsharded mismatch: {err5}")
    if bursts(snk5) != bursts(snk5_ref):
        raise GrError(f"dryrun config 5: tags {bursts(snk5)} vs "
                      f"{bursts(snk5_ref)}")
    print(f"dryrun_multichip OK: mesh={tuple(mesh5.shape.items())} on {dev} "
          f"via Scheduler(batch_steps=2), chain=PFB{mc}→demod→tags "
          f"(config-5 shape), out={tuple(out5.shape)}, max|Δ|={err5:.2e}, "
          f"tags={bursts(snk5)}")
    records.append({"mesh": dict(mesh5.shape), "out": tuple(out5.shape),
                    "max_abs_err": err5, "tags": bursts(snk5),
                    "batch_steps": 2})
    return records
