"""Multi-process worker of the PyTorch port: runs sp-sharded graphs through
the Scheduler as one process of a two-process ``torch.distributed`` (Gloo,
CPU) group over a global mesh of 4 CPU shards a process, and the
collectives across the process boundary, and saves what this process got.
Spawned by test_torch_multihost.py — not a test; the test holds the saved
slices against NumPy, the JAX package and the port's single-process run.

The functions that build the graphs take the package (``gnuradio4_tpu`` or
``gnuradio4_tpu_torch``) as an argument, so the test builds the same graphs
in both; importing this module imports neither.

Usage: python torch_multihost_worker.py <process_id> <num_processes> <port> <out_dir>
"""

import os
import sys

import numpy as np

LOCAL_SHARDS = 4
N_FIR = 8192
FS = 1e6


def fir_taps() -> np.ndarray:
    return (np.hamming(31) / np.hamming(31).sum()).astype(np.float32)


def lowpass(k: int, cutoff: float) -> np.ndarray:
    """A Hamming-windowed sinc low-pass of ``k`` taps, ``cutoff`` in
    cycles a sample."""
    n = np.arange(k) - (k - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * n) * np.hamming(k)
    return (h / h.sum()).astype(np.float32)


def fir_input() -> np.ndarray:
    return np.random.default_rng(11).standard_normal(N_FIR).astype(np.float32)


def build_fir(pkg):
    """VectorSource → FirFilter (31 taps) → VectorSink, as
    tests/multihost_worker.py builds it."""
    g = pkg.Graph()
    src = g.emplace("VectorSource", data=fir_input())
    fir = g.emplace("FirFilter", taps=fir_taps())
    snk = g.emplace("VectorSink")
    g.connect_chain(src, fir, snk)
    return g, [snk]


def build_headline(pkg):
    """The headline chain at a small size: ComplexToneSource →
    FreqXlatingFir (127 taps) → {FFT 512 ; QuadratureDemod → FirFilter
    63 taps ÷8}."""
    g = pkg.Graph()
    src = g.emplace("ComplexToneSource", frequency=0.05 * FS)
    fir = g.emplace("FreqXlatingFir", taps=lowpass(127, 0.1),
                    center_freq=0.15 * FS, sample_rate_in=FS)
    fft = g.emplace("FFT", fft_size=512, window="Hann", output="magnitude")
    dem = g.emplace("QuadratureDemod", gain=1.0)
    aud = g.emplace("FirFilter", taps=lowpass(63, 0.05), decim=8)
    s1, s2 = g.emplace("VectorSink"), g.emplace("VectorSink")
    g.connect(src, fir)
    g.connect_chain(fir, fft, s1)
    g.connect_chain(fir, dem, aud, s2)
    return g, [s1, s2]


def build_island(pkg):
    """FmDeemphasis (a scan state) lowers as a gather island."""
    g = pkg.Graph()
    src = g.emplace("SignalGenerator", frequency=1000.0, n_samples=16384)
    de = g.emplace("FmDeemphasis", tau=75e-6, sample_rate_in=48000.0)
    mul = g.emplace("MultiplyConst", value=2.0)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, de, mul, snk)
    return g, [snk]


def build_loop(pkg):
    """A feedback AGC: the loop group runs replicated on every process."""
    x = (0.25 * np.random.default_rng(3).standard_normal(4096)
         ).astype(np.float32)
    g = pkg.Graph()
    src = g.emplace("VectorSource", data=x)
    mul = g.emplace("Multiply", n_inputs=2)
    upd = g.emplace("ExpressionDISO",
                    expression="clip(y + 0.01*(1.0 - abs(x)), 1e-6, 65536.0)")
    snk = g.emplace("VectorSink")
    g.connect(src, mul["in0"])
    g.connect(mul, upd["x"])
    g.connect(upd["out"], mul["in1"], feedback=True, delay=1, fb_init=1.0)
    g.connect(upd["out"], upd["y"], feedback=True, delay=1, fb_init=1.0)
    g.connect(mul, snk)
    return g, [snk]


# name → (build function, scheduler settings, GR4TPU_NO_ROTATION_ABSORB,
#          steps)
GRAPHS = {
    "fir": (build_fir, dict(block_len=N_FIR // 2, pipeline_depth=1), False,
            2),
    "fir_batched": (build_fir, dict(block_len=N_FIR // 4, pipeline_depth=1,
                                    batch_steps=2), False, 4),
    "headline": (build_headline, dict(block_len=8192, sample_rate=FS), False,
                 2),
    "headline_derotated": (build_headline, dict(block_len=8192,
                                                sample_rate=FS), True, 2),
    "island": (build_island, dict(block_len=4096, sample_rate=48000.0,
                                  pipeline_depth=1), False, 4),
    "loop": (build_loop, dict(block_len=1024, pipeline_depth=1), False, 4),
}


def run_graph(pkg, name: str, mesh, **extra):
    """Run ``GRAPHS[name]`` in ``pkg`` under ``mesh`` for its steps;
    every sink's data."""
    build, kw, derotate, steps = GRAPHS[name]
    if derotate:
        os.environ["GR4TPU_NO_ROTATION_ABSORB"] = "1"
    try:
        g, sinks = build(pkg)
        pkg.Scheduler(g, mesh=mesh, **kw, **extra).run_and_wait(steps)
    finally:
        os.environ.pop("GR4TPU_NO_ROTATION_ABSORB", None)
    return [np.asarray(s.data()) for s in sinks]


def collective_inputs(n: int):
    """Seeded global shards: ``n`` of [3, 8] and ``n`` of [2, 4n, 6]."""
    rng = np.random.default_rng(5)
    return ([rng.standard_normal((3, 8)).astype(np.float32) for _ in range(n)],
            [rng.standard_normal((2, 4 * n, 6)).astype(np.float32)
             for _ in range(n)])


def collectives(axis, edge):
    """Every cross-process collective on this process's shards."""
    import torch
    from gnuradio4_tpu_torch.parallel import collectives as col
    from gnuradio4_tpu_torch.parallel import halo
    n, lo = axis.size, axis.first
    small, wide = collective_inputs(n)
    xs = [torch.from_numpy(a) for a in small[lo:lo + axis.local_size]]
    ws = [torch.from_numpy(a) for a in wide[lo:lo + axis.local_size]]
    out = {}
    out["ppermute"] = col.ppermute(xs, [(i, (i + 1) % n) for i in range(n)],
                                   axis)
    out["ppermute_partial"] = col.ppermute(
        xs, [(i, i + 1) for i in range(n - 1)], axis)
    out["all_gather"] = col.all_gather(xs, axis=axis)
    out["psum"] = col.psum(xs, axis)
    out["pmean"] = col.pmean(xs, axis)
    out["all_to_all"] = col.all_to_all(ws, 1, 2, axis)
    out["halo_left"] = halo.halo_left(xs, 3, torch.from_numpy(edge), axis)
    out["last_shard_tail"] = [halo.last_shard_tail(xs, 3, axis)]
    out["split"] = col.split(torch.from_numpy(np.concatenate(small, -1)),
                             axis)
    return {k: np.stack([t.numpy() for t in v]) for k, v in out.items()}


def main() -> int:
    pid, nproc, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    torch.set_num_threads(2)
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.parallel import multihost as mh

    assert mh.init_distributed(f"127.0.0.1:{port}", nproc, pid,
                               device="cpu", timeout=60.0)
    assert mh.backend() == "gloo" and mh.process_count() == nproc
    mesh = mh.global_mesh(("sp",), ["cpu"] * LOCAL_SHARDS)
    assert mesh.shape["sp"] == nproc * LOCAL_SHARDS
    assert mesh.process_index == pid and len(mesh.local_devices) == LOCAL_SHARDS
    saved = {f"col_{k}": v for k, v in collectives(
        mesh.shard_axis("sp"), np.full((3, 3), -1.0, np.float32)).items()}
    for name in GRAPHS:
        for i, d in enumerate(run_graph(gt, name, mesh)):
            saved[f"{name}_{i}"] = d
    np.savez(os.path.join(out_dir, f"rank{pid}.npz"), **saved)
    assert mh.is_coordinator() == (pid == 0)
    mh.shutdown()
    print(f"[{pid}] OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
