"""``Scheduler(mesh=)`` and ``compile_graph(mesh=)`` in the port against the
JAX package, on the CPU: every case of ``tests/test_mesh_scheduler.py`` and
the mesh case of ``test_feedback.py``, ``test_rotation_absorption.py``,
``test_step_batching.py``, ``test_uncertain_stream.py``,
``test_device_vector_source.py``, ``test_reference_golden.py``,
``test_ldpc.py`` (``test_gnss.py``'s is in tests/test_torch_parallel.py),
and the design rule's guards (a shard that raises, a conflicting device).

Each case runs the same seeded inputs three ways: the JAX package on a mesh
over its 8 virtual CPU devices, the port on a mesh of ``[cpu] * n``, and the
port with ``mesh=None``. Block lengths are the JAX tests' own. Tolerances,
per case: the port's sharded run against its unsharded run is held to the
JAX test's own bound — bitwise where the JAX test is bitwise, except where a
FIR's shards round differently from the whole stream (the port's plain FIR
is a matmul over tiles of the stream, whose tile and BLAS blocking follow
the stream's length: ``FIR_SHARD_ATOL`` = 1e-5, the case says so; the JAX
package's CPU FIR is a convolution); the port against the JAX
package is held to the bound of the port's parity tests for those blocks
(``XPKG_ATOL`` = 1e-5 unless the case states another).
"""

import threading
from importlib import import_module

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu_torch.core.errors import GrError as TGrError
from gnuradio4_tpu_torch.parallel.mesh import PartitionSpec, make_mesh

torch.set_num_threads(2)

FIR_SHARD_ATOL = 1e-5
XPKG_ATOL = 1e-5
CPU = torch.device("cpu")


def _mod(pkg, name):
    return import_module(f"{pkg.__name__}.{name}")


def _mesh(pkg, shape, axes):
    """A mesh of ``shape`` over ``axes``: the JAX package's over its
    virtual devices, the port's over the repeated CPU device."""
    n = int(np.prod(shape))
    if pkg is gr:
        devs = jax.devices()
        if len(devs) < n:
            pytest.skip(f"needs {n} virtual CPU devices")
        return JMesh(np.asarray(devs[:n]).reshape(shape), axes)
    return make_mesh(shape, axes, devices=[CPU] * n)


SP8 = ((8,), ("sp",))
CHAN8 = ((8,), ("chan",))
SP4_CHAN2 = ((4, 2), ("sp", "chan"))


def _run(pkg, build, mesh, **kw):
    """Build the graph in ``pkg``, run it to its end under ``mesh`` (a
    ``(shape, axes)`` pair or None) and return every sink's data."""
    g, sinks = build(pkg)
    if pkg is gt and mesh is None:
        kw.setdefault("device", "cpu")
    m = None if mesh is None else _mesh(pkg, *mesh)
    pkg.Scheduler(g, mesh=m, **kw).run_and_wait()
    return [np.asarray(s.data()) for s in sinks]


def _three(build, mesh, **kw):
    """(JAX sharded, port sharded, port unsharded) sink data."""
    return (_run(gr, build, mesh, **kw), _run(gt, build, mesh, **kw),
            _run(gt, build, None, **kw))


def _check(build, mesh, *, self_atol=None, xpkg_atol=XPKG_ATOL, **kw):
    """Port sharded vs port unsharded (bitwise, or ``self_atol``) and vs
    the JAX package sharded (``xpkg_atol``); returns the port's sharded
    data."""
    j, t, u = _three(build, mesh, **kw)
    for a, b, c in zip(j, t, u):
        assert a.shape == b.shape == c.shape
        if self_atol is None:
            np.testing.assert_array_equal(b, c)
        else:
            np.testing.assert_allclose(b, c, rtol=0.0, atol=self_atol)
        np.testing.assert_allclose(b, a, rtol=0.0, atol=xpkg_atol)
    return t


def _compile(pkg, build, mesh, **kw):
    g, _ = build(pkg)
    if pkg is gt:
        kw.setdefault("device", "cpu")
    return pkg.compile_graph(g, mesh=_mesh(pkg, *mesh), **kw)


def _iq(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _audio_taps():
    from gnuradio4_tpu_torch.ops import filter_design as fd
    return fd.design_fir("lowpass", 33, sample_rate=1.0, f_low=0.1,
                         window="Hamming").astype(np.float32)


def _pfb_demod(iq, fir_taps=None):
    def build(pkg):
        t = _mod(pkg, "blocks.testing")
        g = pkg.Graph()
        src = t.VectorSource(iq)
        chan = _mod(pkg, "blocks.channelizer").PFBChannelizer(
            n_channels=64, taps_per_phase=4)
        dem = _mod(pkg, "blocks.sdr").QuadratureDemod(gain=1.0)
        snk = t.VectorSink()
        chain = [src, chan, dem]
        if fir_taps is not None:
            chain.append(_mod(pkg, "blocks.filter").FirFilter(taps=fir_taps,
                                                               decim=4))
        g.connect_chain(*chain, snk)
        return g, [snk]
    return build


# -- tests/test_mesh_scheduler.py -------------------------------------------------

def test_mesh_run_matches_unsharded():
    """A ``chan`` mesh records a channel spec and leaves the values whole:
    bitwise equal to the port's unsharded run; within 1e-4 of the JAX
    package's chan-sharded run (its own bound against unsharded)."""
    n = 64 * 512
    out = _check(_pfb_demod(_iq(5, n)), CHAN8, xpkg_atol=1e-4,
                 block_len=n // 2)
    assert out[0].shape == (64, 512)


def test_mesh_sharding_constraint_present():
    """The compiled graph carries the channel spec (the JAX package's HLO
    carries the GSPMD annotation): the PFB's and the demod's [64, T]
    outputs get ``PartitionSpec('chan', None)``, the 1-D source none."""
    build = _pfb_demod(np.zeros(64 * 128, np.complex64))
    c = _compile(gt, build, CHAN8, block_len=64 * 128)
    specs = {(u.split("#")[0], p): s for (u, p), s in c.out_specs.items()}
    assert specs == {("PFBChannelizer", "out"): PartitionSpec("chan", None),
                     ("QuadratureDemod", "out"): PartitionSpec("chan", None)}
    assert c.sp_axis is None and c.sp_plan == {}
    jc = _compile(gr, build, CHAN8, block_len=64 * 128, jit=False)
    import jax.numpy as jnp
    txt = jax.jit(jc.step_fn).lower(
        jc.init_states(), jc.gather_params(),
        {b.unique_name: {p.name: jnp.zeros((64 * 128,), jnp.complex64)
                         for p in b.out_ports}
         for b in jc.fed_blocks}).as_text()
    assert "sharding" in txt


class TestUnifiedSpSharding:
    def test_sharded_rx_as_plain_graph(self):
        """PFBChannelizer → QuadratureDemod → FirFilter(33, ÷4) over sp 8:
        the JAX test is bitwise; the port's FIR shards hold 64 samples, a
        smaller tile than the whole stream's (FIR_SHARD_ATOL)."""
        n = 64 * 1024
        out = _check(_pfb_demod(_iq(5, n), _audio_taps()), SP8,
                     self_atol=FIR_SHARD_ATOL, block_len=n // 2,
                     pipeline_depth=1)
        assert out[0].shape == (64, 256)

    def test_freq_xlating_nco_phase_offsets(self):
        """Each shard offsets its integer NCO phase by its global position;
        the JAX test's bound 1e-6."""
        def build(pkg):
            g = pkg.Graph()
            src = g.emplace("ComplexToneSource", frequency=0.12,
                            n_samples=32768)
            fx = g.emplace("FreqXlatingFir", center_freq=0.1,
                           sample_rate_in=1.0, decim=4,
                           taps=tuple(np.hamming(31) / np.hamming(31).sum()))
            snk = pkg.global_registry.create("VectorSink")
            g.connect_chain(src, fx, snk)
            return g, [snk]
        _check(build, SP8, self_atol=1e-6, block_len=8192, pipeline_depth=1)

    def test_sequential_block_gather_island(self):
        """FmDeemphasis (a scan state) lowers as a gather island: bitwise."""
        def build(pkg):
            g = pkg.Graph()
            src = g.emplace("SignalGenerator", frequency=1000.0,
                            n_samples=16384)
            de = g.emplace("FmDeemphasis", tau=75e-6, sample_rate_in=48000.0)
            mul = g.emplace("MultiplyConst", value=2.0)
            snk = pkg.global_registry.create("VectorSink")
            g.connect_chain(src, de, mul, snk)
            return g, [snk]
        _check(build, SP8, block_len=4096, sample_rate=48000.0,
               pipeline_depth=1)
        c = _compile(gt, build, SP8, block_len=4096, sample_rate=48000.0)
        kinds = {u.split("#")[0]: k for u, k in c.sp_plan.items()}
        assert kinds == {"SignalGenerator": "custom", "FmDeemphasis": "island",
                         "MultiplyConst": "local", "VectorSink": "local"}

    def test_collectives_present_in_sharded_program(self):
        """The sp program halos the PFB, the demod and the FIR (the JAX
        package's lowered program holds ppermute and all_reduce)."""
        build = _pfb_demod(np.zeros(64 * 512, np.complex64),
                           np.ones(17, np.float32) / 17)
        c = _compile(gt, build, SP8, block_len=64 * 512)
        kinds = {u.split("#")[0]: k for u, k in c.sp_plan.items()}
        assert kinds == {"VectorSource": "local", "PFBChannelizer": "halo",
                         "QuadratureDemod": "halo", "FirFilter": "halo",
                         "VectorSink": "local"}
        assert c.sp_axis.size == 8 and c.sp_axis.devices == (CPU,) * 8
        assert all(len(v) == 8 and v[0].in_len == {"in": 64 * 512 // 8}
                   for k, v in c.sp_local_ctx.items()
                   if k.startswith("PFBChannelizer"))


class TestIndexedNcoSharding:
    """The JAX tests allow 2 f32 ulps between sharded and unsharded NCO
    streams (its factored ramp's fused products); the port's shards take the
    same factored form (local lengths are multiples of its 1024 tile) and
    its Rotator mixes per sample, so its shards are bitwise."""

    def test_sources_and_rotator_bit_exact(self):
        def build(pkg):
            g = pkg.Graph()
            src = g.emplace("SignalGenerator", frequency=1234.5,
                            n_samples=32768)
            snk1 = pkg.global_registry.create("VectorSink")
            g.connect(src, snk1)
            tone = g.emplace("ComplexToneSource", frequency=777.0,
                             n_samples=32768)
            rot = g.emplace("Rotator", frequency_shift=0.01,
                            sample_rate=48000.0)
            snk2 = pkg.global_registry.create("VectorSink")
            g.connect_chain(tone, rot, snk2)
            return g, [snk1, snk2]
        _check(build, SP8, block_len=8192, sample_rate=48000.0,
               pipeline_depth=1)

    def test_rotator_phase_increment_surface_sharded(self):
        """``_phoff`` applies once on the sp path (inside ``apply``)."""
        def build(pkg):
            g = pkg.Graph()
            tone = g.emplace("ComplexToneSource", frequency=777.0,
                             n_samples=32768)
            rot = g.emplace("Rotator", phase_increment=np.pi / 2,
                            initial_phase=0.3)
            snk = pkg.global_registry.create("VectorSink")
            g.connect_chain(tone, rot, snk)
            return g, [snk]
        _check(build, SP8, block_len=8192, sample_rate=48000.0,
               pipeline_depth=1)

    def test_no_gather_island_in_program(self):
        def build(pkg):
            g = pkg.Graph()
            src = g.emplace("ComplexToneSource", frequency=777.0, n_samples=0)
            rot = g.emplace("Rotator", frequency_shift=0.01,
                            sample_rate=48000.0)
            snk = pkg.global_registry.create("NullSink")
            g.connect_chain(src, rot, snk)
            return g, []
        c = _compile(gt, build, SP8, block_len=8192, sample_rate=48000.0)
        assert "island" not in c.sp_plan.values()
        assert sorted(c.sp_plan.values()) == ["custom", "custom", "local"]


class TestCombinedSpChanMesh:
    def test_receiver_on_2d_mesh(self):
        """(sp 4, chan 2): time shards and the chan spec together; the JAX
        test is bitwise, the port's FIR shards hold one 128-sample tile
        against the whole stream's four (FIR_SHARD_ATOL)."""
        n = 64 * 1024
        _check(_pfb_demod(_iq(5, n), _audio_taps()), SP4_CHAN2,
               self_atol=FIR_SHARD_ATOL, block_len=n // 2, pipeline_depth=1)
        c = _compile(gt, _pfb_demod(_iq(5, n), _audio_taps()), SP4_CHAN2,
                     block_len=n // 2)
        assert c.sp_axis.size == 4
        assert sorted(set(c.out_specs.values())) == [PartitionSpec("chan",
                                                                   None)]


class TestMoreHaloBlocks:
    def test_moving_average_and_overlap_fft(self):
        """MovingAverage(33) and an overlapped FFT (256, stride 128) halo;
        the JAX test's bound 1e-6."""
        def build(pkg):
            g = pkg.Graph()
            src = g.emplace("SignalGenerator", frequency=997.0,
                            n_samples=65536)
            ma = g.emplace("MovingAverage", length=33)
            fft = g.emplace("FFT", fft_size=256, stride=128, window="Hann",
                            output="magnitude")
            snk = pkg.global_registry.create("VectorSink")
            g.connect_chain(src, ma, fft, snk)
            return g, [snk]
        _check(build, SP8, self_atol=1e-6, block_len=16384,
               sample_rate=48000.0, pipeline_depth=1)

    def test_diff_phasor_halo(self):
        """DiffPhasor's one-sample halo (no JAX test: held to both)."""
        x = _iq(8, 16384)

        def build(pkg):
            g = pkg.Graph()
            src = _mod(pkg, "blocks.testing").VectorSource(x)
            dp = g.emplace("DiffPhasor")
            snk = pkg.global_registry.create("VectorSink")
            g.add(src)
            g.connect_chain(src, dp, snk)
            return g, [snk]
        _check(build, SP8, block_len=4096, pipeline_depth=1)


class TestRandomGraphSpEquivalence:
    POOL = (
        lambda g: g.emplace("MultiplyConst", value=1.7),
        lambda g: g.emplace("AddConst", value=0.3),
        lambda g: g.emplace("MovingAverage", length=17),
        lambda g: g.emplace("FirFilter",
                            taps=tuple((np.hamming(21) / 11).tolist())),
        lambda g: g.emplace("FmDeemphasis", tau=75e-6,
                            sample_rate_in=48000.0),   # island member
        lambda g: g.emplace("Abs"),
    )

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_chain(self, seed):
        """The JAX test's bound 2e-6."""
        rng = np.random.default_rng(seed)
        picks = [int(rng.integers(0, len(self.POOL)))
                 for _ in range(int(rng.integers(2, 5)))]

        def build(pkg):
            g = pkg.Graph()
            prev = g.emplace("SignalGenerator", frequency=500.0 + seed,
                             n_samples=32768)
            for p in picks:
                blk = self.POOL[p](g)
                g.connect(prev, blk)
                prev = blk
            snk = pkg.global_registry.create("VectorSink")
            g.connect(prev, snk)
            return g, [snk]
        _check(build, SP8, self_atol=2e-6, block_len=8192,
               sample_rate=48000.0, pipeline_depth=1)


class TestResamplerSpSharding:
    @pytest.mark.parametrize("interp,decim", [(1, 4), (3, 2), (2, 3)])
    def test_resampler_matches_unsharded(self, interp, decim):
        """The JAX test's bound 1e-6."""
        rng = np.random.default_rng(interp * 10 + decim)
        x = rng.standard_normal(3 * 2 * 4 * 8 * 512).astype(np.float32)

        def build(pkg):
            t = _mod(pkg, "blocks.testing")
            g = pkg.Graph()
            src = t.VectorSource(x)
            rs = g.emplace("RationalResampler", interp=interp, decim=decim,
                           ntaps_per_phase=12)
            snk = t.VectorSink()
            g.connect(src, rs)
            g.connect(rs, snk)
            return g, [snk]
        _check(build, SP8, self_atol=1e-6, block_len=len(x) // 2,
               pipeline_depth=1)


# -- the mesh cases of the other JAX test files ---------------------------------

def test_feedback_under_sp_mesh_matches_unsharded():
    """tests/test_feedback.py: the loop group runs once on the home device
    over its gathered inputs (the JAX package: a replicated island): bitwise
    against unsharded."""
    rng = np.random.default_rng(3)
    x = (0.25 * rng.standard_normal(4096)).astype(np.float32)

    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("VectorSource", data=x)
        mul = g.emplace("Multiply", n_inputs=2)
        upd = g.emplace("ExpressionDISO",
                        expression="clip(y + 0.01*(1.0 - abs(x)), 1e-6, 65536.0)")
        snk = pkg.global_registry.create("VectorSink")
        g.connect(src, mul["in0"])
        g.connect(mul, upd["x"])
        g.connect(upd["out"], mul["in1"], feedback=True, delay=1, fb_init=1.0)
        g.connect(upd["out"], upd["y"], feedback=True, delay=1, fb_init=1.0)
        g.connect(mul, snk)
        return g, [snk]
    _check(build, SP8, block_len=1024, pipeline_depth=1)
    c = _compile(gt, build, SP8, block_len=1024)
    kinds = {u.split("#")[0]: k for u, k in c.sp_plan.items()}
    assert kinds["Multiply"] == kinds["ExpressionDISO"] == "island"


@pytest.mark.parametrize("absorb", [True, False])
def test_absorbed_sharded_matches_unsharded(monkeypatch, absorb):
    """tests/test_rotation_absorption.py (bound 2e-3), absorbed and with
    GR4TPU_NO_ROTATION_ABSORB=1: the residual phase is linear in the GLOBAL
    index, so per-shard frames and demod line up through the halo."""
    from gnuradio4_tpu_torch.ops import filter_design as fd
    if not absorb:
        monkeypatch.setenv("GR4TPU_NO_ROTATION_ABSORB", "1")
    fs, fc = 1e6, 123e3
    taps = fd.design_fir("lowpass", 63, sample_rate=fs, f_low=100e3
                         ).astype(np.float32)
    iq = _iq(0xC0FFEE, 16384)
    flags = []

    def build(pkg):
        g = pkg.Graph()
        src = g.add(_mod(pkg, "blocks.testing").VectorSource(data=iq))
        fir = g.add(_mod(pkg, "blocks.filter").FreqXlatingFir(
            taps=taps, center_freq=fc, sample_rate_in=fs))
        fft = g.emplace("FFT", fft_size=1024, window="Hann",
                        output="magnitude")
        dem = g.emplace("QuadratureDemod", gain=1.0)
        s1, s2 = g.emplace("VectorSink"), g.emplace("VectorSink")
        g.connect_chain(src, fir, fft, s1)
        g.connect(fir, dem)
        g.connect(dem, s2)
        flags.append(fir)
        return g, [s1, s2]
    _check(build, SP8, self_atol=2e-3, xpkg_atol=2e-3, block_len=8192,
           sample_rate=fs)
    assert [getattr(f, "_rotation_absorbed", False) for f in flags] \
        == [absorb] * 3


def test_sp_sharded_batched_matches_unsharded():
    """tests/test_step_batching.py (bound 1e-5): batch_steps=4 runs four
    sharded sub-steps per dispatch."""
    x = _iq(0xC0FFEE, 1 << 15)

    def build(pkg):
        t = _mod(pkg, "blocks.testing")
        g = pkg.Graph()
        src = t.VectorSource(x)
        g.add(src)
        fir = g.emplace("FirFilter", taps=(0.5, 0.25, 0.125))
        dem = g.emplace("QuadratureDemod", gain=1.0)
        snk = t.VectorSink()
        g.connect_chain(src, fir, dem, snk)
        return g, [snk]
    ref = _run(gt, build, None, block_len=4096, sample_rate=1e6)
    j = _run(gr, build, SP8, block_len=4096, sample_rate=1e6, batch_steps=4)
    t = _run(gt, build, SP8, block_len=4096, sample_rate=1e6, batch_steps=4)
    np.testing.assert_allclose(t[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(t[0], j[0], atol=XPKG_ATOL)


def test_uncertain_fir_chain_sp_sharded_exact():
    """tests/test_uncertain_stream.py: the 2-plane (value, sigma) FIR chain
    halos both planes; bitwise (512-sample shards, whole tiles)."""
    rng = np.random.default_rng(10)
    n = 16384
    v, s = rng.standard_normal(n), rng.uniform(0.1, 1, n)
    h = np.hanning(63)
    h /= h.sum()

    def build(pkg):
        g = pkg.Graph()
        sv = g.emplace("VectorSource", data=v.astype(np.float32))
        ss = g.emplace("VectorSource", data=s.astype(np.float32))
        tu = g.emplace("ToUncertain")
        g.connect(sv, tu, dst_port="in")
        g.connect(ss, tu, dst_port="sigma")
        fir = g.emplace("FirFilter", taps=tuple(h), uncertain=True)
        fu = g.emplace("FromUncertain")
        kv, ks = g.emplace("VectorSink"), g.emplace("VectorSink")
        g.connect(tu, fir)
        g.connect(fir, fu)
        g.connect(fu["value"], kv)
        g.connect(fu["sigma"], ks)
        return g, [kv, ks]
    _check(build, SP8, block_len=4096, sample_rate=48000.0)


def test_device_vector_source_sp_mesh_island():
    """tests/test_device_vector_source.py: a device-resident VectorSource
    (an island) on a 4-shard mesh: bitwise."""
    data = _iq(0xC0FFEE, 512)

    def build(pkg):
        t = _mod(pkg, "blocks.testing")
        g = pkg.Graph()
        src = t.VectorSource(data, device_resident=True)
        snk = t.VectorSink()
        g.add(src)
        g.add(snk)
        g.connect(src, snk)
        return g, [snk]
    _check(build, ((4,), ("sp",)), block_len=256, pipeline_depth=1)


def test_noise_sp_island_exact():
    """tests/test_reference_golden.py: a GaussianNoise SignalGenerator under
    sp is a gather island (the full threefry stream drawn once): bitwise;
    the noise within 1e-5 of the JAX package's (the port's parity bound for
    its Gaussian draws)."""
    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("SignalGenerator", signal="GaussianNoise", seed=3,
                        n_samples=16384)
        fir = g.emplace("FirFilter", taps=tuple((np.ones(16) / 16).tolist()))
        snk = g.emplace("VectorSink")
        g.connect_chain(src, fir, snk)
        return g, [snk]
    _check(build, SP8, block_len=8192, sample_rate=48e3)


def test_ldpc_decoder_sp_sharded_bit_exact():
    """tests/test_ldpc.py: a framewise decoder (alignment 256) under sp 8
    rounds block_len to alignment·sp and islands; bits equal everywhere."""
    from gnuradio4_tpu_torch.ops.ldpc import encode, make_ldpc
    H, G = make_ldpc(256, 128, wc=3, seed=0)
    k = G.shape[0]
    rng = np.random.default_rng(4)
    u = rng.integers(0, 2, 8 * k).astype(np.float32)
    c = encode(G, u.reshape(-1, k).astype(np.uint8)).reshape(-1)
    y = 1.0 - 2.0 * c + 0.6 * rng.standard_normal(len(c))
    llr = (2 * y / 0.36).astype(np.float32)

    def build(pkg):
        t = _mod(pkg, "blocks.testing")
        g = pkg.Graph()
        src = g.add(t.VectorSource(llr))
        dec = g.emplace("LdpcDecoder", n=256, m=128, seed=0)
        snk = g.add(t.VectorSink())
        g.connect_chain(src, dec, snk)
        return g, [snk]
    out = _check(build, SP8, xpkg_atol=0.0, block_len=1024, sample_rate=1e6)
    np.testing.assert_array_equal(out[0], u)
    c = _compile(gt, build, SP8, block_len=1024, sample_rate=1e6)
    assert c.in_len[next(u for u in c.in_len if u.startswith("Ldpc"))] == 2048


# -- the scheduler under sp ---------------------------------------------------------

def test_tag_ramp_becomes_step_boundary_change():
    """Under sp a sample-accurate tag setting is no per-sample ramp: the
    staged change applies from a step boundary (the one that starts the
    tag's step), with the same TagSettings notice on the bus, in both
    packages."""
    x = _iq(12, 8192)

    def build(pkg):
        t = _mod(pkg, "blocks.testing")
        tags = _mod(pkg, "core.tags")
        g = pkg.Graph()
        src = t.VectorSource(x, tags=[tags.Tag(1000, {"gain": 2.0})])
        g.add(src)
        dem = g.emplace("QuadratureDemod", gain=1.0)
        snk = t.VectorSink()
        g.connect_chain(src, dem, snk)
        return g, [snk]
    notes, data = {}, {}
    for pkg in (gr, gt):
        g, (snk,) = build(pkg)
        s = pkg.Scheduler(g, block_len=2048, pipeline_depth=1,
                          mesh=_mesh(pkg, *SP8))
        seen = notes[pkg.__name__] = []
        s.bus.subscribe("TagSettings", seen.append)
        s.run_and_wait()
        data[pkg.__name__] = np.asarray(snk.data())
    assert [m.data["note"] for m in notes["gnuradio4_tpu_torch"]] == \
        [m.data["note"] for m in notes["gnuradio4_tpu"]] == \
        ["sample-accurate ramp skipped under sp sharding; applied at the "
         "next step boundary"]
    j, t = data["gnuradio4_tpu"], data["gnuradio4_tpu_torch"]
    np.testing.assert_allclose(t, j, atol=XPKG_ATOL)
    u = _run(gt, build, None, block_len=2048, pipeline_depth=1)[0]
    # unsharded: the new gain from sample 1000 on; sharded (both packages):
    # the staged change from the boundary that starts the tag's step
    np.testing.assert_array_equal(t[:1000], 2.0 * u[:1000])
    np.testing.assert_array_equal(t[1000:], u[1000:])


def test_sp_mesh_pipelined_async_delivery():
    """pipeline_depth 2 with async delivery takes the joined sink inputs;
    bitwise against the synchronous sharded run."""
    def build(pkg):
        g = pkg.Graph()
        src = g.emplace("SignalGenerator", frequency=997.0, n_samples=65536)
        fir = g.emplace("FirFilter",
                        taps=tuple((np.hamming(21) / 11).tolist()))
        snk = pkg.global_registry.create("VectorSink")
        g.connect_chain(src, fir, snk)
        return g, [snk]
    a = _run(gt, build, SP8, block_len=8192, sample_rate=48e3,
             pipeline_depth=2, async_delivery=True)
    b = _run(gt, build, SP8, block_len=8192, sample_rate=48e3,
             pipeline_depth=1)
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("kind", ["FirFilter", "FreqXlatingFir"])
def test_halo_longer_than_shard_raises(kind):
    """A shard shorter than a block's halo is refused with the JAX
    package's message (a FIR of 1025 taps on 512-sample shards). The JAX
    package's FreqXlatingFir takes no such check, so its case runs in the
    port alone."""
    def build(pkg):
        g = pkg.Graph()
        if kind == "FirFilter":
            src = g.emplace("SignalGenerator", frequency=997.0, n_samples=8192)
            fir = g.emplace("FirFilter", taps=tuple(np.ones(1025) / 1025))
        else:
            src = g.emplace("ComplexToneSource", frequency=0.12,
                            n_samples=8192)
            fir = g.emplace("FreqXlatingFir", center_freq=0.1,
                            sample_rate_in=1.0,
                            taps=tuple(np.ones(1025) / 1025))
        snk = pkg.global_registry.create("VectorSink")
        g.connect_chain(src, fir, snk)
        return g, [snk]
    if kind == "FirFilter":
        with pytest.raises(gr.GrError, match="local shard length 512 < halo 1024"):
            _run(gr, build, SP8, block_len=4096)
    with pytest.raises(TGrError, match="local shard length 512 < halo 1024") as e:
        _run(gt, build, SP8, block_len=4096)
    assert kind in str(e.value)          # the block is named


def test_dryrun_multichip_on_the_cpu():
    """The port's ``dryrun_multichip`` (the three topologies of
    ``__graft_entry__.dryrun_multichip``) on 8 CPU shards."""
    from gnuradio4_tpu_torch.parallel.dryrun import dryrun_multichip
    recs = dryrun_multichip(8, device="cpu")
    assert [r["mesh"] for r in recs] == [{"sp": 4, "chan": 2}, {"sp": 8},
                                         {"sp": 8}]
    assert all(r["max_abs_err"] < 1e-4 for r in recs)
    assert recs[2]["tags"] == [(0, 1), (128, 2)]


# -- guards of the design rule ---------------------------------------------------------

def test_a_shard_that_raises_surfaces_a_grerror():
    """A block whose apply raises on one shard stops the run with a GrError
    naming the block, well inside the test's own timeout (no shard waits on
    another)."""
    from gnuradio4_tpu_torch.blocks.math import MultiplyConst

    class Boom(MultiplyConst):
        def apply(self, state, ins, ctx):
            if ins["in"].shape[-1] == ctx.in_len["in"] and self.calls == 5:
                raise ValueError("kaboom on shard 5")
            self.calls += 1
            return super().apply(state, ins, ctx)

    g = gt.Graph()
    src = g.emplace("SignalGenerator", frequency=997.0, n_samples=65536)
    boom = Boom(value=2.0, name="boom")
    boom.calls = 0
    snk = gt.global_registry.create("VectorSink")
    g.add(boom)
    g.connect_chain(src, boom, snk)
    s = gt.Scheduler(g, block_len=8192, mesh=make_mesh(
        (8,), ("sp",), devices=[CPU] * 8))
    errors = []

    def run():
        try:
            s.run_and_wait()
        except TGrError as e:
            errors.append(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "the scheduler hung after a shard raised"
    assert len(errors) == 1 and "boom" in str(errors[0]) \
        and "kaboom on shard 5" in str(errors[0])


def test_mesh_with_a_conflicting_device_raises():
    mesh = make_mesh((8,), ("sp",), devices=[CPU] * 8)
    g, _ = _pfb_demod(np.zeros(64 * 128, np.complex64))(gt)
    with pytest.raises(TGrError, match="conflicts with the mesh"):
        gt.Scheduler(g, block_len=64 * 128, mesh=mesh, device="meta")
    with pytest.raises(TGrError, match="conflicts with the mesh"):
        gt.compile_graph(g, block_len=64 * 128, mesh=mesh, device="meta")
    # the mesh's own device is no conflict
    s = gt.Scheduler(g, block_len=64 * 128, mesh=mesh, device="cpu")
    assert s.device == CPU
    with pytest.raises(TGrError, match="parallel.mesh.Mesh"):
        gt.compile_graph(g, block_len=64 * 128, mesh=object())
