"""The port's user-function blocks, ``merge``, the host call, ``StreamSource``
and the host ring against the JAX package's, on the CPU: every case of
``tests/test_pmt_utils_merge.py`` ``TestMerge``/``TestUserBlocks``, of
``tests/test_io_blocks.py`` ``TestStreamSource`` and of
``tests/test_domains_tagarrays_wait.py`` ``TestBlockingWait`` runs the same
seeded input through both packages; the ``StreamSource``-fed cases of
``tests/test_fm_receiver.py:101-160`` run as written in the port and against
the JAX package.

Tolerances: the graphs whose blocks only copy, scale, clip, square or sum
are bitwise equal; ``Abs`` within one ulp (hypot rounds an ulp apart in
torch and XLA); the SSB and FM stereo demodulators within 1e-5 of the
output's scale (``tests/test_torch_sdr_fileio.py``'s ``ATOL``); counts,
dtypes, shapes and errors exact."""

import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core import feeder as jfeeder
from gnuradio4_tpu.native.ring import HostRing as JRing
from gnuradio4_tpu_torch.blocks.python_block import (HostBlock, LambdaBlock,
                                                     PythonBlock, StreamSource)
from gnuradio4_tpu_torch.core import feeder as tfeeder
from gnuradio4_tpu_torch.core.errors import GrError
from gnuradio4_tpu_torch.core.host_call import host_call
from gnuradio4_tpu_torch.core.merge import MergedBlock

torch.set_num_threads(2)

SEED = 20261018
ATOL = 1e-5
PKGS = {"jax": gr, "port": gt}
RINGS = {"jax": (JRing, jfeeder.read_exact), "port": (tfeeder.HostRing,
                                                      tfeeder.read_exact)}


def _sched(pkg, g, **kw):
    if pkg is gt:
        kw["device"] = "cpu"
    return pkg.Scheduler(g, **kw)


def _chain(pkg, data, *blocks, block_len=128, source_kw=None):
    """VectorSource(data) → blocks… → VectorSink; the sink's data."""
    g = pkg.Graph()
    src = pkg.global_registry.create("VectorSource", data=data, **(source_kw or {}))
    snk = pkg.global_registry.create("VectorSink")
    g.connect_chain(src, *blocks, snk)
    _sched(pkg, g, block_len=block_len).run_and_wait()
    return np.asarray(snk.data())


def _both(run):
    """``run(pkg)`` in both packages; (port result, JAX result)."""
    return run(gt), run(gr)


# -- merge (TestMerge) ------------------------------------------------------

def test_merged_equals_chain():
    data = np.arange(256, dtype=np.float32)

    def run(pkg):
        reg = pkg.global_registry
        fused = pkg.merge(reg.create("MultiplyConst", value=2.0),
                          reg.create("AddConst", value=1.0),
                          reg.create("Decimator", decim=2))
        return _chain(pkg, data, fused)
    got, want = _both(run)
    np.testing.assert_array_equal(got, (data * 2.0 + 1.0)[::2])
    np.testing.assert_array_equal(got, want)


def test_merged_ratio():
    from fractions import Fraction
    fused = gt.merge(gt.global_registry.create("MultiplyConst"),
                     gt.global_registry.create("Decimator", decim=4))
    assert fused.ratio == Fraction(1, 4)
    assert isinstance(fused, MergedBlock)


@pytest.mark.parametrize("members", [
    [("Decimator", {"decim": 3}), ("Decimator", {"decim": 2})],
    [("MultiplyConst", {"value": 2.0}), ("Decimator", {"decim": 4})],
    [("FirFilter", {"taps": [0.25, 0.5, 0.25], "decim": 2}),
     ("Decimator", {"decim": 3})]])
def test_merged_alignment_and_ratio_match_jax(members):
    def make(pkg):
        return pkg.merge(*[pkg.global_registry.create(t, **kw)
                           for t, kw in members])
    t, j = make(gt), make(gr)
    assert (t.ratio, t.alignment) == (j.ratio, j.alignment)
    assert t.name == "+".join(b.name for b in t.members)
    assert len(t.members) == len(j.members) == len(members)


def test_merged_channels_and_dtypes_match_jax(rng):
    """A two-channel complex stream through a merged Abs → MultiplyConst:
    the merged block resolves channels and dtype from its members, and the
    member contexts carry each member's own lengths and params."""
    x = (rng.standard_normal((2, 512)) + 1j * rng.standard_normal((2, 512))
         ).astype(np.complex64)

    def run(pkg):
        reg = pkg.global_registry
        fused = pkg.merge(reg.create("Abs"), reg.create("MultiplyConst", value=0.5),
                          reg.create("Decimator", decim=2))
        assert fused.out_channels("out", {"in": 2}) == 2
        assert np.dtype(fused.out_dtype("out", {"in": np.complex64})) == np.float32
        return _chain(pkg, x, fused, block_len=256)
    got, want = _both(run)
    assert got.shape == want.shape == (2, 256) and got.dtype == np.float32
    # |z| is hypot in torch and in XLA, which round an ulp apart
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)


def test_merge_refuses_what_it_cannot_chain():
    reg = gt.global_registry
    with pytest.raises(GrError, match="at least one"):
        gt.merge()
    with pytest.raises(GrError, match="exactly one input"):
        gt.merge(reg.create("MultiplyConst"), reg.create("Add"))


# -- LambdaBlock / HostBlock (TestUserBlocks) ------------------------------

def test_lambda_block():
    data = np.arange(64, dtype=np.float32)
    got = _chain(gt, data, LambdaBlock(lambda x: torch.square(x)), block_len=64)
    want = _chain(gr, data, gr.blocks.python_block.LambdaBlock(
        lambda x: jnp.square(x)), block_len=64)
    np.testing.assert_array_equal(got, np.arange(64.0) ** 2)
    np.testing.assert_array_equal(got, want)


def test_lambda_block_takes_ctx_and_several_inputs():
    a = np.arange(32, dtype=np.float32)
    b = np.ones(32, np.float32)
    g = gt.Graph()
    lb = LambdaBlock(lambda x, y, ctx: x + y * ctx.in_len["in0"], n_inputs=2)
    snk = gt.global_registry.create("VectorSink")
    g.connect(gt.global_registry.create("VectorSource", data=a), lb["in0"])
    g.connect(gt.global_registry.create("VectorSource", data=b), lb["in1"])
    g.connect(lb, snk)
    _sched(gt, g, block_len=32).run_and_wait()
    np.testing.assert_array_equal(snk.data(), a + 32.0)


def test_host_block_callback():
    calls = {"jax": [], "port": []}

    def host_fn(who):
        def fn(x):
            calls[who].append(x.shape)
            return np.cumsum(x).astype(np.float32)
        return fn
    data = np.ones(128, np.float32)
    got = _chain(gt, data, HostBlock(host_fn("port")))
    want = _chain(gr, data, gr.blocks.python_block.HostBlock(host_fn("jax")))
    np.testing.assert_array_equal(got, np.arange(1, 129, dtype=np.float32))
    np.testing.assert_array_equal(got, want)
    # ran on the host once a step, as pure_callback does (the second step is
    # the source's end of stream)
    assert calls["port"] == calls["jax"] == [(128,), (128,)]


@pytest.mark.parametrize("form", ["namespace", "numpy", "meta_tensor"])
def test_host_block_out_shape_fn_declares_the_result(form):
    """A HostBlock that quantises to int16 carries its dtype and shape."""
    data = np.linspace(-2, 2, 256).astype(np.float32)

    def shape_fn(x):
        if form == "namespace":
            return types.SimpleNamespace(shape=x.shape, dtype=np.int16)
        if form == "numpy":
            return np.empty(tuple(x.shape), "int16")
        return torch.empty(x.shape, dtype=torch.int16, device="meta")
    hb = HostBlock(lambda x: np.round(x * 1000).astype(np.int16),
                   out_shape_fn=shape_fn)
    got = _chain(gt, data, hb)
    assert got.dtype == np.int16 and got.shape == (256,)
    np.testing.assert_array_equal(got, np.round(data * 1000).astype(np.int16))


def test_host_block_refuses_an_undeclared_result():
    data = np.ones(64, np.float32)
    with pytest.raises(GrError, match="dtype"):
        _chain(gt, data, HostBlock(lambda x: x.astype(np.float64)), block_len=64)
    with pytest.raises(GrError, match="shape"):
        _chain(gt, data, HostBlock(lambda x: x[:10]), block_len=64)


def test_host_call_declares_and_defaults():
    x = torch.arange(6, dtype=torch.float32)
    y = host_call(lambda a: a.astype(np.uint8), x)      # RS/polar: float32
    assert y.dtype == torch.float32 and y.shape == (6,)
    y = host_call(lambda a: a.reshape(2, 3).astype(np.int16), x, (2, 3), torch.int16)
    assert y.dtype == torch.int16 and tuple(y.shape) == (2, 3)
    with pytest.raises(GrError, match="declared int32"):
        host_call(lambda a: a, x, (6,), "int32")
    with pytest.raises(GrError, match="declared"):
        host_call(lambda a: a, x, (3,), np.float32)


def test_device_resident_source_runs_its_end_of_stream_step():
    """A device-resident VectorSource ends with a step of no valid sample; its
    window then clamps to the last block (the JAX package's dynamic_slice)
    instead of handing the next block an empty tensor."""
    x = np.exp(1j * 0.3 * np.arange(2 * 4096)).astype(np.complex64)

    def run(pkg):
        reg = pkg.global_registry
        return _chain(pkg, x, reg.create("FreqXlatingFir", taps=[0.5, 0.5],
                                         center_freq=1.0, sample_rate_in=10.0),
                      reg.create("QuadratureDemod"), block_len=4096,
                      source_kw={"device_resident": True})
    got, want = _both(run)
    assert got.shape == want.shape == (2 * 4096,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -- PythonBlock -------------------------------------------------------------

CLIP = {"port_jax": "def process(x):\n    return torch.clamp(x, -1.0, 1.0) * 0.5",
        "jax_jax": "def process(x):\n    return jnp.clip(x, -1.0, 1.0) * 0.5",
        "host": "def process(x):\n    return np.clip(x, -1.0, 1.0) * 0.5"}


@pytest.mark.parametrize("mode", ["jax", "host"])
def test_python_block_matches_jax(mode):
    data = np.linspace(-3, 3, 256).astype(np.float32)
    key = "host" if mode == "host" else None

    def run(pkg):
        code = CLIP[key or ("port_jax" if pkg is gt else "jax_jax")]
        pb = pkg.global_registry.create("PythonBlock", code=code, mode=mode)
        return _chain(pkg, data, pb)
    got, want = _both(run)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, np.clip(data, -1, 1) * 0.5)
    np.testing.assert_array_equal(got, want)


def test_python_block_host_mode_casts_to_the_input_dtype():
    data = np.arange(64, dtype=np.int16)
    pb = PythonBlock(code="def process(x):\n    return x * 1.5", mode="host")
    got = _chain(gt, data, pb, block_len=64)
    want = _chain(gr, data, gr.global_registry.create(
        "PythonBlock", code="def process(x):\n    return x * 1.5", mode="host"),
        block_len=64)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_python_block_two_arg_form():
    data = np.arange(64, dtype=np.float32)
    pb = PythonBlock(code="def process(ins, ctx):\n"
                          "    return {'out': ins['in'] + ctx.in_len['in']}")
    np.testing.assert_array_equal(_chain(gt, data, pb, block_len=64), data + 64)
    with pytest.raises(GrError, match="single-arg"):
        _chain(gt, data, PythonBlock(code=pb.settings.get("code"), mode="host"),
               block_len=64)


@pytest.mark.parametrize("code, name", [
    ("def process(x):\n    return jnp.abs(x)", "jnp"),
    ("import jax\ndef process(x):\n    return x", "jax"),
    ("from jax import numpy\ndef process(x):\n    return x", "jax"),
    ("def process(x):\n    return jax.nn.relu(x)", "jax")])
def test_python_block_code_naming_jax_says_what_to_use(code, name):
    with pytest.raises(GrError, match=f"uses '{name}'.*torch"):
        PythonBlock(code=code)


def test_python_block_needs_process():
    with pytest.raises(GrError, match="process"):
        PythonBlock(code="x = 1")


# -- StreamSource (TestStreamSource) ----------------------------------------

def _pushed(pkg, data, block_len, chunk=7919, **settings):
    g = pkg.Graph()
    src = g.emplace("StreamSource", **settings)
    snk = g.emplace("VectorSink")
    g.connect(src, snk)

    def producer():
        pos = 0
        while pos < len(data):
            n = min(chunk, len(data) - pos)   # chunks misaligned to blocks
            src.push(data[pos:pos + n])
            pos += n
        src.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    _sched(pkg, g, block_len=block_len, sample_rate=1e6).run_and_wait()
    t.join(10)
    return np.asarray(snk.data())


def test_threaded_push_exact_roundtrip():
    data = np.arange(100_003, dtype=np.float32)
    got, want = _both(lambda pkg: _pushed(pkg, data, 4096))
    assert len(got) >= len(data)
    np.testing.assert_array_equal(got[: len(data)], data)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wait", ["spin", "yield", "sleep", "block"])
def test_wait_strategies_deliver_the_same_stream(wait):
    data = np.random.default_rng(SEED).standard_normal(20_000).astype(np.float32)
    got = _pushed(gt, data, 2048, chunk=3001, wait=wait, capacity=8192)
    np.testing.assert_array_equal(got[: len(data)], data)


def test_complex_dtype_and_push_after_close():
    c = (np.linspace(0, 1, 8192) + 1j * np.linspace(1, 0, 8192)).astype(np.complex64)

    def run(pkg):
        g = pkg.Graph()
        src = g.emplace("StreamSource", dtype="complex64")
        snk = g.emplace("VectorSink")
        g.connect(src, snk)
        src.push(c)
        src.close()
        _sched(pkg, g, block_len=2048, sample_rate=1e6).run_and_wait()
        with pytest.raises(Exception, match="after close"):
            src.push(np.zeros(4, np.complex64))
        return np.asarray(snk.data())[: len(c)]
    got, want = _both(run)
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, c)
    np.testing.assert_array_equal(got, want)


def test_stream_source_capacity_below_block_len_raises():
    g = gt.Graph()
    src = g.emplace("StreamSource", capacity=1024)
    g.connect(src, g.emplace("NullSink"))
    src.close()
    with pytest.raises(GrError, match="capacity"):
        _sched(gt, g, block_len=2048).run_and_wait()


def test_stream_source_starves_after_its_timeout():
    g = gt.Graph()
    src = g.emplace("StreamSource", timeout=0.2)
    g.connect(src, g.emplace("NullSink"))
    src.push(np.ones(100, np.float32))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="starved"):
        _sched(gt, g, block_len=256).run_and_wait()
    assert time.monotonic() - t0 < 5.0
    src.close()


def test_push_from_many_threads_keeps_every_sample():
    """Concurrent producers take turns: nothing is lost or torn."""
    g = gt.Graph()
    src = g.emplace("StreamSource", dtype="int32", capacity=4096)
    snk = g.emplace("VectorSink")
    g.connect(src, snk)
    parts = [np.arange(k * 10_000, (k + 1) * 10_000, dtype=np.int32) for k in range(4)]

    def producer(p):
        for i in range(0, len(p), 500):
            src.push(p[i:i + 500])
    ts = [threading.Thread(target=producer, args=(p,), daemon=True) for p in parts]
    for t in ts:
        t.start()
    closer = threading.Thread(target=lambda: ([t.join(10) for t in ts], src.close()),
                              daemon=True)
    closer.start()
    _sched(gt, g, block_len=1000).run_and_wait()
    closer.join(10)
    np.testing.assert_array_equal(np.sort(snk.data()[:40_000]), np.arange(40_000))
    for p in parts:   # each producer's own samples stay in order
        got = snk.data()[np.isin(snk.data(), p)]
        np.testing.assert_array_equal(got, p)


# -- the host ring (TestBlockingWait) ---------------------------------------

@pytest.mark.parametrize("pkg", list(RINGS))
def test_futex_wait_woken_by_producer(pkg):
    Ring, read_exact = RINGS[pkg]
    r = Ring(1 << 12, dtype=np.float32)
    rd = r.add_reader()
    data = np.random.default_rng(SEED).standard_normal(100).astype(np.float32)

    def prod():
        time.sleep(0.1)
        r.write(data)

    t = threading.Thread(target=prod)
    t.start()
    got = read_exact(r, rd, 100, wait="block", timeout=5.0)
    t.join()
    np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("pkg", list(RINGS))
def test_wait_timeout_and_eos(pkg):
    Ring, _ = RINGS[pkg]
    r = Ring(1 << 10, dtype=np.float32)
    rd = r.add_reader()
    assert r.wait_readable(rd, 10, timeout=0.05) == -1
    r.write(np.ones(4, np.float32))
    r.set_eos()
    assert r.wait_readable(rd, 10, timeout=1.0) == 0
    assert r.wait_readable(rd, 4, timeout=1.0) == 1


@pytest.mark.parametrize("pkg", list(RINGS))
def test_wait_writable_woken_by_release(pkg):
    Ring, _ = RINGS[pkg]
    r = Ring(1 << 10, dtype=np.float32)
    rd = r.add_reader()
    assert r.write(np.zeros(r.capacity + 5, np.float32), block=False) == r.capacity
    assert r.writable() == 0
    assert r.wait_writable(64, timeout=0.05) == -1

    def consume():
        time.sleep(0.1)
        r.release(rd, 64)

    t = threading.Thread(target=consume)
    t.start()
    assert r.wait_writable(64, timeout=5.0) == 1
    t.join()
    assert r.writable() == 64


@pytest.mark.parametrize("pkg", list(RINGS))
def test_blocked_writer_completes(pkg):
    Ring, read_exact = RINGS[pkg]
    r = Ring(256, dtype=np.float32)
    rd = r.add_reader()
    data = np.arange(1024, dtype=np.float32)
    seen = []

    def drain():
        n = 0
        while n < len(data):
            chunk = read_exact(r, rd, min(128, len(data) - n), wait="block",
                               timeout=5.0)
            seen.append(chunk)
            n += len(chunk)

    t = threading.Thread(target=drain)
    t.start()
    wrote = r.write(data, block=True, timeout=5.0)
    t.join()
    assert wrote == len(data)
    np.testing.assert_array_equal(np.concatenate(seen), data)


@pytest.mark.parametrize("pkg", list(RINGS))
@pytest.mark.parametrize("wait", ["spin", "yield", "sleep", "block"])
def test_read_exact_wait_strategies(pkg, wait):
    Ring, read_exact = RINGS[pkg]
    r = Ring(64, dtype=np.float32)
    rd = r.add_reader()
    r.write(np.arange(40, dtype=np.float32))
    np.testing.assert_array_equal(read_exact(r, rd, 30, wait=wait, timeout=1.0),
                                  np.arange(30, dtype=np.float32))
    r.set_eos()
    np.testing.assert_array_equal(read_exact(r, rd, 30, wait=wait, timeout=1.0),
                                  np.arange(30, 40, dtype=np.float32))
    assert read_exact(r, rd, 30, wait=wait, timeout=1.0) is None


@pytest.mark.parametrize("force_python", [False, True])
def test_ring_read_across_the_wrap_is_two_slices(monkeypatch, force_python):
    """A read that wraps the end of the buffer returns the items in order
    without an index array (an old read built one of ``n`` int64 items): the
    native ring's double mapping makes it one span, the Python ring's read
    joins two slices. ``read_exact`` hands out a copy that outlives the
    release: the ring's own view is overwritten by the next write."""
    r = tfeeder.HostRing(16, dtype=np.complex64, force_python=force_python)
    assert r.is_native == (not force_python)
    rd = r.add_reader()
    cap = r.capacity
    x = (np.arange(cap + 24) * (1 + 1j)).astype(np.complex64)
    r.write(x[:cap - 4])
    r.release(rd, cap - 4)
    monkeypatch.setattr(np, "arange", None)      # no index arrays from here
    r.write(x[cap - 4:cap + 8])                  # 4 items, then 8 wrapped
    np.testing.assert_array_equal(r.read(rd, 12), x[cap - 4:cap + 8])
    got = tfeeder.read_exact(r, rd, 12)
    r.write(np.zeros(cap, np.complex64))         # the released span reused
    np.testing.assert_array_equal(got, x[cap - 4:cap + 8])
    assert r.dtype == np.complex64


def test_ring_write_is_a_copy():
    r = tfeeder.HostRing(8, dtype=np.float32)
    rd = r.add_reader()
    x = np.arange(4, dtype=np.float32)
    r.write(x)
    x[:] = -1
    np.testing.assert_array_equal(r.read(rd), np.arange(4, dtype=np.float32))


def test_ring_write_stops_at_eos_and_on_timeout():
    r = tfeeder.HostRing(8, dtype=np.float32)     # capacity rounds up to a page
    r.add_reader()
    t0 = time.monotonic()
    assert r.write(np.ones(r.capacity + 4, np.float32), block=True,
                   timeout=0.1) == r.capacity
    assert time.monotonic() - t0 < 2.0
    r.set_eos()
    assert r.write(np.ones(4, np.float32)) == 0


# -- StreamSource-fed receivers (tests/test_fm_receiver.py:101-160) ---------

def _ssb(pkg, iq, sideband, fs=48000.0):
    g = pkg.Graph()
    src = g.emplace("StreamSource", dtype="complex64")
    dem = g.emplace("SsbDemod", sideband=sideband, bandwidth=2700.0,
                    sample_rate_in=fs)
    snk = g.emplace("VectorSink")
    g.connect_chain(src, dem, snk)
    src.push(iq)
    src.close()
    _sched(pkg, g, block_len=8192, sample_rate=fs).run_and_wait()
    return np.asarray(snk.data())


def _peak(y, fs=48000.0):
    seg = y[8192:8192 + 16384] * np.hanning(16384)
    S = np.abs(np.fft.rfft(seg))
    f = np.fft.rfftfreq(16384, 1 / fs)
    return f[np.argmax(S)], S.max()


def test_usb_lsb_recover_audio_and_reject_opposite():
    fs, n = 48000.0, 65536
    t = np.arange(n) / fs
    usb = np.exp(2j * np.pi * 1000.0 * t).astype(np.complex64)
    lsb = np.exp(-2j * np.pi * 1000.0 * t).astype(np.complex64)
    outs = {}
    for key, iq, side in (("u", usb, "usb"), ("l", lsb, "lsb"), ("x", lsb, "usb")):
        got, want = _both(lambda pkg: _ssb(pkg, iq, side))
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale)
        outs[key] = _peak(got)
    (pk_u, a_u), (pk_l, _), (_, a_x) = outs["u"], outs["l"], outs["x"]
    assert abs(pk_u - 1000) < 5 and abs(pk_l - 1000) < 5
    assert 20 * np.log10(a_u / (a_x + 1e-12)) > 45   # sideband rejection


def test_stereo_separation():
    FS = 240000.0
    n = 262144
    t = np.arange(n) / FS
    L = np.sin(2 * np.pi * 1000.0 * t)
    R = np.sin(2 * np.pi * 2500.0 * t)
    th = 2 * np.pi * 19000.0 * t
    mpx = (0.45 * (L + R) + 0.1 * np.sin(th) +
           0.45 * (L - R) * np.sin(2 * th)).astype(np.float32)

    def run(pkg):
        g = pkg.Graph()
        src = g.emplace("StreamSource", dtype="float32")
        dec = g.emplace("FmStereoDecoder", sample_rate_in=FS)
        kl = g.emplace("VectorSink")
        kr = g.emplace("VectorSink")
        g.connect(src, dec)
        g.connect(dec["left"], kl["in"])
        g.connect(dec["right"], kr["in"])
        src.push(mpx)
        src.close()
        _sched(pkg, g, block_len=16384, sample_rate=FS).run_and_wait()
        return np.asarray(kl.data()), np.asarray(kr.data())
    (yl, yr), (wl, wr) = _both(run)
    for got, want in ((yl, wl), (yr, wr)):
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale)

    def tone(y, f0):
        seg = y[32768:32768 + 65536] * np.hanning(65536)
        S = np.abs(np.fft.rfft(seg))
        f = np.fft.rfftfreq(65536, 1 / FS)
        return S[np.argmin(np.abs(f - f0))]

    sep_l = 20 * np.log10(tone(yl, 1000) / (tone(yl, 2500) + 1e-12))
    sep_r = 20 * np.log10(tone(yr, 2500) / (tone(yr, 1000) + 1e-12))
    assert sep_l > 40 and sep_r > 40, (sep_l, sep_r)
