"""The port's native host layer against the JAX package's, on the CPU: the
double-mapped ring (``native/ring.py``), the wire-format converters
(``native/convert.py``), the threaded feeder and ``read_exact`` on the ring,
the file source's wire formats, the ring stress harness under
ThreadSanitizer, and the names the port re-exports as the JAX package does.

Every case of ``tests/test_native_and_fileio.py``'s ring, feeder, converter
and multi-producer classes runs in the port, each ring case with
``force_python`` in {False, True}. Tolerances: the converters are bitwise
equal between the two packages' libraries and between the port's library and
its NumPy fallback; ring contents, capacities and counts exact.
"""

import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core import feeder as jfeeder
from gnuradio4_tpu.native import convert as jconvert
from gnuradio4_tpu.native.ring import HostRing as JRing
from gnuradio4_tpu_torch.core import feeder as tfeeder
from gnuradio4_tpu_torch.native import build as tbuild
from gnuradio4_tpu_torch.native import convert as tconvert
from gnuradio4_tpu_torch.native import ring as tring
from gnuradio4_tpu_torch.native.ring import HostRing

torch.set_num_threads(2)

SEED = 20261018
PORT_NATIVE = Path(tring.__file__).parent
BOTH = pytest.mark.parametrize("force_python", [False, True],
                               ids=["native", "python"])


def _sched(pkg, g, **kw):
    if pkg is gt:
        kw["device"] = "cpu"
    return pkg.Scheduler(g, **kw)


# -- build ------------------------------------------------------------------

def test_native_builds_into_the_port_build_dir():
    assert tring.build_native() and tring.native_available()
    assert tconvert.build_native() and tconvert.native_available()
    for stem, srcs, flags in (("gr4ring", tring._SOURCES, tring._FLAGS),
                              ("gr4convert", tconvert._SOURCES, tconvert._FLAGS)):
        so = tbuild.library_path(stem, srcs, flags)
        assert so.is_file() and so.parent == tbuild.BUILD_DIR
        assert so.parent.parent.name == "gnuradio4_tpu_torch"


def test_loaded_libraries_are_the_ports_own():
    """The port maps its own builds from ``_build/`` and never the JAX
    package's prebuilt libraries (checked in a fresh process)."""
    code = ("import numpy as np; from pathlib import Path; "
            "from gnuradio4_tpu_torch.native import ring, convert; "
            "r = ring.HostRing(8); convert.u8_to_f32(np.zeros(4, np.uint8)); "
            "maps = [l for l in Path('/proc/self/maps').read_text().splitlines() "
            "if 'libgr4' in l]; "
            "assert r.is_native and convert.native_available(); "
            "assert len({l.split()[-1] for l in maps}) == 2, maps; "
            "assert all('gnuradio4_tpu_torch/_build/' in l for l in maps), maps")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    """The library's name is keyed by its sources: an edited source builds
    a new file (dlopen caches by path, so the old name would serve stale
    code)."""
    src = tmp_path / "x.cpp"
    src.write_text('extern "C" int gr4_x() { return 1; }\n')
    monkeypatch.setattr(tbuild, "HERE", tmp_path)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "_build")
    a = tbuild.build_library("x", ("x.cpp",), (("-O1",),))
    src.write_text('extern "C" int gr4_x() { return 2; }\n')
    b = tbuild.build_library("x", ("x.cpp",), (("-O1",),))
    if a is None:
        pytest.skip("no g++")
    assert a != b and a.is_file() and b.is_file()
    assert tbuild.build_library("x", ("x.cpp",), (("--no-such-flag",),)) is None


def test_build_key_follows_the_host_under_march_native(tmp_path, monkeypatch):
    """A ``-march=native`` build is keyed by the host's CPU too: a build
    directory carried to another machine is not loaded there. Flag sets
    without it keep one name on every host."""
    (tmp_path / "x.cpp").write_text('extern "C" int gr4_x() { return 1; }\n')
    monkeypatch.setattr(tbuild, "HERE", tmp_path)
    native, plain = (("-O3", "-march=native"), ("-O3",)), (("-O3",),)
    here = (tbuild.library_path("x", ("x.cpp",), native),
            tbuild.library_path("x", ("x.cpp",), plain))
    assert "flags" in tbuild.host_cpu() or sys.platform != "linux"
    monkeypatch.setattr(tbuild, "host_cpu", lambda: "another machine")
    there = (tbuild.library_path("x", ("x.cpp",), native),
             tbuild.library_path("x", ("x.cpp",), plain))
    assert here[0] != there[0] and here[1] == there[1]


# -- the ring (TestNativeRing) ------------------------------------------------

@BOTH
def test_spsc_roundtrip(force_python):
    ring = HostRing(1024, np.float32, force_python=force_python)
    assert ring.is_native == (not force_python)
    r = ring.add_reader()
    data = np.arange(500, dtype=np.float32)
    assert ring.write(data) == 500
    np.testing.assert_array_equal(np.array(ring.read(r, 500)), data)
    ring.release(r, 500)
    assert ring.readable(r) == 0


@pytest.mark.parametrize("items,dtype", [(1, np.float32), (1000, np.float32),
                                         (1025, np.float32), (256, np.complex64),
                                         (1 << 20, np.complex64), (3, np.int16)])
def test_capacity_matches_the_jax_ring(items, dtype):
    """The native ring rounds up to a power of two of whole pages, in both
    packages alike; the Python ring to a power of two of items."""
    for fp in (False, True):
        assert (HostRing(items, dtype, force_python=fp).capacity
                == JRing(items, dtype, force_python=fp).capacity)


def test_wraparound_contiguity():
    """The double mmap gives contiguous views across the wrap point."""
    ring = HostRing(1024, np.float32)
    assert ring.is_native
    r = ring.add_reader()
    cap = ring.capacity
    ring.write(np.zeros(cap - 7, np.float32))
    ring.release(r, len(ring.read(r)))
    data = np.arange(20, dtype=np.float32)
    span = ring.reserve(20)
    assert len(span) == 20          # contiguous despite crossing the wrap
    span[:] = data
    ring.publish(20)
    got = ring.read(r, 20)
    assert len(got) == 20
    np.testing.assert_array_equal(np.array(got), data)


@BOTH
def test_backpressure_stops_the_producer(force_python):
    ring = HostRing(256, np.float32, force_python=force_python)
    r = ring.add_reader()
    n = ring.capacity * 2
    big = np.arange(n, dtype=np.float32)
    wrote = ring.write(big, block=False)
    assert wrote == ring.capacity
    ring.release(r, len(ring.read(r)))
    assert ring.write(big[wrote:], block=False) == n - ring.capacity


@BOTH
def test_threaded_producer_consumer_integrity(force_python):
    ring = HostRing(1 << 12, np.int32, force_python=force_python)
    r = ring.add_reader()
    total = 200_000

    def produce():
        ring.write(np.arange(total, dtype=np.int32), block=True, timeout=30)
        ring.set_eos()
    t = threading.Thread(target=produce, daemon=True)
    t.start()
    got = []
    while (chunk := tfeeder.read_exact(ring, r, 4096, timeout=30)) is not None:
        got.append(chunk)
    t.join(10)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.arange(total, dtype=np.int32))


@BOTH
def test_two_readers_independent(force_python):
    ring = HostRing(1024, np.float32, force_python=force_python)
    r1, r2 = ring.add_reader(), ring.add_reader()
    ring.write(np.arange(100, dtype=np.float32))
    a = np.array(ring.read(r1, 100))
    ring.release(r1, 100)
    b = np.array(ring.read(r2, 50))
    ring.release(r2, 50)
    np.testing.assert_array_equal(a[:50], b)
    assert ring.readable(r1) == 0 and ring.readable(r2) == 50


@BOTH
def test_at_most_eight_readers(force_python):
    ring = HostRing(1024, np.float32, force_python=force_python)
    assert [ring.add_reader() for _ in range(8)] == list(range(8))
    with pytest.raises(RuntimeError, match="max 8"):
        ring.add_reader()


@BOTH
def test_blocking_waits(force_python):
    ring = HostRing(1 << 10, np.float32, force_python=force_python)
    rd = ring.add_reader()
    assert ring.wait_readable(rd, 10, timeout=0.05) == -1
    threading.Timer(0.1, lambda: ring.write(np.ones(10, np.float32))).start()
    assert ring.wait_readable(rd, 10, timeout=5.0) == 1
    ring.write(np.zeros(ring.capacity, np.float32), block=False)
    assert ring.wait_writable(64, timeout=0.05) == -1
    threading.Timer(0.1, lambda: ring.release(rd, 64)).start()
    assert ring.wait_writable(64, timeout=5.0) == 1
    ring.set_eos()
    assert ring.wait_readable(rd, ring.capacity + 1, timeout=1.0) == 0


@BOTH
def test_write_stops_at_eos(force_python):
    ring = HostRing(1024, np.float32, force_python=force_python)
    rd = ring.add_reader()
    assert ring.write(np.ones(4, np.float32)) == 4
    ring.set_eos()
    assert ring.eos and ring.write(np.ones(4, np.float32)) == 0
    assert ring.readable(rd) == 4


# -- read_exact: the copy before the release, and EOS -------------------------

@BOTH
def test_read_exact_copies_before_release(force_python):
    """The ring's read is a view into its buffer, valid until the release;
    read_exact's result must survive the producer reusing that memory."""
    ring = HostRing(1024, np.float32, force_python=force_python)
    rd = ring.add_reader()
    cap = ring.capacity
    first = np.arange(cap, dtype=np.float32)
    ring.write(first)
    got = tfeeder.read_exact(ring, rd, cap)
    assert ring.write(-np.ones(cap, np.float32), block=False) == cap
    np.testing.assert_array_equal(got, first)


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("partial", [True, False])
def test_read_exact_allow_partial_on_eos(pkg, partial):
    """The JAX package's call form: ``allow_partial_on_eos`` is a keyword of
    both, and neither acts on it: the short tail at EOS is handed out."""
    Ring, read_exact = ((JRing, jfeeder.read_exact) if pkg == "jax"
                        else (HostRing, tfeeder.read_exact))
    ring = Ring(64, np.float32)
    rd = ring.add_reader()
    ring.write(np.arange(10, dtype=np.float32))
    ring.set_eos()
    got = read_exact(ring, rd, 16, timeout=1.0, allow_partial_on_eos=partial)
    np.testing.assert_array_equal(got, np.arange(10, dtype=np.float32))
    assert read_exact(ring, rd, 16, timeout=1.0, allow_partial_on_eos=partial) is None


def test_feeder_streams_iterator():
    chunks = [np.full(100, i, np.float32) for i in range(20)]
    f = tfeeder.ThreadedFeeder(iter(chunks), np.float32).start()
    assert f.ring.is_native
    out = []
    while (c := tfeeder.read_exact(f.ring, f.reader, 250, timeout=10)) is not None:
        out.append(c)
    np.testing.assert_array_equal(np.concatenate(out), np.concatenate(chunks))


def test_stream_source_ring_is_native_and_multi_producer():
    src = gt.global_registry.create("StreamSource", dtype="complex64")
    ring = src._ensure_ring()
    assert ring.is_native and ring.producers == "multi"


# -- multi-producer (TestMultiProducerRing) -------------------------------------

@BOTH
def test_concurrent_writers_keep_each_stream_whole(force_python):
    ring = HostRing(1 << 14, np.int64, force_python=force_python,
                    producers="multi")
    rid = ring.add_reader()
    n_prod, per = 4, 30_000

    def producer(pid):
        seq = (np.int64(pid) << 48) | np.arange(per, dtype=np.int64)
        pos = 0
        rng = np.random.default_rng(pid)
        while pos < per:
            n = int(min(rng.integers(1, 2049), per - pos))
            assert ring.write(seq[pos:pos + n], timeout=60) == n
            pos += n
    out = []

    def consumer():
        got = 0
        while got < n_prod * per:
            span = ring.read(rid, 0)
            if len(span) == 0:
                time.sleep(1e-5)
                continue
            out.append(span.copy())
            ring.release(rid, len(span))
            got += len(span)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=producer, args=(p,), daemon=True)
                   for p in range(n_prod)]
        ct = threading.Thread(target=consumer, daemon=True)
        ct.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        ct.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not ct.is_alive() and not any(t.is_alive() for t in threads)
    y = np.concatenate(out)
    assert len(y) == n_prod * per
    for p in range(n_prod):
        np.testing.assert_array_equal(y[(y >> 48) == p] & ((1 << 48) - 1),
                                      np.arange(per))


def test_invalid_producers_arg():
    with pytest.raises(ValueError, match="single.*multi|multi.*single"):
        HostRing(1024, producers="many")


@BOTH
def test_zero_copy_reserve_rejected_on_multi(force_python):
    ring = HostRing(1024, producers="multi", force_python=force_python)
    with pytest.raises(RuntimeError, match="single-producer-only"):
        ring.reserve(8)


def test_ring_stress_under_tsan(tmp_path):
    """The port's copy of the C++ stress harness (SPSC + MP ticket publish +
    racing reader registration + futex waits) runs clean under
    ThreadSanitizer."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    exe = tmp_path / "ring_stress_tsan"
    build = subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=thread", "-std=c++20",
         str(PORT_NATIVE / "ring_stress.cpp"), str(PORT_NATIVE / "ringbuf.cpp"),
         "-o", str(exe)], capture_output=True, text=True, timeout=120)
    if build.returncode != 0:
        pytest.skip(f"TSAN build unavailable: {build.stderr[:200]}")
    run = subprocess.run([str(exe)], capture_output=True, text=True, timeout=180)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "ring_stress OK" in run.stdout
    assert "WARNING: ThreadSanitizer" not in run.stderr


# -- the converters (TestNativeConvert) ----------------------------------------

def _wire(rng, kind, n=4099):
    if kind == "i16":
        return rng.integers(-32768, 32768, n, dtype=np.int16)
    if kind == "u8":
        return rng.integers(0, 256, n, dtype=np.uint8)
    return (rng.standard_normal(n) * 0.7).astype(np.float32)


CONVERSIONS = [("i16_to_f32", "i16"), ("u8_to_f32", "u8"),
               ("i16iq_to_c64", "i16"), ("u8iq_to_c64", "u8"),
               ("f32_to_i16", "f32")]


@pytest.mark.parametrize("name,kind", CONVERSIONS)
def test_convert_bitwise_against_the_jax_library(name, kind):
    assert tconvert.native_available() and jconvert.native_available()
    x = _wire(np.random.default_rng(SEED), kind)
    got, want = getattr(tconvert, name)(x), getattr(jconvert, name)(x)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kind", CONVERSIONS)
def test_convert_fallback_bitwise_against_the_library(name, kind, monkeypatch):
    x = _wire(np.random.default_rng(SEED + 1), kind)
    if kind == "f32":      # ties and both clip ends
        x = np.concatenate([x * 4, np.float32([0.5, -0.5, 2.5, -2.5]) / 32767,
                            np.float32([-0.0, 1.0, -1.0])])
    native = getattr(tconvert, name)(x)
    monkeypatch.setattr(tconvert, "_load", lambda: None)
    fallback = getattr(tconvert, name)(x)
    assert fallback.dtype == native.dtype
    np.testing.assert_array_equal(fallback, native)


def test_i16_roundtrip(rng):
    x = np.clip(rng.standard_normal(4096) * 0.3, -0.99, 0.99).astype(np.float32)
    back = tconvert.i16_to_f32(tconvert.f32_to_i16(x), scale=1.0 / 32767.0)
    np.testing.assert_allclose(back, x, atol=1.0 / 32767)


def test_u8iq_values():
    c = tconvert.u8iq_to_c64(np.array([127, 127, 255, 0, 0, 255], np.uint8))
    np.testing.assert_allclose(c[1], 1.0 - 1.0j, atol=0.01)
    np.testing.assert_allclose(c[2], -1.0 + 1.0j, atol=0.01)


@pytest.mark.parametrize("wire", ["i16", "u8", "i16iq", "u8iq"])
def test_file_source_wire_format_matches_jax(tmp_path, wire):
    """A wire-format file → FileSource in both packages, bitwise equal."""
    rng = np.random.default_rng(SEED)
    raw = (rng.integers(-8000, 8000, 2000, dtype=np.int16) if "i16" in wire
           else rng.integers(0, 256, 2000, dtype=np.uint8))
    p = tmp_path / f"capture.{wire}"
    p.write_bytes(raw.tobytes())

    def run(pkg):
        g = pkg.Graph()
        src = pkg.global_registry.create("FileSource", path=str(p),
                                         wire_format=wire)
        snk = pkg.global_registry.create("VectorSink")
        g.connect(src, snk)
        _sched(pkg, g, block_len=256).run_and_wait()
        return np.asarray(snk.data())
    got, want = run(gt), run(gr)
    assert got.dtype == want.dtype
    assert got.shape == (1000,) if "iq" in wire else (2000,)
    np.testing.assert_array_equal(got, want)


# -- every caller copies out of the ring before it releases -------------------

@pytest.fixture
def poisoned_release(monkeypatch):
    """A ring whose release overwrites the span it frees, as a producer
    reusing it would: a caller that kept the ring's view past the release
    reads the poison."""
    release = HostRing.release

    def poison(self, reader, n):
        self.read(reader, n)[:] = -7
        release(self, reader, n)
    monkeypatch.setattr(HostRing, "release", poison)


@pytest.fixture
def _port_registry_as_found():
    """core/subgraph.py registers ScheduledSubgraph on import; the registry
    is left as it was found (tests/test_torch_cli.py compares it with a fresh
    process's)."""
    before = dict(gt.global_registry._factories)
    yield
    gt.global_registry._factories.clear()
    gt.global_registry._factories.update(before)


@BOTH
def test_read_exact_result_is_not_the_released_view(poisoned_release,
                                                    force_python):
    ring = HostRing(64, np.float32, force_python=force_python)
    rd = ring.add_reader()
    ring.write(np.arange(40, dtype=np.float32))
    np.testing.assert_array_equal(tfeeder.read_exact(ring, rd, 30),
                                  np.arange(30, dtype=np.float32))


@pytest.mark.usefixtures("_port_registry_as_found")
def test_subgraph_feed_copies_before_release(poisoned_release):
    """ScheduledSubgraph's outer feed copies each take out of the bridge
    ring before it releases it: the bridged stream equals the flat run."""
    from gnuradio4_tpu_torch.core.subgraph import ScheduledSubgraph
    data = np.arange(8192, dtype=np.float32)
    inner = gt.Graph(name="inner")
    mul = inner.add(gt.global_registry.create("MultiplyConst", value=3.0))
    inner.export_in("in", mul, "in")
    inner.export_out("out", mul, "out")
    g = gt.Graph()
    snk = gt.global_registry.create("VectorSink")
    g.connect_chain(gt.global_registry.create("VectorSource", data=data),
                    ScheduledSubgraph(inner, name="sub"), snk)
    _sched(gt, g, block_len=512).run_and_wait()
    np.testing.assert_array_equal(np.asarray(snk.data()), 3.0 * data)


def test_stream_source_feed_copies_before_release(poisoned_release):
    g = gt.Graph()
    src = g.emplace("StreamSource", dtype="float32")
    snk = g.emplace("VectorSink")
    g.connect(src, snk)
    data = np.arange(10_000, dtype=np.float32)
    src.push(data)
    src.close()
    _sched(gt, g, block_len=1024).run_and_wait()
    np.testing.assert_array_equal(np.asarray(snk.data())[:len(data)], data)


# -- the JAX package's names (the name-parity repairs) -------------------------

@pytest.mark.parametrize("module,name", [
    ("ops.fft", "make_window"), ("blocks.math", "nco_phases"),
    ("blocks.math", "complex_exp_ramp"), ("core.graph", "canonical_dtype"),
    ("core.block", "StreamSpec")])
def test_reexports_the_jax_package_names(module, name):
    import importlib
    assert hasattr(importlib.import_module(f"gnuradio4_tpu.{module}"), name)
    assert hasattr(importlib.import_module(f"gnuradio4_tpu_torch.{module}"), name)


def test_phase_to_frac_takes_phase_u32():
    from gnuradio4_tpu.ops.signal import phase_to_frac as jf
    from gnuradio4_tpu_torch.ops.signal import phase_to_frac as tf
    ph = np.array([0, 1 << 31, (1 << 32) - 1], np.uint32)
    got = tf(phase_u32=torch.from_numpy(ph.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf(phase_u32=ph)))


def test_new_modules_load_no_jax():
    code = ("import sys, gnuradio4_tpu_torch, gnuradio4_tpu_torch.native.ring, "
            "gnuradio4_tpu_torch.native.convert, gnuradio4_tpu_torch.blocks.sigmf, "
            "gnuradio4_tpu_torch.blocks.uri, gnuradio4_tpu_torch.blocks.audio, "
            "gnuradio4_tpu_torch.blocks.alsa, gnuradio4_tpu_torch.blocks.network, "
            "gnuradio4_tpu_torch.blocks.http, gnuradio4_tpu_torch.blocks.zeromq, "
            "gnuradio4_tpu_torch.blocks.usb, gnuradio4_tpu_torch.blocks.rtl2832, "
            "gnuradio4_tpu_torch.blocks.soapy; "
            "assert 'jax' not in sys.modules and 'gnuradio4_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
