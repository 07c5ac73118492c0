"""The port's network transports against the JAX package's, on the CPU: every
case of ``tests/test_io_blocks.py``'s ``TestHttp``, ``TestTcpBlocks`` and
``TestUdpBlocks`` and of ``tests/test_zeromq.py`` in the port, the HTTP cases
through both packages against one local server, and links whose two ends
are the two packages (a JAX ``TcpSink`` feeding a port ``TcpSource`` and the
reverse, a JAX ``ZmqPushSink`` feeding a port ``ZmqPullSource``).

Every socket here takes a port the OS picks (none of the JAX tests' fixed
ports, so both suites can run at once) and every wait is bounded. The
ZeroMQ cases need pyzmq and skip without it, as the JAX package's do.

Tolerances: TCP and ZeroMQ links are bitwise (raw little-endian samples);
UDP keeps order and at least 3/4 of 80 000 samples over loopback (its loss
is the protocol's, as in the JAX test); HTTP payloads exact.
"""

import http.server
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)

PKGS = {"jax": gr, "port": gt}
WAIT_S = 120.0


def _free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kw(pkg, **kw):
    if pkg is gt:
        kw["device"] = "cpu"
    return kw


def _sched(pkg, g, **kw):
    return pkg.Scheduler(g, **_kw(pkg, **kw))


def _reg(pkg, name, **kw):
    return pkg.global_registry.create(name, **kw)


class _Threaded:
    """A scheduler run on a thread, joined with a bound."""

    def __init__(self, sched):
        self.sched = sched
        self.error = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        try:
            self.sched.run_and_wait()
        except Exception as e:       # re-raised by join()
            self.error = e

    def join(self, timeout=WAIT_S):
        self.t.join(timeout)
        if self.t.is_alive():
            self.sched.request_stop()
            self.t.join(30)
            raise AssertionError("scheduler thread did not finish")
        if self.error is not None:
            raise self.error


# -- HTTP (TestHttp) -----------------------------------------------------------

class _Handler(http.server.BaseHTTPRequestHandler):
    posted: list[bytes] = []
    serve_data = np.arange(64, dtype=np.float32).tobytes()

    def do_GET(self):
        if self.path.startswith("/missing"):
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.end_headers()
        self.wfile.write(self.serve_data)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        type(self).posted.append(self.rfile.read(n))
        self.send_response(204)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture()
def http_server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    _Handler.posted.clear()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    t.join(10)


@pytest.mark.parametrize("parse", ["bytes", "json", "text"])
def test_http_source_streams_payload(http_server, parse, monkeypatch):
    body = {"bytes": _Handler.serve_data,
            "json": json.dumps({"data": list(range(64))}).encode(),
            "text": " ".join(str(i) for i in range(64)).encode()}[parse]
    monkeypatch.setattr(_Handler, "serve_data", body)
    outs = []
    for pkg in (gt, gr):
        g = pkg.Graph()
        src = _reg(pkg, "HttpSource", url=http_server, parse=parse,
                   dtype="float32", max_requests=4, period_s=0.0)
        snk = _reg(pkg, "VectorSink")
        g.connect(src, snk)
        _sched(pkg, g, block_len=64).run_and_wait()
        outs.append(np.asarray(snk.data()))
    assert outs[0].shape == (256,)         # 4 requests × 64
    np.testing.assert_array_equal(outs[0][:64], np.arange(64, dtype=np.float32))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("parse", ["json", "bytes"])
def test_http_sink_posts_blocks(http_server, parse):
    posts = {}
    for pkg in (gt, gr):
        _Handler.posted.clear()
        g = pkg.Graph()
        snk = _reg(pkg, "HttpSink", url=http_server, parse=parse)
        g.connect(_reg(pkg, "VectorSource", data=np.arange(128, dtype=np.float32)),
                  snk)
        _sched(pkg, g, block_len=64).run_and_wait()
        assert snk.n_posted == 128 and len(_Handler.posted) == 2 and not snk.errors
        posts[pkg] = list(_Handler.posted)
    assert posts[gt] == posts[gr]
    if parse == "json":
        assert json.loads(posts[gt][0])["data"][:3] == [0.0, 1.0, 2.0]
    else:
        np.testing.assert_array_equal(np.frombuffer(posts[gt][1], np.float32),
                                      np.arange(64, 128, dtype=np.float32))


def test_http_error_fails_the_run(http_server):
    g = gt.Graph()
    g.connect(_reg(gt, "HttpSource", url=http_server + "/missing", max_requests=1),
              _reg(gt, "NullSink"))
    with pytest.raises(Exception, match="404|Not Found"):
        _sched(gt, g, block_len=64).run_and_wait()


# -- TCP (TestTcpBlocks) -------------------------------------------------------

def test_tcp_two_graph_link_exact():
    port = _free_port()
    rt = gt.Runtime()
    tx = gt.Graph()
    tx.connect(tx.emplace("CountingSource", n_samples=100_000),
               tx.emplace("TcpSink", port=port, listen=True))
    rx = gt.Graph()
    r_snk = rx.emplace("VectorSink")
    rx.connect(rx.emplace("TcpSource", port=port, listen=False, dtype="float32",
                          n_samples=100_000), r_snk)
    rt.add(tx, **_kw(gt, block_len=8192, sample_rate=1e6))
    rt.add(rx, **_kw(gt, block_len=4096, sample_rate=1e6))
    rt.run_all(timeout=WAIT_S)
    np.testing.assert_array_equal(np.asarray(r_snk.data())[:100_000],
                                  np.arange(100_000, dtype=np.float32))


def test_tcp_reversed_roles_complex():
    port = _free_port()
    rt = gt.Runtime()
    tx = gt.Graph()
    tx.connect(tx.emplace("ComplexToneSource", frequency=1000.0, n_samples=50_000),
               tx.emplace("TcpSink", port=port, listen=False))
    rx = gt.Graph()
    r_snk = rx.emplace("VectorSink")
    rx.connect(rx.emplace("TcpSource", port=port, listen=True, dtype="complex64",
                          n_samples=50_000), r_snk)
    rt.add(tx, **_kw(gt, block_len=4096, sample_rate=48000.0))
    rt.add(rx, **_kw(gt, block_len=4096, sample_rate=48000.0))
    rt.run_all(timeout=WAIT_S)
    y = np.asarray(r_snk.data())[:50_000]
    assert y.dtype == np.complex64
    np.testing.assert_allclose(np.mean(np.abs(y) ** 2), 1.0, atol=1e-3)


def test_tcp_dead_peer_raises():
    g = gt.Graph()
    g.connect(g.emplace("TcpSource", port=_free_port(), listen=False,
                        connect_timeout=1.5), g.emplace("NullSink"))
    with pytest.raises(Exception, match="refused|Connection"):
        _sched(gt, g, block_len=1024, sample_rate=1e6).run_and_wait()


@pytest.mark.parametrize("sender", ["jax", "port"])
def test_tcp_link_across_packages(sender):
    """One package's TcpSink (listening) feeds the other's TcpSource: the
    samples arrive bitwise."""
    port = _free_port()
    tx_pkg = PKGS[sender]
    rx_pkg = gr if tx_pkg is gt else gt
    rng = np.random.default_rng(7)
    data = (rng.standard_normal(30_011) + 1j * rng.standard_normal(30_011)
            ).astype(np.complex64)
    tx = tx_pkg.Graph()
    tx.connect(_reg(tx_pkg, "VectorSource", data=data),
               tx.emplace("TcpSink", port=port, listen=True))
    tx_sched = _sched(tx_pkg, tx, block_len=4096, sample_rate=1e6)
    tx_sched.init()
    t = _Threaded(tx_sched)
    rx = rx_pkg.Graph()
    snk = _reg(rx_pkg, "VectorSink")
    rx.connect(rx.emplace("TcpSource", port=port, listen=False, dtype="complex64",
                          n_samples=len(data)), snk)
    _sched(rx_pkg, rx, block_len=2048, sample_rate=1e6).run_and_wait()
    t.join()
    np.testing.assert_array_equal(np.asarray(snk.data())[:len(data)], data)


def test_tcp_source_step_longer_than_a_million_items():
    """A step of 2^21 items: the source's ring holds two steps (a ring of
    2^20 items, as the JAX package's, could never hold one)."""
    port, n = _free_port(), 1 << 21
    rt = gt.Runtime()
    tx = gt.Graph()
    tx.connect(tx.emplace("CountingSource", n_samples=2 * n),
               tx.emplace("TcpSink", port=port, listen=True))
    rx = gt.Graph()
    r_snk = rx.emplace("CountingSink")
    src = rx.emplace("TcpSource", port=port, listen=False, n_samples=2 * n)
    rx.connect(src, r_snk)
    rt.add(tx, **_kw(gt, block_len=1 << 16, sample_rate=1e6))
    rt.add(rx, **_kw(gt, block_len=n, sample_rate=1e6))
    rt.run_all(timeout=WAIT_S)
    assert r_snk.count == 2 * n
    assert src._feeder.ring.capacity >= 2 * n and src._feeder.ring.is_native


# -- UDP (TestUdpBlocks) --------------------------------------------------------

def test_udp_loopback_link():
    port = _free_port(socket.SOCK_DGRAM)
    rt = gt.Runtime()
    rx = gt.Graph()
    r_snk = rx.emplace("VectorSink")
    rx.connect(rx.emplace("UdpSource", port=port, dtype="float32",
                          n_samples=80_000, idle_timeout=20.0), r_snk)
    tx = gt.Graph()
    tx.connect(tx.emplace("CountingSource", n_samples=80_000),
               tx.emplace("UdpSink", port=port, payload_items=1000))
    rt.add(rx, **_kw(gt, block_len=4096, sample_rate=1e6))
    rt.add(tx, **_kw(gt, block_len=8192, sample_rate=1e6))
    rt.run_all(timeout=WAIT_S)
    y = np.asarray(r_snk.data())
    assert len(y) >= 60_000
    assert np.all(np.diff(y) > 0)           # in order
    assert np.isin(y, np.arange(80_000, dtype=np.float32)).all()


def test_udp_idle_timeout_ends_stream():
    g = gt.Graph()
    g.connect(g.emplace("UdpSource", port=_free_port(socket.SOCK_DGRAM),
                        idle_timeout=1.0), g.emplace("NullSink"))
    t0 = time.monotonic()
    _sched(gt, g, block_len=1024, sample_rate=1e6).run_and_wait()
    assert time.monotonic() - t0 < 35


# -- ZeroMQ (tests/test_zeromq.py) ---------------------------------------------

@pytest.fixture
def zmq_addr():
    pytest.importorskip("zmq")
    return f"tcp://127.0.0.1:{_free_port()}"


def _start_rx(pkg, graph, src_block, block_len=4096):
    """Run the receive graph on a thread and wait until its socket is open
    (sources connect lazily on the first pump)."""
    t = _Threaded(_sched(pkg, graph, block_len=block_len, sample_rate=1e6))
    deadline = time.monotonic() + 60.0
    while src_block._sock is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert src_block._sock is not None, "rx socket never opened"
    time.sleep(0.3)            # let the TCP/SUB handshake settle
    return t


def _zmq_pipe(tx_pkg, rx_pkg, addr, data, tx_block=4096, rx_block=4096):
    gtx = tx_pkg.Graph()
    gtx.connect(_reg(tx_pkg, "VectorSource", data=data),
                gtx.emplace("ZmqPushSink", address=addr, bind=True))
    grx = rx_pkg.Graph()
    pull = grx.emplace("ZmqPullSource", address=addr, bind=False,
                       dtype=str(data.dtype), n_samples=len(data))
    v = _reg(rx_pkg, "VectorSink")
    grx.connect(pull, v)
    t = _start_rx(rx_pkg, grx, pull, rx_block)
    try:
        _sched(tx_pkg, gtx, block_len=tx_block, sample_rate=1e6).run_and_wait()
    finally:
        t.join()
    return np.asarray(v.data())[:len(data)]


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_zmq_pipe_exact(zmq_addr, dtype):
    data = (np.arange(20000) * (1 + 1j if dtype == "complex64" else 1)).astype(dtype)
    np.testing.assert_array_equal(_zmq_pipe(gt, gt, zmq_addr, data), data)


def test_zmq_odd_message_sizes_carry(zmq_addr):
    data = np.arange(9999, dtype=np.float32)
    np.testing.assert_array_equal(
        _zmq_pipe(gt, gt, zmq_addr, data, tx_block=777, rx_block=1024), data)


def test_zmq_jax_push_to_port_pull(zmq_addr):
    data = np.arange(12345, dtype=np.float32) * np.float32(0.5)
    np.testing.assert_array_equal(_zmq_pipe(gr, gt, zmq_addr, data), data)


def test_zmq_fanout_two_subscribers(zmq_addr):
    data = np.arange(16384, dtype=np.float32)
    gtx = gt.Graph()
    pub = gtx.emplace("ZmqPubSink", address=zmq_addr, bind=True)
    gtx.connect(_reg(gt, "VectorSource", data=data), pub)
    pub.start()          # bind first: the subscribers join a live endpoint
    rigs = []
    for _ in range(2):
        g = gt.Graph()
        src = g.emplace("ZmqSubSource", address=zmq_addr, bind=False,
                        n_samples=len(data))
        v = _reg(gt, "VectorSink")
        g.connect(src, v)
        rigs.append((g, src, v))
    started = [_start_rx(gt, g, src) for g, src, _ in rigs]
    try:
        _sched(gt, gtx, block_len=2048, sample_rate=1e6).run_and_wait()
    finally:
        for t in started:
            t.join()
    for _, _, v in rigs:
        np.testing.assert_array_equal(np.asarray(v.data())[:len(data)], data)

