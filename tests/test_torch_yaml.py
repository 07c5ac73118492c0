"""The port's YAML, held against the JAX package (whose YAML is PyYAML):
``yaml_pmt.load`` on every case of ``tests/test_yaml_pmt_golden.py`` (equal
results and dtypes; equal error messages with their line:column), ``dump``'s
text, every ``examples/*.yaml`` read to the same document, ``save_grc`` of the
headline chain, the WBFM graph and suite config 1 written to the same
document, ``load_grc`` of the examples, the ``GraphGRC`` message, a
``load(dump(x)) == x`` round trip over random typed maps, and the port running
with PyYAML made unimportable. Everything here is exact: no tolerance."""

import string
import subprocess
import sys
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings, strategies as st

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt
from gnuradio4_tpu.core import yaml_pmt as jy
from gnuradio4_tpu.core.errors import GrError as JGrError
from gnuradio4_tpu_torch.core import yaml_pmt as py
from gnuradio4_tpu_torch.core.errors import GrError

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("*.yaml"))
# the examples whose every block type the port registers: all of them
PORTED_EXAMPLES = ("agc_loop", "ais_receiver", "ble_scanner", "channelizer",
                   "coded_link", "fm_receiver", "lora_link", "rds_receiver",
                   "rtty_teletype", "spectrum_analyzer", "wifi_link")

# every document tests/test_yaml_pmt_golden.py loads
GOLDEN = {
    "tagged_integers": """
hex: !!int64 0xFF
oct: !!int64 0o77
bin: !!int64 0b1010
positive: !!int64 42
negative: !!int64 -42
uint8: !!uint8 255
uint16: !!uint16 65535
uint32: !!uint32 4294967295
int8: !!int8 -128
int16: !!int16 -32768
int32: !!int32 -2147483648
""",
    "untagged_integers": "a: 42\nb: 0xFF\nc: 0o77\nd: 0b1010",
    "doubles_and_specials": """
normal: !!float64 123.456
scientific: !!float64 1.23e-4
infinity: !!float64 .inf
infinity2: !!float64 .Inf
neg_infinity: !!float64 -.INF
not_a_number: !!float64 .nan
not_a_number2: !!float64 .NAN
untagged: 123.456
untagged_inf: .inf
untagged_nan: .NaN
""",
    "float_error": "value: !!float64 string",
    "int_error_hex": "value: !!int64 0xGG",
    "int_error_range": "value: !!int8 128",
    "complex_forms": """
c1: !!complex64 (1.0, -1.0)
c2: !!complex32 (1.0, -1.0)
c3: !!complex64 (1.0,-1.0)
c4: !!complex32 (  1.0  ,   -1.0)
""",
    "complex_error_1": "c: !!complex64 (1.01.0)",
    "complex_error_2": "c: !!complex64 Hello",
    "complex_error_3": "c: !!complex64 (1.0, -1.0, 2.0)",
    "complex_error_4": "c: !!complex64 (foo, bar)",
    "complex_error_5": "c: !!complex64 (1.0, bar)",
    "bools": "t: !!bool true\nf: !!bool false\nut: true\nuf: False\nut3: TRUE",
    "bool_error_1": "b: !!bool 1",
    "bool_error_2": "b: !!bool TrUe",
    "bool_error_3": "b: !!bool FaLsE",
    "nulls": """
null_value: !!null null
null_value2: null
null_value3: !!null ~
null_value4: ~
null_value5: !!null anything
null_value6: Null
null_value7: NULL
null_value8:
not_null: NuLl
""",
    "typed_vectors": """
floatVector: !!float32
  - 1.0
  - 2.0
  - 3.0
doubleVector: !!float64 [1, 2, 3]
boolVector: !!bool
  - true
  - false
  - true
complexVector: !!complex64
  - (1.0, -1.0)
  - (2.0, -2.0)
  - (3.0, -3.0)
stringVector: !!str
  - "Hello"
  - "World"
""",
    "pmt_vectors_and_nesting": """
mixedPmtVector:
  - !!bool true
  - !!float64 42
  - !!str "Hello"
untaggedBools:
  - true
  - false
nullVector: !!null
  - null
  - null
emptyVector: !!str []
emptyPmtVector: []
nestedVector:
  - !!str
    - 1
    - 2
  -
    - 3
    - 4
vectorWithColons:
  - "key: value"
  - "key2: value2"
""",
    "vector_error_items": "key: !!int64 [foo, bar]",
    "vector_error_both_tags": "key: !!str [foo, !!float64 1.0]",
    "grc_document": """
blocks:
  - name: ArraySink<double>
    id: gr::testing::ArraySink<double>
    parameters:
      name: ArraySink<double>
connections:
  - [ArraySource<double>, [0, 0], ArraySink<double>, [1, 1]]
""",
    "tagged_grc_parameters": """
name: typed
blocks:
  - name: src
    id: SignalGenerator
    parameters:
      frequency: !!float32 1000.0
      n_samples: !!int32 4096
  - name: snk
    id: VectorSink
connections:
  - [src, out, snk, in]
""",
    "comments_and_whitespace": """
# leading comment

key: 1   # trailing comment
# comment between

key2: 2

""",
    "quoted_octal_1": 'a: "0o77"',
    "quoted_octal_2": "a: !!str 0o77",
    "quoted_octal_3": "a: 0o77",
    # YAML 1.1 corners the reader follows PyYAML's SafeLoader on
    "yaml11_exponent_without_dot": "a: 48.0e3\nb: 1e5\nc: 1.0e+5\nd: 0755\ne: 1_000",
    "yaml11_strict_bool": "a: yes",
    "yaml11_sexagesimal": "a: 1:30\nb: -1:30.5",
    "quoting_and_folding": "a: 'it''s'\nb: \"x\\ty\\u00e9\"\nc: \"multi\n  line\"\nd: 'x\n\n  y'",
    "indentless_and_flow": "a:\n- 1\n- {x: 1, y}\nb: [a, [b, c]]\n",
    "empty_tagged": "k: !!int64\n",
    "typed_nested_vector": "a: !!int8 [[1, 2], [3, 4]]",
    "document_markers": "---\na: 1\n...\n",
}
ROUNDTRIP_MAP = {
    "answer": 42,
    "question": "universe",
    "nested": {"answer": np.int16(7), "flag": True},
    "samples": np.asarray([1, 2, 3], np.uint8),
    "taps": np.asarray([0.5, 0.25], np.float32),
    "iq": np.complex64(1 - 2j),
    "names": ["John", "Smith"],
    "nothing": None,
    "octal_string": "0o77",
    "vectors": [np.asarray([1.5, -2.0]), {"k": np.uint32(7)}, []],
    "empty": {},
}


def _same(a, b) -> bool:
    """Equal values of the same types (NumPy dtypes included)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"))
    if isinstance(a, (float, np.floating)) and a != a:
        return b != b
    return a == b


def _load_both(text):
    out = []
    for mod, err in ((jy, JGrError), (py, GrError)):
        try:
            out.append(("ok", mod.load(text)))
        except err as e:
            out.append(("error", e.args[0]))
    return out


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_cases_load_alike(case):
    (kj, vj), (kp, vp) = _load_both(GOLDEN[case])
    assert kj == kp, (vj, vp)
    if kj == "ok":
        assert _same(vj, vp), (vj, vp)
    else:
        assert vj == vp      # the same message, with the same line:column


@pytest.mark.parametrize("text, where", [
    ("a: &x 1", "1:4"), ("a: *x", "1:4"), ("a: |\n  x", "1:4"),
    ("? a\n: b", "1:1"), ("a: [b: 1]", "1:6"), ("a: !foo 1", "1:4"),
    ("a: 1\n---\nb: 2", "2:1"), ("a: b: c", "1:5"), ("a: [1, 2", "1:9"),
    ("x:\n  y: 1\n   z: 2", "3:4"), ("a: value\n  more", "2:3"),
    ("a:\n\t- 1", "2:1"), ("%YAML 1.1\n---\na: 1", "1:1"),
    ("a: 2001-12-14", "1:4"),
])
def test_reader_refuses_what_it_does_not_cover(text, where):
    """Outside the dialect the reader raises with the position; it never
    guesses (PyYAML reads some of these, e.g. anchors and block scalars)."""
    with pytest.raises(GrError, match=f"YAML parse error at {where}:"):
        py.load(text)


def test_dump_writes_the_same_text():
    text = py.dump(ROUNDTRIP_MAP)
    assert text == jy.dump(ROUNDTRIP_MAP)
    assert _same(py.load(text), jy.load(text))
    assert py.dump(py.load(text)) == text


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_examples_read_to_the_same_document(path):
    text = path.read_text()
    doc = py.load(text)
    assert _same(doc, jy.load(text))
    assert doc == yaml.safe_load(text)


def _chain(pkg):
    fd = import_module(pkg.__name__ + ".ops.filter_design")
    g = pkg.Graph(name="chain")
    reg = pkg.global_registry
    src = reg.create("ComplexToneSource", frequency=1e6, name="src")
    taps = fd.design_fir("lowpass", 127, sample_rate=20e6, f_low=2e6)
    fir = reg.create("FreqXlatingFir", taps=taps.astype(np.float32),
                     center_freq=3e6, sample_rate_in=20e6, decim=1, name="fir")
    fft = reg.create("FFT", fft_size=4096, window="Hann", output="magnitude",
                     calibrate=False, name="fft")
    dem = reg.create("QuadratureDemod", gain=1.0, name="demod")
    audio = reg.create("FirFilter", taps=fd.design_fir(
        "lowpass", 63, sample_rate=20e6, f_low=1e6).astype(np.float32),
        decim=8, name="audio_fir")
    s1 = reg.create("VectorSink", name="spec")
    s2 = reg.create("VectorSink", name="audio")
    g.connect_chain(src, fir, fft, s1)
    g.connect(fir, dem)
    g.connect_chain(dem, audio, s2)
    return g


def _wbfm(pkg):
    g = pkg.Graph(name="wbfm_path")
    reg = pkg.global_registry
    src = reg.create("ComplexToneSource", frequency=10e3, name="src")
    rx = reg.create("WbfmReceiver", quad_rate=250e3, audio_decim=5, name="rx")
    snk = reg.create("VectorSink", name="audio")
    g.add(rx)
    g.connect(src, rx["in"])
    g.connect(rx["out"], snk)
    return g


def _config1(pkg):
    fd = import_module(pkg.__name__ + ".ops.filter_design")
    g = pkg.Graph(name="config1")
    src = g.emplace("ComplexToneSource", frequency=1e6, name="src")
    fir = g.emplace("FirFilter", name="fir", taps=fd.design_fir(
        "lowpass", 127, sample_rate=20e6, f_low=2e6).astype(np.float32))
    fft = g.emplace("FFT", fft_size=4096, window="Hann", output="magnitude",
                    calibrate=False, name="fft")
    snk = g.emplace("VectorSink", name="snk")
    g.connect_chain(src, fir, fft, snk)
    return g


@pytest.mark.parametrize("build", [_chain, _wbfm, _config1],
                         ids=["chain", "wbfm", "config1"])
def test_save_grc_writes_the_same_document(build):
    kw = dict(sample_rate=20e6, block_len=1 << 16)
    text_j = gr.save_grc(build(gr), **kw)
    text_p = gt.save_grc(build(gt), **kw)
    doc = yaml.safe_load(text_p)
    assert doc == yaml.safe_load(text_j)
    assert py.load(text_p) == doc and py.load(text_j) == doc
    # and it loads back to the same graph in the port
    again = gt.save_grc(gt.load_grc(text_p), **kw)
    assert yaml.safe_load(again) == doc


# settings the port's block has beyond the JAX package's, with the value
# every example leaves them at
PORT_SETTINGS = {"PFBChannelizer": {"oversample_rate": 1}}


def _graph_summary(g, drop=None):
    flat = g.flatten()
    blocks = [(b.name, type(b).registry_name,
               {k: np.asarray(b.settings.get(k)).tolist() for k in b.settings.keys()
                if k not in (drop or {}).get(type(b).registry_name, ())})
              for b in flat.blocks]
    edges = [(e.src.name, e.src_port, e.dst.name, e.dst_port) for e in flat.edges]
    return g.name, getattr(g, "yaml_meta", {}), blocks, edges


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_load_grc_of_the_examples(path):
    assert path.stem in PORTED_EXAMPLES
    text = path.read_text()
    port = gt.load_grc(text)
    for b in port.flatten().blocks:
        for k, v in PORT_SETTINGS.get(type(b).registry_name, {}).items():
            assert b.settings.get(k) == v, (b.name, k)
    assert _graph_summary(port, PORT_SETTINGS) == _graph_summary(gr.load_grc(text))


@pytest.mark.parametrize("stem", ["lora_link", "rtty_teletype"])
def test_load_grc_of_an_unregistered_type_raises(stem):
    """An example with one block's id changed to a type that neither package
    registers: both refuse it with the registry's message naming the type."""
    text = (ROOT / "examples" / f"{stem}.yaml").read_text()
    doc = jy.load(text)
    first = doc["blocks"][0]["id"]
    text = text.replace(f"id: {first}", "id: NoSuchReceiver", 1)
    assert not gt.global_registry.contains("NoSuchReceiver")
    with pytest.raises(GrError, match="unknown block type 'NoSuchReceiver'"):
        gt.load_grc(text)
    with pytest.raises(JGrError, match="unknown block type 'NoSuchReceiver'"):
        gr.load_grc(text)


def test_feedback_edge_loads_and_compiling_it_raises():
    text = (ROOT / "examples" / "agc_loop.yaml").read_text()
    text = text.replace("ExpressionDISO", "Add").replace(
        '{expression: "clip(y + 0.01*(1.0 - abs(x)), 1e-6, 65536.0)"}',
        "{n_inputs: 2}").replace("loopfilter, x]", "loopfilter, in0]").replace(
        "loopfilter, y,", "loopfilter, in1,")
    g = gt.load_grc(text)
    assert sum(e.feedback for e in g.edges) == 2
    # compiling it no longer raises: the loop is one group with delay 1
    # (tests/test_torch_feedback.py runs the flow itself)
    c = gt.compile_graph(g, block_len=4096, device="cpu")
    assert [grp["delay"] for grp in c.loop_groups] == [1]
    assert sorted(m.name for m in c.loop_groups[0]["order"]) \
        == ["loopfilter", "vga"]


def _ask(sched, command, data=None):
    rid = sched.bus.send_command(command, "", gt.Property.GRAPH_GRC, data)
    sched._process_messages()
    return next(r for r in sched.bus.drain_replies()
                if r.client_request_id == rid)


def test_graph_grc_get_and_set():
    g = _chain(gt)
    s = gt.Scheduler(g, block_len=1 << 12, sample_rate=20e6, device="cpu")
    s.init()
    s.fsm.transition_to(gt.State.RUNNING)
    s._pump_once()
    s._drain()
    reply = _ask(s, gt.Command.Get)
    doc = yaml.safe_load(reply.data["grc"])
    assert [b["name"] for b in doc["blocks"]] == [b.name for b in g.blocks]
    assert gt.load_grc(reply.data["grc"]).name == "chain"
    assert _ask(s, gt.Command.Set, {"grc": gt.save_grc(_config1(gt))}
                ).data == {"blocks": 4}
    s._pump_once()
    s._drain()
    snk = next(b for b in s.graph.blocks if b.name == "snk")
    assert snk.data().shape == (1 << 12,) and s.graph.name == "config1"


def test_registry_plugin_loader(tmp_path):
    plugin = tmp_path / "my_port_plugin.py"
    plugin.write_text(
        "import gnuradio4_tpu_torch as gt\n"
        "from gnuradio4_tpu_torch.blocks.math import MultiplyConst\n"
        "def gr_register(registry):\n"
        "    registry.add('TripleConst', lambda **kw: MultiplyConst(value=3.0, **kw))\n")
    reg = gt.BlockRegistry()
    loader = gt.PluginLoader(reg)
    loader.load(str(plugin))
    assert reg.contains("TripleConst") and not reg.contains("Nope")
    assert reg.create("TripleConst").settings.get("value") == 3.0
    with pytest.raises(GrError, match="unknown block type 'Nope'"):
        reg.get("Nope")
    with pytest.raises(GrError, match="failed to load plugin"):
        loader.load("no_such_plugin_module_xyz")


# what ``dump`` writes faithfully (it is the reference's writer: floats whose
# repr has a bare exponent, and strings YAML 1.1 reads as bools or that start
# with an indicator, do not survive it in either package)
_TEXT = st.text(alphabet=string.ascii_letters + string.digits + " _-./\\'\"#:",
                max_size=12).filter(
    lambda s: s.lower() not in ("yes", "no", "on", "off")
    and (s[:1] not in "?,[]{}&*!|>%@`" or s == ""))
_FLOATS = st.floats(-1e6, 1e6).filter(lambda f: "e" not in repr(f))
_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-2**62, 2**62), _FLOATS, _TEXT,
    st.sampled_from([np.int8, np.uint16, np.int32, np.uint64, np.float32,
                     np.int64, np.float64])
    .flatmap(lambda t: st.integers(0, 100).map(t)),
    st.builds(lambda re, im: np.complex64(complex(re, im)),
              st.floats(-1e3, 1e3, width=32), st.floats(-1e3, 1e3, width=32)))
_ARRAYS = st.sampled_from([np.uint8, np.int16, np.int64, np.float32,
                           np.float64, np.complex64, np.uint32]).flatmap(
    lambda t: st.lists(st.integers(0, 100), min_size=1, max_size=5)
    .map(lambda v: np.asarray(v).astype(t)))
_KEYS = st.from_regex(r"[a-z][a-z0-9_]{0,8}", fullmatch=True)
_MAPS = st.recursive(
    st.dictionaries(_KEYS, st.one_of(_SCALARS, _ARRAYS), max_size=5),
    lambda inner: st.dictionaries(_KEYS, st.one_of(_SCALARS, _ARRAYS, inner),
                                  max_size=4),
    max_leaves=12)


def _normalize(v):
    """What load(dump(v)) gives back: float64 values (untagged, the
    reference's inference type) as Python floats and lists."""
    if isinstance(v, dict):
        return {k: _normalize(x) for k, x in v.items()}
    if isinstance(v, np.ndarray) and v.dtype == np.float64:
        return v.tolist()
    if isinstance(v, np.float64):
        return v.item()
    return v


@settings(max_examples=150, deadline=None)
@given(_MAPS)
def test_load_of_dump_round_trips(m):
    text = py.dump(m)
    back = py.load(text)
    assert _same(back, _normalize(m)), (text, back)
    assert _same(back, jy.load(text))


def test_port_runs_without_pyyaml():
    """With PyYAML unimportable the port's YAML, CLI and checkpoint modules
    import, neither JAX nor the JAX package is loaded, and every example whose
    blocks are ported loads."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import gnuradio4_tpu_torch as gt\n"
        "import gnuradio4_tpu_torch.__main__, gnuradio4_tpu_torch.core.yaml_io\n"
        "import gnuradio4_tpu_torch.core.yaml_pmt, gnuradio4_tpu_torch.core.checkpoint\n"
        "import gnuradio4_tpu_torch.core.datasink\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gnuradio4_tpu' or m.startswith('gnuradio4_tpu.')\n"
        "       or (m == 'yaml' and sys.modules[m] is not None)]\n"
        "assert not bad, bad\n"
        f"for stem in {PORTED_EXAMPLES!r}:\n"
        f"    g = gt.load_grc(open({str(ROOT)!r} + '/examples/' + stem + '.yaml').read())\n"
        "    assert g.blocks\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_imports_neither_jax_nor_yaml():
    """A fresh interpreter that imports the port's YAML, checkpoint, sink and
    CLI modules has loaded neither JAX, PyYAML nor the JAX package."""
    code = (
        "import sys\n"
        "import gnuradio4_tpu_torch, gnuradio4_tpu_torch.__main__\n"
        "import gnuradio4_tpu_torch.core.yaml_io, gnuradio4_tpu_torch.core.yaml_pmt\n"
        "import gnuradio4_tpu_torch.core.checkpoint, gnuradio4_tpu_torch.core.datasink\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'yaml', 'gnuradio4_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_coded_link_runs_in_the_port_as_in_the_jax_package():
    """examples/coded_link.yaml (PRBS → LDPC(256, 128) → BPSK → ChannelModel
    at σ 0.42, ~0.86% raw BER → Real → LLRs → decoder) through ``run_grc``
    on the CPU: every one of the 8192 bits decoded (the reference's own
    check, tests/test_examples.py), and the received bits equal the JAX
    package's."""
    text = (ROOT / "examples" / "coded_link.yaml").read_text()
    out = {}
    for pkg, kw in ((gr, {}), (gt, {"scheduler_kwargs": {"device": "cpu"}})):
        blocks = {b.name: b for b in pkg.run_grc(text, **kw).graph.blocks}
        out[pkg] = (np.asarray(blocks["tx_bits"].data()),
                    np.asarray(blocks["rx_bits"].data()))
    (txj, rxj), (txt, rxt) = out[gr], out[gt]
    assert txt.shape == rxt.shape == (8192,)
    np.testing.assert_array_equal(rxt, txt)
    np.testing.assert_array_equal(txt, txj)
    np.testing.assert_array_equal(rxt, rxj)
