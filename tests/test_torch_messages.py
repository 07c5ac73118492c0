"""The port's message plane against the JAX package's, on the CPU: the same
requests sent to both schedulers get the same replies (per-block property
endpoints, Set/Get settings, staged settings, contexts, lifecycle get/set and
notifications), block-to-block message edges drive settings identically, and
runtime graph mutation by message gives the same sinks."""

import numpy as np
import yaml
import pytest
import torch

import gnuradio4_tpu as gr
import gnuradio4_tpu_torch as gt

torch.set_num_threads(2)


def _make(pkg, n=4096, sink="NullSink"):
    g = pkg.Graph()
    src = g.emplace("CountingSource", n_samples=n)
    mul = g.emplace("MultiplyConst", value=2.0, name="gain")
    snk = g.emplace(sink)
    g.connect_chain(src, mul, snk)
    kw = {"device": "cpu"} if pkg is gt else {}
    s = pkg.Scheduler(g, block_len=1024, **kw)
    s.init()
    return s, mul, snk


def _ask(pkg, sched, command, service, endpoint, data=None):
    rid = sched.bus.send_command(getattr(pkg.Command, command), service,
                                 endpoint, data)
    sched._process_messages()
    for r in sched.bus.drain_replies():
        if r.client_request_id == rid:
            return r
    raise AssertionError("no reply")


def _norm(reply):
    """A reply's comparable content: command, endpoint and data (errors by
    kind only — their text names package-specific source locations)."""
    if reply.is_error:
        return (reply.command.value, reply.endpoint, "error")
    # heartbeats carry the time; unique names each package's instance count
    data = {k: v for k, v in reply.data.items()
            if k not in ("heartbeat", "unique_name")}
    if reply.endpoint == "MetaInformation":
        # setting descriptions may differ (the port names what it lacks)
        data["settings"] = sorted(data["settings"])
    return (reply.command.value, reply.endpoint, data)


def _same_replies(script, service="gain"):
    """Run ``script`` — [(command, endpoint, data), ...] — against both
    schedulers; every reply must match."""
    out = []
    for pkg in (gr, gt):
        s, mul, _ = _make(pkg)
        out.append([_norm(_ask(pkg, s, c, service, ep, d)) for c, ep, d in script])
    assert out[0] == out[1]
    return out[1]


@pytest.mark.parametrize("service", ["gain", "no_such_block", ""])
def test_heartbeat_echo_and_unknown_endpoints(service):
    script = [("Get", "Heartbeat", None),
              ("Get", "Echo", {"custom kv": 42, "nested": {"a": 1}}),
              ("Get", "NoSuchEndpoint", None)]
    got = _same_replies(script, service)
    if service == "gain":
        assert got[1][2] == {"custom kv": 42, "nested": {"a": 1}}
        assert got[2][2] == "error"
    if service == "no_such_block":
        assert all(r[2] == "error" for r in got)


def test_heartbeat_by_unique_name():
    for pkg in (gr, gt):
        s, mul, _ = _make(pkg)
        r = _ask(pkg, s, "Get", mul.unique_name, "Heartbeat")
        assert not r.is_error and "heartbeat" in r.data


def test_settings_get_set_and_unknown_key():
    got = _same_replies([("Get", "Setting", None),
                         ("Set", "Setting", {"value": 4.0}),
                         ("Set", "Setting", {"nope": 1}),
                         ("Get", "StagedSetting", None),
                         ("Set", "StagedSetting", {"value": 5.0}),
                         ("Get", "MetaInformation", None),
                         ("Get", "InspectBlock", None),
                         ("Set", "StoreDefaults", None),
                         ("Set", "ResetDefaults", None),
                         ("Get", "LifecycleState", None),
                         ("Subscribe", "Setting", None)])
    assert got[0][2]["value"] == 2.0 and got[2][2] == "error"
    assert got[4][2] == {"value": 5.0}


def test_staged_settings_apply_at_the_step_boundary():
    out = []
    for pkg in (gr, gt):
        s, mul, _ = _make(pkg)
        _ask(pkg, s, "Set", "gain", "StagedSetting", {"value": 5.0})
        assert mul.settings.get("value") == 2.0
        s.run_and_wait()
        out.append((mul.settings.get("value"),
                    _ask(pkg, s, "Get", "gain", "StagedSetting").data))
    assert out[0] == out[1] == (5.0, {})


def test_context_lifecycle():
    script = [("Get", "SettingsContexts", None),
              ("Get", "ActiveContext", None),
              ("Set", "ActiveContext", {"context": "test_context"}),
              ("Set", "SettingsContexts", {"context": "new_context",
                                           "properties": {"value": 9.0}}),
              ("Set", "ActiveContext", {"context": "new_context"}),
              ("Get", "SettingsContexts", None),
              ("Disconnect", "SettingsContexts", {"context": "new_context"}),
              ("Disconnect", "SettingsContexts", {"context": "new_context"}),
              ("Set", "ActiveContext", {"context": ""})]
    got = _same_replies(script)
    assert got[4][2]["context"] == "new_context" and got[7][2] == "error"
    s, mul, _ = _make(gt)
    for c, ep, d in script[:5]:
        _ask(gt, s, c, "gain", ep, d)
    s._apply_staged_settings()
    assert mul.settings.get("value") == 9.0


def test_scheduler_lifecycle_get_and_invalid_set():
    got = _same_replies([("Get", "LifecycleState", None),
                         ("Set", "LifecycleState", {"state": "PAUSED"}),
                         ("Set", "LifecycleState", {"state": "NOT_A_STATE"}),
                         ("Get", "Heartbeat", None)], service="")
    assert got[0][2] == {"state": "INITIALISED"}
    assert got[1][2] == got[2][2] == "error"


def test_lifecycle_and_setting_notifications():
    out = []
    for pkg in (gr, gt):
        s, mul, _ = _make(pkg)
        states, settings = [], []
        s.bus.subscribe(pkg.Property.LIFECYCLE_STATE,
                        lambda m: states.append(m.data.get("state")))
        s.bus.subscribe(pkg.Property.SETTING, lambda m: settings.append(
            (m.command.value, m.service_name, m.data)))
        s.bus.send_command(pkg.Command.Set, "gain", pkg.Property.SETTING,
                           {"value": 7.0})
        s.run_and_wait()
        out.append((states, settings, mul.settings.get("value")))
    assert out[0] == out[1]
    states, settings, value = out[1]
    assert states == ["RUNNING", "REQUESTED_STOP", "STOPPED"] and value == 7.0
    assert ("Notify", "gain", {"value": 7.0}) in settings


def test_inspect_graph_and_registry_types():
    out = []
    for pkg in (gr, gt):
        s, _, _ = _make(pkg)
        g = _ask(pkg, s, "Get", "", "InspectGraph").data
        types = _ask(pkg, s, "Get", "", "RegistryBlockTypes").data["types"]
        out.append(([(b["name"], b["type"]) for b in g["blocks"]],
                    [(e["src_port"], e["dst_port"], e["samples_per_step"])
                     for e in g["edges"]], types))
    assert [t for _, t in out[0][0]] == [t for _, t in out[1][0]]
    assert out[0][1] == out[1][1]
    assert out[1][2] == sorted(out[1][2]) and set(out[1][2]) <= set(out[0][2])
    for t in ("MultiplyConst", "NoiseSource", "PFBChannelizer", "TagSink"):
        assert t in out[1][2]


def test_graph_grc_is_refused_until_yaml_is_ported():
    # the YAML graph format is ported: Get answers with the running graph
    # as GRC YAML, the same document the JAX package answers with
    docs = []
    for pkg in (gr, gt):
        s, _, _ = _make(pkg)
        r = _ask(pkg, s, "Get", "", "GraphGRC")
        assert not r.is_error
        doc = yaml.safe_load(r.data["grc"])
        # block names carry each package's instance counter: compare the rest
        docs.append([(b["id"], {k: v for k, v in (b.get("parameters") or {}).items()
                                if k != "name"}) for b in doc["blocks"]])
    assert docs[0] == docs[1]


def test_runtime_emplace_and_edge_messages():
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("CountingSource", n_samples=100_000)
        snk = g.emplace("VectorSink", name="cap")
        g.connect(src, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        s = pkg.Scheduler(g, block_len=512, **kw)
        s.init()
        s.bus.send_command(pkg.Command.Set, "", pkg.Property.REMOVE_EDGE,
                           {"src": src.name, "dst": snk.name})
        s.bus.send_command(pkg.Command.Set, "", pkg.Property.EMPLACE_BLOCK,
                           {"type": "MultiplyConst", "properties": {"value": 2.0}})
        s._process_messages()
        mul = [b for b in g.blocks if type(b).__name__ == "MultiplyConst"][0]
        s.bus.send_command(pkg.Command.Set, "", pkg.Property.EMPLACE_EDGE,
                           {"src": src.name, "dst": mul.name})
        s.bus.send_command(pkg.Command.Set, "", pkg.Property.EMPLACE_EDGE,
                           {"src": mul.name, "dst": snk.name})
        s.run_and_wait(n_steps=4)
        out.append(snk.data())
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_array_equal(out[1][:100], 2.0 * np.arange(100))


def test_runtime_replace_and_remove_block_messages():
    out = []
    for pkg in (gr, gt):
        g = pkg.Graph()
        src = g.emplace("CountingSource", n_samples=4096)
        mul = g.emplace("MultiplyConst", value=2.0, name="gain")
        snk = g.emplace("VectorSink", name="cap")
        g.connect_chain(src, mul, snk)
        kw = {"device": "cpu"} if pkg is gt else {}
        s = pkg.Scheduler(g, block_len=512, pipeline_depth=1, **kw)
        s.init()
        s.run_and_wait(n_steps=2)
        s.bus.send_command(pkg.Command.Set, "", pkg.Property.REPLACE_BLOCK,
                           {"name": "gain", "type": "DivideConst",
                            "properties": {"value": 4.0}})
        while s._pump_once():
            pass
        s._drain()
        bad = _ask(pkg, s, "Set", "", "ReplaceBlock", {"name": "gain",
                                                        "type": "NullSink"})
        gone = _ask(pkg, s, "Set", "", "RemoveBlock", {"name": "nope"})
        out.append((snk.data(), bad.is_error, gone.is_error,
                    sorted(type(b).__name__ for b in s.graph.blocks)))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[0][1:] == out[1][1:] == (True, True, ["CountingSource",
                                                     "DivideConst", "VectorSink"])
    np.testing.assert_array_equal(out[1][0][1024:], np.arange(1024, 4096) / 4.0)


def test_block_message_edges_drive_settings():
    """A block posts a property map on its message output; the scheduler
    routes it over the message edge at the next step boundary."""
    out = []
    for pkg in (gr, gt):
        class Commander(pkg.Block):
            IN = (pkg.Port("in"),)
            OUT = (pkg.Port("out"),)

            def __init__(self, name=None, **s):
                super().__init__(name=name, **s)
                self._seen = 0

            def apply(self, state, ins, ctx):
                return state, {"out": ins["in"]}

            def emit_tags(self, ctx):   # host hook, runs every step
                self._seen += next(iter(ctx.in_len.values()), 0)
                if self._seen == 1024:
                    self.post_message({"value": 7.0})
                return []

        g = pkg.Graph()
        src = g.emplace("CountingSource", n_samples=4096)
        cmd = g.add(Commander())
        mul = g.emplace("MultiplyConst", value=1.0, name="vga")
        snk = g.emplace("VectorSink")
        g.connect_chain(src, cmd, mul, snk)
        g.connect_message(cmd, mul)
        kw = {"device": "cpu"} if pkg is gt else {}
        pkg.Scheduler(g, block_len=512, pipeline_depth=1, **kw).run_and_wait()
        out.append(snk.data())
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_array_equal(out[1][1536:], 7.0 * np.arange(1536, 4096))


def test_message_edges_survive_flatten_of_nested_graphs():
    inner = gt.Graph(name="inner")
    a = inner.emplace("Copy", name="a")
    b = inner.emplace("MultiplyConst", name="b")
    inner.connect(a, b)
    inner.connect_message(a, b)
    inner.export_in("in", a, "in")
    inner.export_out("out", b, "out")
    g = gt.Graph()
    g.add(inner)
    g.connect(g.emplace("CountingSource"), inner["in"])
    g.connect(inner["out"], g.emplace("NullSink"))
    assert g.flatten().message_edges == [(a, b)]
    g.remove(inner)
    assert g.message_edges == [] and inner not in g.blocks
