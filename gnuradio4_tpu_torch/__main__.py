"""CLI runner: ``python -m gnuradio4_tpu_torch <command>``.

Commands (the app surface of the framework — ≈ running a GRC flowgraph):
  run <flow.yaml> [--steps N] [--block-len N] [--sample-rate FS] [--cpu]
                  [--profile TRACE] [--draw [--draw-interval S]]
  blocks                      list registered block types
  describe <BlockType>        show a block type's settings/ports
  inspect <flow.yaml>         parse + validate + draw + print the resolved graph
  new-block <Name> [--kind device|sink|source] [--dir D]
                              scaffold a block module + its test

``run`` takes the CUDA card unless ``--cpu`` is given; without a card it
fails. ``run --draw`` redraws the graph's Drawable blocks (ImChartMonitor,
WaterfallMonitor) while the scheduler runs. ``bench`` raises: the port's
benchmark comes with a change of its own.
"""

from __future__ import annotations

import argparse
import sys

from .core.errors import GrError

_NOT_PORTED = ("is not ported to gnuradio4_tpu_torch yet (it comes with the "
               "port's benchmark)")


def _run_with_dashboard(sched, graph, n_steps, interval: float) -> None:
    """Run the scheduler in the background; refresh Drawable blocks in-place
    (ANSI alternate screen) until the graph finishes or Ctrl-C."""
    import time

    drawables = [b for b in graph.flatten().blocks if b.is_drawable]
    if not drawables:
        print("--draw: no drawable blocks in this flowgraph (add e.g. "
              "ImChartMonitor); running headless", file=sys.stderr)
        sched.run_and_wait(n_steps)
        return
    sched.start(n_steps)
    use_altscreen = sys.stdout.isatty()
    if use_altscreen:
        sys.stdout.write("\x1b[?1049h")  # alternate screen
    try:
        from .core.lifecycle import State
        while sched.state not in (State.STOPPED, State.ERROR):
            frame = []
            for b in drawables:
                out = b.draw()
                if out:
                    frame.append(f"── {b.name} " + "─" * 24)
                    frame.append(out.rstrip("\n"))
            frame.append(f"[{sched.state.value}] step {sched._step}   "
                         f"(Ctrl-C to stop)")
            if use_altscreen:
                sys.stdout.write("\x1b[H\x1b[2J" + "\n".join(frame) + "\n")
            else:
                sys.stdout.write("\n".join(frame) + "\n\n")
            sys.stdout.flush()
            time.sleep(interval)
    except KeyboardInterrupt:
        sched.request_stop()
    finally:
        if use_altscreen:
            sys.stdout.write("\x1b[?1049l")
            sys.stdout.flush()
        sched.wait_done()
        # final frame on the main screen so a fast run still shows its charts
        for b in drawables:
            out = b.draw()
            if out:
                sys.stdout.write(f"── {b.name} " + "─" * 24 + "\n"
                                 + out.rstrip("\n") + "\n")
        sys.stdout.write(f"[{sched.state.value}] step {sched._step}\n")
        sys.stdout.flush()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="gnuradio4_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run a YAML flowgraph")
    run_p.add_argument("flowgraph")
    run_p.add_argument("--steps", type=int, default=None)
    run_p.add_argument("--block-len", type=int, default=None)
    run_p.add_argument("--sample-rate", type=float, default=None)
    run_p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (default: the CUDA card)")
    run_p.add_argument("--profile", metavar="TRACE_JSON", default=None,
                       help="write a chrome://tracing profile")
    run_p.add_argument("--draw", action="store_true",
                       help="live terminal dashboard from Drawable blocks "
                            "(ImChartMonitor etc.)")
    run_p.add_argument("--draw-interval", type=float, default=0.5,
                       metavar="S", help="dashboard refresh period")

    sub.add_parser("blocks", help="list registered block types")

    desc = sub.add_parser("describe", help="show a block type's settings/ports")
    desc.add_argument("type_name")

    insp = sub.add_parser("inspect", help="validate + describe a flowgraph")
    insp.add_argument("flowgraph")
    insp.add_argument("--block-len", type=int, default=4096)

    sub.add_parser("bench", help="run the headline benchmark (not ported yet)")
    nb = sub.add_parser("new-block", help="scaffold a block module + test")
    nb.add_argument("name")
    nb.add_argument("--kind", default="device",
                    choices=("device", "sink", "source"),
                    help="device: torch apply(); sink: host consume(); "
                         "source: host_feed()")
    nb.add_argument("--dir", default=".",
                    help="where to write <snake>.py / test_<snake>.py")

    args = ap.parse_args(argv)

    if args.cmd == "bench":
        raise GrError(f"`{args.cmd}` {_NOT_PORTED}")

    if args.cmd == "new-block":
        from .utils.scaffold import new_block
        for path in new_block(args.name, kind=args.kind, out_dir=args.dir):
            print(f"wrote {path}")
        return 0

    from . import blocks  # noqa: F401  (populates the registry)
    from .core.registry import global_registry

    if args.cmd == "blocks":
        for name in global_registry.known_blocks():
            print(name)
        return 0

    if args.cmd == "describe":
        cls = global_registry.get(args.type_name)
        print(f"{args.type_name}  ({cls.__module__}.{cls.__name__})")
        doc = (cls.__doc__ or "").strip().split("\n")[0]
        if doc:
            print(f"  {doc}")
        ins = [p.name for p in getattr(cls, "IN", ())]
        outs = [p.name for p in getattr(cls, "OUT", ())]
        print(f"  inputs: {ins or '(dynamic)'}   outputs: {outs or '(dynamic)'}")
        spec = getattr(cls, "_settings_spec", {})
        if spec:
            print("  settings:")
            for k, s in sorted(spec.items()):
                extra = []
                if s.unit:
                    extra.append(f"[{s.unit}]")
                if s.limits:
                    extra.append(f"limits={s.limits}")
                if s.choices:
                    extra.append(f"choices={s.choices}")
                extra.append("static" if s.kind == "static" else "dynamic")
                print(f"    {k:22s} default={s.default!r:16} "
                      f"{' '.join(extra)}  {s.description}")
        return 0

    from .core.yaml_io import load_grc
    with open(args.flowgraph) as f:
        g = load_grc(f.read())
    meta = getattr(g, "yaml_meta", {})

    if args.cmd == "inspect":
        flat = g.flatten()
        flat.validate()
        in_len, out_len = flat.resolve_rates(
            meta.get("block_len", args.block_len),
            sample_rate=meta.get("sample_rate", 1.0))
        from .utils.imgraph import render_graph
        print(render_graph(g))
        print(f"graph {g.name!r}: {len(flat.blocks)} blocks, {len(flat.edges)} edges")
        for b in flat.topological_order():
            print(f"  {b.name:30s} {type(b).__name__:24s} "
                  f"in={in_len[b.unique_name]:>8d} out={out_len[b.unique_name]:>8d}")
        for e in flat.edges:
            print(f"  edge {e.src.name}.{e.src_port} → {e.dst.name}.{e.dst_port} "
                  f"({e.samples_per_step} samp/step @ {e.sample_rate:g} Hz)")
        return 0

    # run
    from .core.scheduler import Scheduler
    kw = {"sample_rate": args.sample_rate or meta.get("sample_rate", 1.0),
          "block_len": args.block_len or meta.get("block_len", 1 << 16),
          "device": "cpu" if args.cpu else None}
    profiler = None
    if args.profile:
        from .core.profiler import Profiler
        profiler = Profiler()
        kw["profiler"] = profiler
    try:
        sched = Scheduler(g, **kw)
    except GrError as e:
        if args.cpu:
            raise
        raise GrError("`run` takes the CUDA card and found none; pass --cpu "
                      "to run on the CPU") from e
    try:
        if args.draw:
            _run_with_dashboard(sched, g, args.steps, args.draw_interval)
        else:
            sched.run_and_wait(args.steps)
    except KeyboardInterrupt:
        sched.request_stop()
    if profiler is not None:
        profiler.write(args.profile)
        print(f"profile written to {args.profile}", file=sys.stderr)
    print(f"done: state={sched.state.value} steps={sched._step} "
          f"device={sched.device}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
