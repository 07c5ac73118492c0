"""``python -m gnuradio4_tpu_torch``, run as users run it (subprocesses, on
the CPU): ``blocks`` lists a subset of the JAX package's types, ``describe``
and ``inspect`` print what the JAX package's print (``inspect``'s block and
edge table), ``run --cpu`` plays ``examples/fm_receiver.yaml`` into a WAV
whose bytes equal the JAX package's run's, ``run`` without ``--cpu`` on a
machine with no card fails naming ``--cpu``, ``run --draw`` prints the
flow's charts, and the commands not ported yet fail saying so. Exact (text
and bytes)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _cli(pkg, *args, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", pkg, *args], capture_output=True,
                          text=True, timeout=timeout, cwd=str(ROOT), env=env)


def test_blocks_lists_a_subset_of_the_jax_packages():
    port = _cli("gnuradio4_tpu_torch", "blocks")
    assert port.returncode == 0, port.stderr
    names = port.stdout.split()
    import gnuradio4_tpu_torch as gt
    assert names == gt.global_registry.known_blocks()
    import gnuradio4_tpu as gr
    assert set(names) <= set(gr.global_registry.known_blocks())
    for t in ("DataSink", "SdrSource", "WavSink", "FileSource", "SsbDemod", "Selector"):
        assert t in names


def test_describe_matches_the_jax_package():
    port = _cli("gnuradio4_tpu_torch", "describe", "FirFilter")
    jax = _cli("gnuradio4_tpu", "describe", "FirFilter")
    assert port.returncode == jax.returncode == 0, port.stderr
    # ports, then each setting's name and default (the first line names each
    # package's module; descriptions are each package's own)
    pl, jl = port.stdout.splitlines(), jax.stdout.splitlines()
    assert pl[0].split()[0] == jl[0].split()[0] == "FirFilter"
    assert pl[2:4] == jl[2:4]
    assert [x.split()[:2] for x in pl[4:]] == [x.split()[:2] for x in jl[4:]]


def test_inspect_prints_the_jax_table():
    path = str(ROOT / "examples" / "fm_receiver.yaml")
    port = _cli("gnuradio4_tpu_torch", "inspect", path)
    jax = _cli("gnuradio4_tpu", "inspect", path)
    assert port.returncode == jax.returncode == 0, port.stderr
    table = port.stdout.splitlines()
    assert table[0] == "graph 'fm_receiver': 6 blocks, 5 edges"
    # the JAX package draws the graph first; its table is the same text
    assert jax.stdout.splitlines()[-len(table):] == table


def test_run_cpu_plays_the_fm_receiver(tmp_path):
    out = {}
    for pkg in ("gnuradio4_tpu_torch", "gnuradio4_tpu"):
        flow = tmp_path / f"{pkg}.yaml"
        wav = tmp_path / f"{pkg}.wav"
        flow.write_text((ROOT / "examples" / "fm_receiver.yaml").read_text()
                        .replace("/tmp/fm_audio.wav", str(wav)))
        r = _cli(pkg, "run", "--cpu", "--steps", "2", str(flow))
        assert r.returncode == 0, r.stderr
        assert "state=STOPPED steps=2" in r.stderr
        out[pkg] = wav.read_bytes()
    assert len(out["gnuradio4_tpu_torch"]) == 44 + 2 * 2 * 24000 // 5
    assert out["gnuradio4_tpu_torch"] == out["gnuradio4_tpu"]


def test_run_without_card_and_without_cpu_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: `run` takes it")
    r = _cli("gnuradio4_tpu_torch", "run", "--steps", "1",
             str(ROOT / "examples" / "channelizer.yaml"))
    assert r.returncode != 0
    assert "GrError" in r.stderr and "--cpu" in r.stderr


@pytest.mark.parametrize("args", [["bench"], ["new-block", "MyBlock"]],
                         ids=["bench", "new-block"])
def test_commands_not_ported_yet_say_so(args):
    r = _cli("gnuradio4_tpu_torch", *args)
    assert r.returncode != 0 and "not ported" in r.stderr


def test_run_draw_prints_a_chart_frame():
    """``run --cpu --draw`` on examples/spectrum_analyzer.yaml with stdout
    not a terminal: frames go out one after another (no alternate screen),
    the last one after the run — the scope's braille chart of the FFT in dB
    and the scheduler's final state."""
    r = _cli("gnuradio4_tpu_torch", "run", "--cpu", "--steps", "20", "--draw",
             "--draw-interval", "0.2", str(ROOT / "examples" / "spectrum_analyzer.yaml"))
    assert r.returncode == 0, r.stderr
    assert "\x1b[?1049h" not in r.stdout
    frame = r.stdout[r.stdout.rindex("── scope "):]
    lines = frame.rstrip("\n").split("\n")
    assert lines[-1] == "[STOPPED] step 20"
    assert len(lines) > 10 and any("\u2800" < ch <= "\u28ff" for ch in frame)
    assert "state=STOPPED steps=20 device=cpu" in r.stderr


def test_run_draw_without_a_drawable_block_runs_headless():
    r = _cli("gnuradio4_tpu_torch", "run", "--cpu", "--steps", "2", "--draw",
             str(ROOT / "examples" / "channelizer.yaml"))
    assert r.returncode == 0, r.stderr
    assert "no drawable blocks" in r.stderr and "steps=2" in r.stderr
