"""Multi-process failure worker of the PyTorch port (the counterpart of
multihost_failure_worker.py): process 1 dies mid-run; process 0's Scheduler
must fail FAST and DIAGNOSABLY — the wedged collective flagged by the
watchdog (watchdog_action='error' → ERROR state + collective-timeout
GrError) or the collective itself raising — never a silent hang. Spawned by
test_torch_multihost.py — not a test.

Usage: python torch_multihost_failure_worker.py <process_id> <num_processes> <port>
"""

import os
import sys
import time


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import gnuradio4_tpu_torch as gt
    from gnuradio4_tpu_torch.core.errors import GrError
    from gnuradio4_tpu_torch.parallel import multihost as mh

    mh.init_distributed(f"127.0.0.1:{port}", nproc, pid, device="cpu",
                        timeout=60.0)
    mesh = mh.global_mesh(("sp",), ["cpu"] * 2)
    rng = np.random.default_rng(3)
    block = 2048
    n_steps = 400                       # long stream: survivor must not finish
    x = rng.standard_normal(block * n_steps).astype(np.float32)
    taps = (np.hamming(31) / np.hamming(31).sum()).astype(np.float32)

    g = gt.Graph()
    src = g.emplace("VectorSource", data=x)
    fir = g.emplace("FirFilter", taps=taps)   # sp halo → a cross-process message
    snk = g.emplace("VectorSink")
    g.connect_chain(src, fir, snk)

    if pid == 1:
        # run a couple of steps so both processes are mid-stream, then DIE
        sched = gt.Scheduler(g, block_len=block, mesh=mesh, pipeline_depth=1)
        for _ in range(3):
            sched.step_once()
        print(f"[{pid}] dying abruptly mid-run", flush=True)
        os._exit(17)

    # survivor: the watchdog or the collective must raise within 90 s
    sched = gt.Scheduler(g, block_len=block, mesh=mesh, pipeline_depth=1,
                         watchdog_timeout=3.0, watchdog_action="error")
    t0 = time.monotonic()
    sched.start()
    deadline = t0 + 90.0
    while time.monotonic() < deadline:
        try:
            sched.wait_done(timeout=2.0)
            # the stream is 400 steps on purpose: a clean finish means the
            # peer's death went unnoticed
            print(f"[{pid}] UNEXPECTED-CLEAN-FINISH", flush=True)
            return 2
        except TimeoutError:
            continue
        except GrError as e:
            dt = time.monotonic() - t0
            print(f"[{pid}] GOT-ERROR after {dt:.1f}s: {e}", flush=True)
            # hard exit: the process group's teardown would wait on the dead
            # peer (and the pump thread may be wedged in Gloo) — the verdict
            # is already on stdout
            os._exit(0)
    print(f"[{pid}] HUNG — no error within 90s", flush=True)
    os._exit(3)


if __name__ == "__main__":
    sys.exit(main())
