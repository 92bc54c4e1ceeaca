"""Local multi-process launcher: the reference's `torch.distributed.launch`
role, the JAX package's `tools/launch.py`.

Starts N local ranks with the env contract that
`parallel/distributed.initialize` rendezvouses on: WORLD_SIZE, RANK,
LOCAL_RANK, COORDINATOR_ADDRESS (host:port) and its MASTER_ADDR /
MASTER_PORT. Rank 0's output passes through; every other rank's is
prefixed with `[rank N]` on stderr. The first rank to fail takes the job
down: the others get SIGTERM (then SIGKILL after 10 s), and the launcher
exits with the first failure's code (128 + the signal for a rank killed by
one). A SIGTERM to the launcher is forwarded to every rank. With more than
one rank and no `OMP_NUM_THREADS` in the environment, each rank gets
`OMP_NUM_THREADS=1` (as `torchrun` does), so that N ranks on one host do not
each start a full intra-op thread pool; a value the caller set is kept.

    python -m mvp_pytorch_tpu_torch.tools.launch --nproc 2 -- \
        -m mvp_pytorch_tpu_torch.tasks.pretrain --synthetic --tiny \
        --output_dir /tmp/run --do_train --platform cpu

On the card each rank takes `cuda:{LOCAL_RANK}`; `--platform cpu` runs the
ranks over gloo.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, nproc: int, coordinator: str, base=None) -> dict:
    host, _, port = coordinator.rpartition(":")
    env = dict(base if base is not None else os.environ,
               WORLD_SIZE=str(nproc), RANK=str(rank), LOCAL_RANK=str(rank),
               COORDINATOR_ADDRESS=coordinator, MASTER_ADDR=host,
               MASTER_PORT=port)
    if nproc > 1:
        env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="local multi-process launcher (env:// rendezvous)")
    p.add_argument("--nproc", type=int, required=True,
                   help="number of ranks")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port (default localhost:<free port>)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the ranks' python arguments "
                        "(e.g. -- -m mvp_pytorch_tpu_torch.tasks.pretrain ...)")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("no rank command given (append: -- -m <module> ...)")
    coord = args.coordinator or f"localhost:{free_port()}"
    if args.nproc > 1 and "OMP_NUM_THREADS" not in os.environ:
        print("launch: OMP_NUM_THREADS is not set; setting it to 1 for each "
              "of the ranks so that they do not overload the host (set it "
              "yourself to tune)", file=sys.stderr)
    procs = []
    for rank in range(args.nproc):
        procs.append(subprocess.Popen(
            [sys.executable] + cmd, env=rank_env(rank, args.nproc, coord),
            stdout=None if rank == 0 else subprocess.PIPE,
            stderr=None if rank == 0 else subprocess.STDOUT,
            text=rank != 0))

    def pump(rank, proc):
        for line in proc.stdout:
            sys.stderr.write(f"[rank {rank}] {line}")

    threads = [threading.Thread(target=pump, args=(r, pr), daemon=True)
               for r, pr in enumerate(procs) if r]
    for t in threads:
        t.start()

    def forward_term(signum, frame):
        print("launch: SIGTERM - forwarding to every rank", file=sys.stderr)
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, forward_term)
    except ValueError:          # not the main thread
        pass

    rcs = [None] * len(procs)
    induced = set()
    while any(rc is None for rc in rcs):
        for r, proc in enumerate(procs):
            if rcs[r] is None:
                rcs[r] = proc.poll()
        failed = [(r, rc) for r, rc in enumerate(rcs) if rc not in (None, 0)]
        if failed and any(rc is None for rc in rcs):
            print(f"launch: rank {failed[0][0]} exited rc={failed[0][1]}; "
                  "terminating the other ranks", file=sys.stderr)
            for r, proc in enumerate(procs):
                if rcs[r] is None:
                    induced.add(r)
                    proc.terminate()
            for r, proc in enumerate(procs):
                if rcs[r] is None:
                    try:
                        rcs[r] = proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        rcs[r] = proc.wait()
            break
        time.sleep(0.1)
    for t in threads:
        t.join(timeout=5)
    bad = [(r, rc) for r, rc in enumerate(rcs) if rc != 0]
    if bad:
        print(f"launch: ranks failed: {bad}", file=sys.stderr)
        original = [b for b in bad if b[0] not in induced] or bad
        return _code(original[0][1]) or 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
