"""Multi-process launcher (counterpart: the JAX package's
``cli/launch.py``): spawns N processes of one command with the
``torch.distributed`` environment ``comms/bootstrap.initialize`` reads
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``), prefixes each child's output with its rank, and on the
first failure tears the others down, so a dead rank cannot leave the rest
waiting in a collective::

    python -m pytorch_distributed_training_tpu_torch.cli.launch --nprocs 2 \\
        -- python -m pytorch_distributed_training_tpu_torch.cli.train_dp \\
        --model tiny --task synthetic --device cpu

Each rank takes ``cuda:LOCAL_RANK`` on a host of cards (NCCL), or joins a
gloo group with ``--device cpu``. A rank that exits 75 (preempted, with an
emergency checkpoint) is reported as resumable. The exit code is the first
failing rank's, 0 when every rank succeeds, 130 on Ctrl-C.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading

from pytorch_distributed_training_tpu_torch.faults.preemption import (
    RESUMABLE_EXIT_CODE,
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stream(proc: subprocess.Popen, rank: int) -> None:
    for line in proc.stdout:  # type: ignore[union-attr]
        sys.stdout.write(f"[rank {rank}] {line.decode(errors='replace')}")
        sys.stdout.flush()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        usage="python -m pytorch_distributed_training_tpu_torch.cli.launch "
              "--nprocs N [options] -- <command...>")
    p.add_argument("--nprocs", type=int, required=True,
                   help="number of processes to spawn")
    p.add_argument("--master-addr", default="127.0.0.1",
                   help="rendezvous address (MASTER_ADDR)")
    p.add_argument("--master-port", type=int, default=0,
                   help="rendezvous port (MASTER_PORT; 0 = a free one)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="command to run in every process (prefix with --)")
    return p


def _stop(procs, sig) -> None:
    """Send ``sig`` to the live ``procs``, then kill what has not exited
    10 s later: a rank stuck in a collective ignores it."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(sig)
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        raise SystemExit("no command given (append: -- python -m ... )")
    port = args.master_port or _free_port()
    procs: list[subprocess.Popen] = []
    threads: list[threading.Thread] = []
    for rank in range(args.nprocs):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(args.nprocs), MASTER_ADDR=args.master_addr,
                   MASTER_PORT=str(port))
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        procs.append(proc)
        t = threading.Thread(target=_stream, args=(proc, rank), daemon=True)
        t.start()
        threads.append(t)
    rc = 0
    try:
        remaining = set(range(args.nprocs))
        while remaining:
            for rank in sorted(remaining):
                p = procs[rank]
                try:
                    p.wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    continue
                remaining.discard(rank)
                if p.returncode == 0:
                    continue
                rc = p.returncode
                note = (" (preempted: emergency checkpoint written, "
                        "relaunch with --resume)"
                        if rc == RESUMABLE_EXIT_CODE else "")
                sys.stderr.write(
                    f"[launch] rank {rank} exited with {rc}{note}; "
                    f"terminating {len(remaining)} remaining process(es)\n")
                _stop([procs[r] for r in remaining], signal.SIGTERM)
                remaining = set()
                break
    except KeyboardInterrupt:
        _stop(procs, signal.SIGINT)
        rc = 130
    for t in threads:
        t.join(timeout=5)
    return rc


if __name__ == "__main__":
    sys.exit(main())
