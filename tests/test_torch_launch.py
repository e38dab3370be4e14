"""The PyTorch package's launcher (``cli/launch.py``; counterpart: the JAX
package's ``cli/launch.py``) on the CPU: each rank gets the
``torch.distributed`` environment ``comms/bootstrap.py`` reads, its output
comes prefixed with its rank, the first failure tears the others down and
its code is the launcher's, a preempted rank is reported resumable, and a
two-rank ``train_dp`` over gloo runs through it. The checks are exact (no
tolerance)."""

import os
import subprocess
import sys
import time

import pytest

from pytorch_distributed_training_tpu_torch.cli import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV_PRINT = ("import os; print(*(os.environ[k] for k in ('RANK', "
              "'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')))")


def _launch(*argv, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               GLOO_SOCKET_IFNAME="lo")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_training_tpu_torch.cli."
         "launch", *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_ranks_get_the_bootstrap_env_and_prefixed_output():
    port = launch._free_port()
    r = _launch("--nprocs", "3", "--master-port", str(port), "--",
                sys.executable, "-c", _ENV_PRINT)
    assert r.returncode == 0, r.stderr
    lines = sorted(r.stdout.splitlines())
    assert lines == [f"[rank {i}] {i} 3 {i} 127.0.0.1 {port}"
                     for i in range(3)]


def test_first_failure_tears_the_rest_down():
    t0 = time.monotonic()
    r = _launch("--nprocs", "2", "--", sys.executable, "-c",
                "import os, sys, time\n"
                "if os.environ['RANK'] == '1': sys.exit(3)\n"
                "time.sleep(120)")
    assert r.returncode == 3
    assert time.monotonic() - t0 < 60  # the sleeper did not run out
    assert "rank 1 exited with 3" in r.stderr
    assert "terminating 1 remaining" in r.stderr


def test_preempted_rank_reported_resumable():
    r = _launch("--nprocs", "1", "--", sys.executable, "-c",
                "import sys; sys.exit(75)")
    assert r.returncode == 75
    assert "preempted: emergency checkpoint written" in r.stderr


def test_no_command_refused():
    with pytest.raises(SystemExit, match="no command"):
        launch.main(["--nprocs", "2"])


def test_two_rank_train_dp_over_gloo(tmp_path):
    r = _launch("--nprocs", "2", "--", sys.executable, "-m",
                "pytorch_distributed_training_tpu_torch.cli.train_dp",
                "--model", "tiny", "--task", "synthetic", "--device", "cpu",
                "--train-size", "32", "--eval-size", "16",
                "--global-batch-size", "16", "--micro-batch-size", "4",
                "--num-epochs", "1", "--log-every", "0",
                "--max-seq-length", "32", "--history-out",
                str(tmp_path / "h.json"), timeout=180)
    assert r.returncode == 0, r.stdout[-3000:]
    assert "[rank 0] " in r.stdout and "2 process(es), backend=gloo" in \
        r.stdout
    assert (tmp_path / "h.json").exists()
