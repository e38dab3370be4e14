"""Port parity, profiling and the NaN checks (``utils/profiling.py``): a
tiny run's trace holds its ``train_step`` and ``eval_step`` ranges, a
trace that cannot start warns and the run goes on, two gloo ranks trace
under ``host_<rank>``, and with ``debug_nans`` both packages raise
``FloatingPointError`` on a NaN planted in a weight and neither raises on
clean weights, on the CPU."""

import glob
import json
import logging
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.parallel import (
    ShardingPolicy as JaxShardingPolicy,
)
from pytorch_distributed_training_tpu.train.loop import Trainer as JaxTrainer
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils import profiling
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)
from pytorch_distributed_training_tpu_torch.utils.logging import get_logger

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(num_epochs=1, global_batch_size=16, micro_batch_size=8,
           eval_batch_size=16, train_size=32, eval_size=16, log_every=0,
           learning_rate=1e-3, warmup_steps=1)


def _trainer(**kw):
    return Trainer(model_preset("tiny", compute_dtype="float32"),
                   TrainConfig(**dict(RUN, **kw)), task="synthetic",
                   device="cpu")


def _trace_names(path) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profile_dir_writes_a_trace_with_step_ranges(tmp_path):
    t = _trainer(profile_dir=str(tmp_path / "prof"))
    t.run()
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1
    names = _trace_names(traces[0])
    assert {"train_step", "eval_step"} <= names
    assert "aten::addmm" in names or "aten::mm" in names


def test_a_trace_that_cannot_start_warns_and_the_run_goes_on(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = seen.append
    get_logger().addHandler(handler)
    try:
        history = _trainer(profile_dir=str(blocker / "prof")).run()
    finally:
        get_logger().removeHandler(handler)
    assert history and "accuracy" in history[0]
    assert any("profiler trace failed to start" in r.getMessage()
               for r in seen)


def test_two_ranks_trace_under_host_rank(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    cmd = [sys.executable, "-m",
           "pytorch_distributed_training_tpu_torch.cli.train_dp",
           "--model", "tiny", "--task", "synthetic", "--device", "cpu",
           "--train-size", "32", "--eval-size", "16",
           "--global-batch-size", "16", "--num-epochs", "1",
           "--log-every", "0", "--profile-dir", str(tmp_path / "prof")]
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank in (0, 1):
        traces = glob.glob(str(tmp_path / "prof" / f"host_{rank}" /
                               "*.pt.trace.json"))
        assert len(traces) == 1, rank
        assert "train_step" in _trace_names(traces[0])
    assert not glob.glob(str(tmp_path / "prof" / "*.json"))


@pytest.fixture
def nans_off():
    yield
    profiling.set_debug_nans(False)
    jax.config.update("jax_debug_nans", False)


def _plant_nan_jax(t):
    # made on the host and placed: no computation for the checker to see
    params = dict(t.state.params)
    clf = dict(params["classifier"])
    kernel = np.array(clf["kernel"])
    kernel[0, 0] = np.nan
    clf["kernel"] = jax.device_put(kernel, clf["kernel"].sharding)
    params["classifier"] = clf
    t.state = t.state.replace(params=params)


def test_debug_nans_raise_in_both_packages(nans_off, eight_devices):
    jax_cfg = dict(RUN, debug_nans=True, guards="off", aot_warmup=False)

    def jax_trainer():
        return JaxTrainer(jax_preset("tiny", compute_dtype="float32"),
                          JaxTrainConfig(**jax_cfg), JaxMeshConfig(data=8),
                          JaxShardingPolicy(), task="synthetic")

    assert jax_trainer().run()  # clean weights: no error
    t = jax_trainer()
    _plant_nan_jax(t)
    with pytest.raises(FloatingPointError):
        t.run()
    jax.config.update("jax_debug_nans", False)

    assert _trainer(debug_nans=True).run()
    assert profiling.debug_nans()
    t = _trainer(debug_nans=True)
    with torch.no_grad():
        t.state.module.classifier.kernel.view(-1)[0] = float("nan")
    with pytest.raises(FloatingPointError, match="NaN in the forward output"):
        t.run()
    # a later run without the option has the checks off again
    _trainer().state
    assert not profiling.debug_nans()


def test_nan_gradient_is_named(nans_off):
    profiling.set_debug_nans(True)
    lin = torch.nn.Linear(2, 2)
    params = list(lin.parameters())
    grads = [torch.zeros_like(p) for p in params]
    profiling.check_grads(lin, params, grads)  # clean
    grads[1][0] = float("nan")
    with pytest.raises(FloatingPointError, match="gradient of bias"):
        profiling.check_grads(lin, params, grads)
    grads[1][0] = float("inf")  # NaN only, as JAX's checker
    profiling.check_grads(lin, params, grads)
