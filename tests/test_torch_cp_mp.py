"""Port parity, context parallelism under ``train_mp``'s modes: the
Trainer at a ``seq`` axis of 2 (ring attention) under branch, stage,
pipeline and 1f1b, and at data 2 × seq 2 (branch) and stage 2 × seq 2
(1F1B), over gloo processes on the CPU (the harness of
``tests/test_torch_mp.py``), each against one process at seq 1 with
reference attention, dropout off: the per-step losses (rtol 1e-5) and
grad norms (rtol 1e-5), the eval metrics, and every weight after the
steps (atol 3e-5, as tests/test_torch_ring.py's). Sequences of 64,
so the two seq shards of a row hold different tokens; the stage wire
joins the stages of one seq coordinate, which a pairing across
coordinates would break here."""

import types

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu_torch.data.synthetic import (
    PAD_ID,
    synthetic_pair_task,
)
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)
from test_torch_mp import _run

torch.set_num_threads(2)

SEQ_LEN = 64
BASE = dict(dropout=0.0, clip=0.0, seq_len=SEQ_LEN, n=2)
RING = dict(attention="ring")


def _same(got, want, rtol=1e-5, atol=3e-5):
    a, b = want["recs"][0], got["recs"][0]
    assert len(a["steps"]) == len(b["steps"]) == 2
    for sa, sb in zip(a["steps"], b["steps"]):
        np.testing.assert_allclose(sb["loss"], sa["loss"], rtol=rtol)
        np.testing.assert_allclose(sb["grad_norm"], sa["grad_norm"],
                                   rtol=rtol)
    for rec in got["recs"]:  # every rank reports the same run
        assert rec["steps"] == b["steps"]
        for k in ("accuracy", "f1"):
            assert rec["history"][0][k] == a["history"][0][k]
    assert got["weights"].keys() == want["weights"].keys()
    for name, w in want["weights"].items():
        torch.testing.assert_close(got["weights"][name], w, rtol=0,
                                   atol=atol, msg=name)


def test_seq_shards_hold_different_tokens():
    # the rows' second halves are not padding: a shard that attended only
    # within itself, or a wire to the other coordinate, shows
    ids = synthetic_pair_task(32, max_length=SEQ_LEN, vocab_size=1024,
                              seed=42)["input_ids"]
    half = SEQ_LEN // 2
    assert (ids[:, half:] != PAD_ID).any(axis=1).mean() > 0.5
    assert not np.array_equal(ids[:, :half], ids[:, half:])


CASES = {
    # name: (world, mode, mesh, reference run, extra spec)
    "branch-s2": (2, "branch", dict(data=1, seq=2), "branch", {}),
    "stage-s2": (2, "stage", dict(data=1, seq=2), "stage", {}),
    "pipeline-s2": (2, "pipeline", dict(data=1, seq=2), "pipe",
                    dict(n_micro=2)),
    "1f1b-s2": (2, "1f1b", dict(data=1, seq=2), "pipe", dict(n_micro=2)),
    "branch-d2s2": (4, "branch", dict(data=2, seq=2), "branch", {}),
    "1f1b-st2s2": (4, "1f1b", dict(data=1, stage=2, seq=2), "pipe",
                   dict(n_micro=2)),
}
REFS = {"branch": ("branch", {}), "stage": ("stage", {}),
        "pipe": ("pipeline", dict(n_micro=2))}


def test_context_parallel_under_every_mode_equals_seq_one(tmp_path):
    runs = {f"one-{ref}": (1, dict(BASE, mode=mode, mesh={}, **extra))
            for ref, (mode, extra) in REFS.items()}
    for name, (world, mode, mesh, _, extra) in CASES.items():
        runs[name] = (world, dict(BASE, mode=mode, mesh=mesh, **RING,
                                  **extra))
    res = _run(tmp_path, runs)
    for name, (world, _, mesh, ref, _) in CASES.items():
        got = res[name]
        assert [r["coords"]["seq"] for r in got["recs"]] == [
            i % 2 for i in range(world)]
        _same(got, res[f"one-{ref}"])


@pytest.mark.parametrize("mode", ["branch", "stage", "pipeline", "1f1b"])
@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_seq_axis_needs_ring_attention_under_a_mode(attention, mode,
                                                     monkeypatch):
    # --attention reference|flash at seq > 1 raises train_dp's ValueError
    # under every mode (a seq axis of 2 stood for by its shape alone)
    from pytorch_distributed_training_tpu_torch.train import loop

    shape = dict(data=1, fsdp=1, stage=1, model=1, seq=2)
    monkeypatch.setattr(loop, "build_mesh", lambda *a, **k: (
        types.SimpleNamespace(shape=shape)))
    with pytest.raises(ValueError, match="use 'ring'"):
        Trainer(model_preset("tiny", attention_impl=attention),
                TrainConfig(train_size=16, eval_size=8), task="synthetic",
                device="cpu", mp_mode=mode, n_micro=1)
