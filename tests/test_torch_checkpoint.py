"""Port parity, checkpoints: the PyTorch package's manifests, checkpoint
manager, resume and offline validator (``train/manifest.py``,
``train/checkpoint.py``, ``cli/verify_checkpoint.py``) against the JAX
package's manifest verdicts and training steps, and save/restore across
topologies over gloo processes, on the CPU.

Tolerances: restored state (weights, moments, ``count``, ``step``,
``dropout_seed``) and resumed runs bit for bit; the resumed run's per-step
losses against JAX's uninterrupted steps on bridged weights at
``test_torch_train.py``'s rtol 1e-5."""

import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.faults.inject import corrupt_step_dir
from pytorch_distributed_training_tpu.train import (
    adamw_with_schedule,
    create_train_state,
)
from pytorch_distributed_training_tpu.train import manifest as jax_manifest
from pytorch_distributed_training_tpu.train import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.utils.config import (
    TrainConfig as JaxTrainConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import (
    train_dp,
    train_lm,
    train_mp,
    verify_checkpoint,
)
from pytorch_distributed_training_tpu_torch.models.convert import params_to_jax
from pytorch_distributed_training_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_training_tpu_torch.train import manifest
from pytorch_distributed_training_tpu_torch.train import loop
from pytorch_distributed_training_tpu_torch.train.loop import Trainer
from pytorch_distributed_training_tpu_torch.utils.config import (
    TrainConfig,
    model_preset,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROPOUT = dict(compute_dtype="float32", hidden_dropout=0.0,
                  attention_dropout=0.0)


def _trainer(tmp=None, *, mcfg=None, **kw) -> Trainer:
    """Tiny BERT on the synthetic task, float32: 8 steps of 16 = 2 x 8."""
    tcfg = dict(num_epochs=1, train_size=128, eval_size=16,
                global_batch_size=16, micro_batch_size=8, eval_batch_size=16,
                warmup_steps=1, learning_rate=1e-3, log_every=0, bf16=False)
    if tmp is not None:
        tcfg["checkpoint_dir"] = str(tmp)
    tcfg.update(kw)
    return Trainer(mcfg or model_preset("tiny", **NO_DROPOUT),
                   TrainConfig(**tcfg), task="synthetic", device="cpu")


def _state_dict(t: Trainer) -> dict:
    """Everything a checkpoint holds of ``t``, whole."""
    return {k: v.detach().clone() for k, v in ckpt._saveable(t.state).items()}


def _assert_same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny run checkpointed every 2 steps (steps 2, 4, 6, 8 written;
    the newest 3 kept), and its final state."""
    d = tmp_path_factory.mktemp("trained") / "ck"
    t = _trainer(d, checkpoint_every_steps=2, weight_decay=0.01)
    t.run()
    return str(d), _state_dict(t)


def _copy(src: str, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


# --------------------------------------------------------------- manifests


def _damage(path: str, kind: str) -> None:
    """Damage the committed step at ``path`` one way (JAX
    ``tests/test_faults.py:199-254``)."""
    data = max((os.path.join(path, f) for f in os.listdir(path)
                if f != manifest.MANIFEST_NAME), key=os.path.getsize)
    if kind == "truncated":
        with open(data, "r+b") as f:
            f.truncate(os.path.getsize(data) // 2)
    elif kind == "same_size":
        corrupt_step_dir(path)
    elif kind == "missing_file":
        os.remove(os.path.join(path, ".metadata"))
    elif kind == "no_manifest":
        os.remove(os.path.join(path, manifest.MANIFEST_NAME))
    elif kind == "unreadable_manifest":
        with open(os.path.join(path, manifest.MANIFEST_NAME), "w") as f:
            f.write("{torn")


@pytest.mark.parametrize("kind", ["intact", "truncated", "same_size",
                                  "missing_file", "no_manifest",
                                  "unreadable_manifest"])
def test_verify_step_agrees_with_jax_on_damaged_steps(trained, tmp_path, kind):
    d = _copy(trained[0], tmp_path / "ck")
    path = ckpt.step_path(d, 8)
    _damage(path, kind)
    for level in manifest.VERIFY_LEVELS:
        for legacy_ok in (False, True):
            got = manifest.verify_step(path, level=level, legacy_ok=legacy_ok)
            want = jax_manifest.verify_step(path, level=level,
                                            legacy_ok=legacy_ok)
            assert got == want, (kind, level, legacy_ok)
    assert manifest.read_manifest(path) == jax_manifest.read_manifest(path)
    expect = {"intact": (True, "ok"), "truncated": (False, "size mismatch"),
              "same_size": (True, "ok"), "missing_file": (False, "file "
                                                          "missing"),
              "no_manifest": (False, "no manifest"),
              "unreadable_manifest": (False, "manifest unreadable")}[kind]
    ok, reason = manifest.verify_step(path, level="size")
    assert ok == expect[0] and reason.startswith(expect[1])
    if kind == "same_size":
        assert manifest.verify_step(path, level="digest")[1].startswith(
            "digest mismatch")


def test_manifest_records_the_saved_tree_and_files(trained):
    d, state = trained
    m = manifest.read_manifest(ckpt.step_path(d, 8))
    assert m["step"] == 8 and m["format"] == manifest.MANIFEST_FORMAT
    assert m["versions"]["torch"] == torch.__version__
    assert {k: (v["shape"], v["dtype"]) for k, v in m["tree"].items()} == {
        k: (list(v.shape), str(v.dtype)) for k, v in state.items()}
    assert ".metadata" in m["files"]
    assert ckpt.all_steps(d) == [4, 6, 8]  # keep=3 pruned step 2


# ----------------------------------------------------------------- restore


def test_save_and_restore_bit_equal_into_a_fresh_trainer(trained):
    d, state = trained
    fresh = _trainer(d, resume=True, weight_decay=0.01)
    assert fresh.state.step == 8
    _assert_same_state(_state_dict(fresh), state)
    assert ckpt.restore_params(d).keys() == fresh.state.module.state_dict(
        ).keys()


def test_restore_leaves_count_and_weights_unchanged(tmp_path):
    # warmup 0 and weight decay: an optimizer step made to build the
    # moments (torch.distributed.checkpoint's optimizer helpers) would
    # move count and, through the decay, every weight
    t = _trainer(tmp_path / "ck", warmup_steps=0, weight_decay=0.1,
                 train_size=32)
    t.run()
    want = _state_dict(t)
    fresh = _trainer(tmp_path / "ck", warmup_steps=0, weight_decay=0.1,
                     train_size=32)
    before = {k: v.clone() for k, v in fresh.state.module.state_dict().items()}
    assert fresh.state.optimizer.count == 0
    ckpt.restore_checkpoint(str(tmp_path / "ck"), fresh.state)
    assert fresh.state.optimizer.count == want["optim.count"] == 2
    _assert_same_state(_state_dict(fresh), want)
    assert any(not torch.equal(before[k], want[f"model.{k}"])
               for k in before)


def test_restore_falls_back_to_the_newest_verified_step(trained, tmp_path):
    d = _copy(trained[0], tmp_path / "ck")
    corrupt_step_dir(ckpt.step_path(d, 8))
    c = ckpt.Checkpointer(d, verify="digest")
    assert c.verified_latest_step() == 6
    t = _trainer(weight_decay=0.01)
    c.restore(t.state)
    assert t.state.step == 6 and c.restores[0]["step"] == 6
    # size-level verification is blind to same-size damage: the load of
    # the damaged step itself fails and falls through to step 6
    t = _trainer(weight_decay=0.01)
    ckpt.Checkpointer(d, verify="size").restore(t.state)
    assert t.state.step == 6


def test_no_verified_step_is_corrupt_and_legacy_is_accepted(trained, tmp_path):
    d = _copy(trained[0], tmp_path / "ck")
    for s in ckpt.all_steps(d):
        _damage(ckpt.step_path(d, s), "truncated")
    with pytest.raises(ckpt.CheckpointCorruptError, match="no verified"):
        ckpt.Checkpointer(d).restore(_trainer().state)
    legacy = _copy(trained[0], tmp_path / "legacy")
    for s in ckpt.all_steps(legacy):
        _damage(ckpt.step_path(legacy, s), "no_manifest")
    t = _trainer(weight_decay=0.01)
    ckpt.Checkpointer(legacy).restore(t.state)
    assert t.state.step == 8
    with pytest.raises(FileNotFoundError):
        ckpt.Checkpointer(str(tmp_path / "empty")).restore(t.state)


def test_duplicate_step_skipped_and_a_corrupt_one_saved_again(trained,
                                                               tmp_path):
    d = _copy(trained[0], tmp_path / "ck")
    t = _trainer(d, resume=True, weight_decay=0.01)
    c = t.checkpointer
    before = os.path.getmtime(os.path.join(ckpt.step_path(d, 8),
                                           ".metadata"))
    c.save(t.state)
    assert not c.saves  # skipped: the step verifies
    _damage(ckpt.step_path(d, 8), "truncated")
    c.save(t.state)
    assert [s["step"] for s in c.saves] == [8]
    assert manifest.verify_step(ckpt.step_path(d, 8), level="digest") == (
        True, "ok")
    assert os.path.getmtime(os.path.join(ckpt.step_path(d, 8),
                                         ".metadata")) >= before
    assert not any(n.startswith(".tmp") for n in os.listdir(d))


# ------------------------------------------------------------------ resume


def _jax_losses(t: Trainer, start: dict, steps: int) -> list:
    """JAX's uninterrupted run: its train step on the port loader's batches
    from the port's initial weights, bridged."""
    jcfg = JaxTrainConfig(learning_rate=1e-3, warmup_steps=1)
    tx, _ = adamw_with_schedule(jcfg, steps)
    model = JaxBert(jax_preset("tiny", **NO_DROPOUT))
    example = {"input_ids": jnp.ones((2, 16), jnp.int32),
               "attention_mask": jnp.ones((2, 16), jnp.int32),
               "token_type_ids": jnp.zeros((2, 16), jnp.int32)}
    state = create_train_state(model, tx, jax.random.key(0), example)
    state = state.replace(params=jax.tree.map(jnp.asarray, params_to_jax(
        start)), opt_state=tx.init(jax.tree.map(jnp.asarray,
                                                params_to_jax(start))))
    step = jax_make_train_step(grad_accum_steps=t.tcfg.grad_accum_steps)
    losses = []
    for batch in t.train_loader.epoch(0):
        state, m = step(state, {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses


def test_midepoch_resume_ends_on_the_uninterrupted_run(tmp_path):
    # JAX test_trainer_integration.py:93: checkpoint every 3 steps,
    # restore step 6 and finish the epoch (8 steps); atol 1e-5 there,
    # bit for bit here
    full = _trainer()
    start = {k: v.clone() for k, v in full.state.module.state_dict().items()}
    full.run()
    d = tmp_path / "mid"
    part = _trainer(d, checkpoint_every_steps=3)
    part.run()
    assert ckpt.all_steps(str(d)) == [3, 6, 8]
    resumed = _trainer(d)
    resumed.checkpointer.restore(resumed.state, step=6)
    resumed.run()
    assert resumed.state.step == full.state.step == 8
    _assert_same_state(_state_dict(resumed), _state_dict(full))
    losses = [s["loss"] for s in full.step_log]
    assert [s["loss"] for s in part.step_log][:6] + [
        s["loss"] for s in resumed.step_log] == losses
    np.testing.assert_allclose(losses, _jax_losses(full, start, 8),
                               rtol=1e-5)


def test_resume_with_dropout_draws_the_uninterrupted_seeds(tmp_path):
    # dropout on: step n's seeds come from (dropout_seed, n), so the
    # resumed steps draw the uninterrupted run's masks
    mcfg = model_preset("tiny", compute_dtype="float32")
    full = _trainer(mcfg=mcfg, train_size=64)
    full.run()
    part = _trainer(tmp_path / "ck", mcfg=mcfg, train_size=64,
                    checkpoint_every_steps=1)
    part.run()
    shutil.rmtree(ckpt.step_path(str(tmp_path / "ck"), 4))
    shutil.rmtree(ckpt.step_path(str(tmp_path / "ck"), 3))
    resumed = _trainer(tmp_path / "ck", mcfg=mcfg, train_size=64,
                       resume=True)
    assert resumed.state.step == 2
    assert resumed.state.dropout_seed == full.state.dropout_seed
    resumed.run()
    assert [s["loss"] for s in resumed.step_log] == [
        s["loss"] for s in full.step_log][2:]
    _assert_same_state(_state_dict(resumed), _state_dict(full))


def test_checkpoint_flags_default_as_jax():
    from pytorch_distributed_training_tpu.cli import train_dp as jax_train_dp

    flags = ("checkpoint_dir", "checkpoint_every_steps", "resume",
             "checkpoint_verify")
    want = vars(jax_train_dp.build_parser().parse_args([]))
    for cli in (train_dp, train_lm, train_mp):
        got = vars(cli.build_parser().parse_args([]))
        assert {f: got[f] for f in flags} == {f: want[f] for f in flags}
    assert vars(train_dp.build_parser().parse_args([]))["hf_checkpoint"] is None
    args = train_lm.build_parser().parse_args(
        ["--checkpoint-dir", "x", "--checkpoint-every-steps", "5", "--resume",
         "--checkpoint-verify", "digest"])
    assert (args.checkpoint_dir, args.checkpoint_every_steps, args.resume,
            args.checkpoint_verify) == ("x", 5, True, "digest")


# -------------------------------------------------------------- int8 flags


def _int8(**kw):
    return model_preset("tiny", compute_dtype="float32",
                        matmul_impl="int8_full", **kw)


def test_delayed_int8_amaxes_restored_and_calibration_skipped(tmp_path,
                                                             monkeypatch):
    kw = dict(quant_delayed=True, quant_delayed_grads=True)
    t = _trainer(tmp_path / "ck", mcfg=_int8(**kw), train_size=32)
    t.run()
    saved = _state_dict(t)
    assert any(k.endswith(".amax") for k in saved)
    assert any(k.endswith(".dy_amax") for k in saved)
    calls = []
    real = loop.calibrate_quant
    monkeypatch.setattr(loop, "calibrate_quant",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    resumed = _trainer(tmp_path / "ck", mcfg=_int8(**kw), train_size=32,
                       resume=True)
    assert not calls  # the checkpoint's amaxes, not a new calibration
    _assert_same_state(_state_dict(resumed), saved)
    _trainer(mcfg=_int8(**kw), train_size=32)
    assert len(calls) == 2  # a fresh run calibrates (two passes)


def test_delayed_int8_flag_mismatch_message(tmp_path):
    # JAX tests/test_quant.py:535-553: save without --quant-delayed,
    # resume with it, and the reverse
    plain = _trainer(tmp_path / "plain", mcfg=_int8(), train_size=32)
    plain.run()
    with pytest.raises(ValueError, match="--quant-delayed") as e:
        _trainer(tmp_path / "plain", mcfg=_int8(quant_delayed=True),
                 train_size=32, resume=True)
    assert "quant_delayed ON" in str(e.value)
    delayed = _trainer(tmp_path / "delayed", mcfg=_int8(quant_delayed=True),
                       train_size=32)
    delayed.run()
    with pytest.raises(ValueError, match="quant_delayed OFF"):
        _trainer(tmp_path / "delayed", mcfg=_int8(), train_size=32,
                 resume=True)


# ------------------------------------------------------------- verify CLI


def _cli(capsys, *argv):
    code = verify_checkpoint.main(list(argv))
    return code, capsys.readouterr()


def test_verify_cli_exit_codes_and_json_report(trained, tmp_path, capsys):
    # JAX tests/test_faults.py:515-672
    d = _copy(trained[0], tmp_path / "ck")
    code, out = _cli(capsys, d)
    assert code == verify_checkpoint.EXIT_VERIFIED
    assert "3/3 step(s) verified" in out.out and "restore would use: 8" in (
        out.out)
    corrupt_step_dir(ckpt.step_path(d, 8))
    assert _cli(capsys, d)[0] == verify_checkpoint.EXIT_VERIFIED  # size-blind
    code, out = _cli(capsys, d, "--strict", "--json")
    assert code == verify_checkpoint.EXIT_PARTIAL
    report = json.loads(out.out)
    assert (report["verdict"], report["verified"], report["total"],
            report["verified_latest"], report["level"]) == (
        "partial", 2, 3, 6, "digest")
    by_step = {r["step"]: r for r in report["steps"]}
    assert not by_step[8]["ok"] and by_step[8]["reason"].startswith(
        "digest mismatch")
    assert by_step[6]["digests"] == {
        rel: v["sha256"] for rel, v in manifest.read_manifest(
            ckpt.step_path(d, 6))["files"].items()}
    assert _cli(capsys, d, "--strict", "--step", "6")[0] == (
        verify_checkpoint.EXIT_VERIFIED)
    for s in (4, 6):
        _damage(ckpt.step_path(d, s), "truncated")
    code, out = _cli(capsys, d, "--strict")
    assert code == verify_checkpoint.EXIT_CORRUPT
    assert "NOTHING" in out.out
    code, out = _cli(capsys, d, "--step", "99", "--json")
    assert code == verify_checkpoint.EXIT_MISSING
    assert json.loads(out.out)["verdict"] == "missing"
    assert _cli(capsys, str(tmp_path / "none"))[0] == (
        verify_checkpoint.EXIT_MISSING)
    os.makedirs(tmp_path / "empty")
    assert _cli(capsys, str(tmp_path / "empty"), "--quiet")[0] == (
        verify_checkpoint.EXIT_MISSING)


# ------------------------------------------------------ topology over gloo


_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.cli import (
        train_dp, train_lm, train_mp)
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        shutdown)
    from pytorch_distributed_training_tpu_torch.train import checkpoint

    out, spec = sys.argv[1], json.loads(sys.argv[2])
    cli = {"train_dp": train_dp, "train_lm": train_lm,
           "train_mp": train_mp}[spec["cli"]]
    t = cli.build_trainer(cli.build_parser().parse_args(spec["argv"]))

    def whole():
        return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                .detach().clone()
                for k, v in checkpoint._saveable(t.state).items()}

    if spec.get("restore_step"):
        t.checkpointer.restore(t.state, step=spec["restore_step"])
    start = whole()
    if spec.get("run"):
        t.run()
    end = whole()
    torch.save({"start": start, "end": end}, f"{out}.{t.info.rank}.pt")
    if t.info.rank == 0:
        with open(out + ".json", "w") as f:
            json.dump({"steps": t.step_log, "world": t.info.world_size}, f)
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, runs: dict) -> dict:
    """Start every run (name -> (world size, spec)) at once, a process a
    rank; each run's step log and its start and end state, merged over the
    ranks (a name several ranks hold: the same values)."""
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
                GLOO_SOCKET_IFNAME="lo", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT"):
        base.pop(k, None)
    procs = []
    for name, (world, spec) in runs.items():
        port = str(_free_port())
        for r in range(world):
            env = dict(base)
            if world > 1:
                env.update(MASTER_PORT=port, WORLD_SIZE=str(world),
                           RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _SCRIPT, str(tmp_path / name),
                 json.dumps(spec)],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
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
    out = {}
    for name, (world, _) in runs.items():
        rec = json.loads((tmp_path / f"{name}.json").read_text())
        for r in range(world):
            part = torch.load(str(tmp_path / f"{name}.{r}.pt"))
            for when, state in part.items():
                merged = rec.setdefault(when, {})
                for k, v in state.items():
                    assert k not in merged or torch.equal(merged[k], v), k
                    merged[k] = v
        out[name] = rec
    return out


_LM = ["--model", "gpt2-tiny", "--device", "cpu", "--train-size", "64",
       "--eval-size", "16", "--global-batch-size", "16",
       "--micro-batch-size", "4", "--num-epochs", "1", "--seed", "7",
       "--no-bf16", "--warmup-steps", "1", "--learning-rate", "1e-3",
       "--log-every", "0", "--weight-decay", "0.01"]
_MP = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
       "--train-size", "32", "--eval-size", "16", "--global-batch-size",
       "16", "--micro-batch-size", "8", "--num-epochs", "1", "--no-bf16",
       "--warmup-steps", "1", "--learning-rate", "1e-3", "--log-every", "0"]


@pytest.fixture(scope="module")
def topology(tmp_path_factory):
    """Saves at one topology, restores at another: the LM at fsdp 2 and
    in one process (scanned), tensor parallelism at model 2 and one
    process (per-layer), ``train_mp`` 1F1B at stage 2; then each restored
    where it was not saved, and the fsdp-2 run resumed mid-epoch."""
    tmp = tmp_path_factory.mktemp("topology")

    def lm(ck, *extra, every="2", run=True, **spec):
        return dict(cli="train_lm", run=run, argv=_LM + [
            "--checkpoint-dir", str(tmp / ck), "--checkpoint-every-steps",
            every, *extra], **spec)

    tp = ["--tp", "--no-scan-layers", "--mesh-model", "2"]
    saves = _launch(tmp, {
        "fsdp": (2, lm("fsdp", "--mesh-fsdp", "2")),
        "one": (1, lm("one")),
        "tp": (2, lm("tp", *tp)),
        "one_flat": (1, lm("one_flat", "--no-scan-layers")),
        "mp_1f1b": (2, dict(cli="train_mp", run=True, argv=_MP + [
            "--mp-mode", "1f1b", "--mesh-data", "1", "--mesh-stage", "2",
            "--checkpoint-dir", str(tmp / "mp")])),
    })
    resume = ["--resume"]
    restores = _launch(tmp, {
        "fsdp_to_one": (1, lm("fsdp", *resume, run=False)),
        "one_to_fsdp": (2, lm("one", "--mesh-fsdp", "2", *resume,
                              run=False)),
        "fsdp_resumed": (2, lm("fsdp", "--mesh-fsdp", "2", restore_step=2)),
        "tp_to_one": (1, lm("tp", "--no-scan-layers", *resume, run=False)),
        "one_to_tp": (2, lm("one_flat", *tp, *resume, run=False)),
        "mp_to_stage": (1, dict(cli="train_mp", run=False, argv=_MP + [
            "--mp-mode", "stage", "--checkpoint-dir", str(tmp / "mp"),
            "--resume"])),
    })
    return saves, restores


@pytest.mark.parametrize("saved,restored", [
    ("fsdp", "fsdp_to_one"), ("one", "one_to_fsdp"), ("tp", "tp_to_one"),
    ("one_flat", "one_to_tp"), ("mp_1f1b", "mp_to_stage")])
def test_restore_at_another_topology_is_bit_equal(topology, saved, restored):
    saves, restores = topology
    assert restores[restored]["world"] != saves[saved]["world"]
    _assert_same_state(restores[restored]["start"], saves[saved]["end"])
    assert int(restores[restored]["start"]["step"]) == len(
        saves[saved]["steps"])


def test_fsdp_resume_over_gloo_ends_on_the_uninterrupted_run(topology):
    saves, restores = topology
    full, resumed = saves["fsdp"], restores["fsdp_resumed"]
    assert resumed["world"] == 2 and int(resumed["start"]["step"]) == 2
    assert [s["loss"] for s in resumed["steps"]] == [
        s["loss"] for s in full["steps"]][2:]
    _assert_same_state(resumed["end"], full["end"])
