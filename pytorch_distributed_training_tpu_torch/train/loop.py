"""The Trainer: data, model, optimizer, DDP, epochs, eval and the metric
history (counterpart: the JAX package's ``train/loop.py`` ``Trainer``, its
data-parallel classification and causal-LM paths and its hybrid data ×
model parallel path).

The task picks the objective, as in the JAX trainer: ``lm`` trains a
causal preset (``GPT2LMModel``) on next-token cross-entropy
(``"causal_lm"``), every other task an encoder preset
(``BertForSequenceClassification``) on classification; a preset whose
``causal`` disagrees raises.

The ranks form a mesh (``comms/mesh.py``; ``mesh_config`` None: every
rank on the ``data`` axis). ``mp_mode`` splits the model over an axis of
it: ``"branch"`` the branch ensemble (``models/branch.py``, or what
``model(model_config, seed=, mesh=)`` builds) over ``model``, ``"stage"``
BERT's layers over ``stage`` (``models/stage.py``, per-layer modules, so
not with ``scan_layers``), ``"pipeline"`` and ``"1f1b"`` the same split
trained through the GPipe and 1F1B schedules (``parallel/pipeline.py``)
in ``n_micro`` pipeline microbatches an accumulation microbatch (an int,
or a function of the mesh such as ``train_mp``'s ``resolve_n_micro``):
the train loader then cuts each step into ``grad_accum_steps × n_micro``
microbatches, and the eval runs stage mode's forward; a ``stage`` axis
of more than one rank that no mode splits raises, and with no mode a
``model`` axis is tensor parallelism's (``policy.tp``: the model is made
whole, then cut to this rank's Megatron slice, ``parallel/sharding.
tensor_parallel``, before FSDP or DDP) or, without it, replicas that
compute alike, as JAX replicates the parameters there. A ``seq`` axis of
more than one rank is context parallelism (``"ring"`` attention), with
no mode or under any of them: the loader cuts each row's columns over it
(the LM targets shifted on the whole rows first,
``train/step.lm_whole_rows``) and the model reads its coordinate
(``context_parallel``): each branch's and stage's layers attend through
the ring, the stage wire joins the stages of one seq coordinate, and the
pooler reads seq coordinate 0's CLS row. The batch shards over
``(data, fsdp)``: the ranks of one batch shard read the same rows and
draw the same dropout (``batch_index`` stands for the rank), and the
gradients are reduced over ``(data, fsdp, seq)``. ``policy``
(``parallel/sharding.py``; None: off) with ``fsdp`` on and an ``fsdp``
axis of more than one rank shards the model with FSDP over the (data ×
seq, fsdp) sub-mesh at this rank's stage and model coordinates
(``shard``); otherwise DDP averages the gradients over the gradient axes
(the params replicated, as JAX replicates them with the policy off), or,
under the schedules, their train step does once a step. The grad norm is
the whole model's (a TP slice's squares summed over ``model``), and the
eval counts are summed over the ``stage`` group (the last stage's), the
``seq`` group and then the batch group. ``samples_per_sec_per_chip``
divides by every rank.

Per epoch: every optimizer step over ``[accum, micro, ...]`` batches, then
a masked eval pass over the whole validation split and one history record
with the JAX trainer's keys (``epoch``, ``train_loss``,
``samples_per_sec``, ``samples_per_sec_per_chip``, then the eval metrics:
``accuracy`` and, for binary tasks, ``f1``; for ``lm``, ``eval_loss``,
``perplexity`` and ``token_accuracy``). ``step_log`` keeps each step's
loss and grad norm (and, under the schedules, ``pipeline_bubble``),
fetched from the device once per epoch.

int8 training (``matmul_impl`` int8/int8_full, ``ops/quant.py``): every
int8 site maxes its amaxes over the gradient axes' group
(``parallel/sharding.int8_groups``), so the ranks quantize on the same
scales, and, with ``quant_delayed``, the amax buffers are observed before
step 0 on this rank's rows of the dataset's first global microbatch
(``train/step.calibrate_quant``; JAX ``train/loop.py:255-296``). The
buffers start at zero where JAX's init observed a dummy batch, so a
first calibration pass stands for that one. DDP broadcasts no buffers:
the amaxes agree on every rank by construction, and a broadcast from rank
0 at each forward would cost a collective a microbatch for nothing.

Checkpoints (``train/checkpoint.py``; JAX ``train/loop.py:240-254``):
with ``checkpoint_dir`` the run saves at every epoch's end and every
``checkpoint_every_steps`` updates (every rank its shards, written in
the background; rank 0 commits, seals and prunes at the next save's join,
and the run's end joins the last), and with ``resume`` it starts from the newest verified
step there, before the delayed-int8 calibration, which a restored run
skips (its amaxes are the checkpoint's). ``run`` then starts at
``divmod(step, steps_per_epoch)``: the first ``skip`` batches of the
restored epoch are drawn and dropped, not trained, and every later step
draws the dropout seeds of ``(dropout_seed, step)``, so the resumed run is
the uninterrupted one. ``hf_checkpoint`` starts the model from an HF
checkpoint (``models/hf_loader.py``) before any split or shard.

Telemetry and faults (JAX ``train/loop.py``): the Trainer installs its
``MetricsRegistry`` as the default (the loader, the checkpointer, the
supervisor and the fault hooks record into it) and, with
``metrics_dir``, a ``JsonlSink`` whose ``run_meta`` header it writes at
the end of ``__init__``. With ``metrics_dir`` every step synchronizes on
the device and emits a ``step`` record (data wait, dispatch, device
block, loss; ``compile_inclusive`` on the first step, whose kernels
build); without it no synchronize is added. Each epoch record gains the
straggler stats (``telemetry/straggler.py``, gathered over the batch
group) and the registry's snapshot. The watchdog (``watchdog``) guards
every step but the first and the epoch's closing synchronize;
``GracefulShutdown`` (``handle_preemption``) wraps the epochs, and a
signal stops the run at the next step boundary with an emergency
checkpoint, joined, its submit and join timed against
``preempt_grace_s``, and ``Preempted`` (exit 75); a join that hangs
ends the process as a hung step does (the watchdog's exit 84). After each update the
``crash_at_step`` / ``crash_rank`` fault ends the process with
``os._exit(13)`` and the ``PDT_TPU_FAULT`` step faults fire. On a crash
the stream stays open (flushed to disk) for the supervisor's ``restart``
record; a clean run closes it.

Not ported here (ROADMAP.md, queue 1): runtime guards, the native loader
and prefetch, and chained steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_training_tpu_torch.comms.bootstrap import initialize
from pytorch_distributed_training_tpu_torch.comms.collectives import (
    host_sum_counts,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import (
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    AXIS_STAGE,
    batch_index,
    build_mesh,
    dp_degree,
    fsdp_device_mesh,
)
from pytorch_distributed_training_tpu_torch.data import synthetic
from pytorch_distributed_training_tpu_torch.data.glue import (
    eval_splits,
    load_task_arrays,
    resolve_task,
)
from pytorch_distributed_training_tpu_torch.data.pipeline import ShardedLoader
from pytorch_distributed_training_tpu_torch.faults.inject import get_plan
from pytorch_distributed_training_tpu_torch.faults.preemption import (
    GracefulShutdown,
    Preempted,
)
from pytorch_distributed_training_tpu_torch.faults.watchdog import (
    Watchdog,
    set_watchdog,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.branch import (
    BRANCH_MODULE,
    BranchEnsembleClassifier,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    is_quant_name,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.models.stage import BertStage
from pytorch_distributed_training_tpu_torch.parallel.pipeline import (
    SCHEDULES,
    check_micro_batch,
    make_pipeline_train_step,
)
from pytorch_distributed_training_tpu_torch.parallel.sharding import (
    ShardingPolicy,
    apply_fsdp,
    context_parallel,
    int8_groups,
    model_dims,
    param_specs,
    placements_of,
    tensor_parallel,
)
from pytorch_distributed_training_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    set_registry,
)
from pytorch_distributed_training_tpu_torch.telemetry.sink import (
    JsonlSink,
    run_metadata,
)
from pytorch_distributed_training_tpu_torch.telemetry.straggler import (
    epoch_straggler_stats,
)
from pytorch_distributed_training_tpu_torch.train.checkpoint import (
    Checkpointer,
)
from pytorch_distributed_training_tpu_torch.train.metrics import (
    LMMetricAccumulator,
    MetricAccumulator,
)
from pytorch_distributed_training_tpu_torch.train.optim import (
    AdamW,
    linear_warmup_schedule,
    plain_grad_norm,
    sharded_grad_norm,
)
from pytorch_distributed_training_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    calibrate_quant,
    lm_whole_rows,
    make_eval_step,
    make_train_step,
    quant_buffers,
)
from pytorch_distributed_training_tpu_torch.utils.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_training_tpu_torch.utils.device import resolve_device
from pytorch_distributed_training_tpu_torch.utils.logging import (
    log0,
    set_log_format,
)


# the mesh axis each model-parallel mode splits the model over
SPLIT_AXIS = {"branch": AXIS_MODEL, "stage": AXIS_STAGE,
              **{mode: AXIS_STAGE for mode in SCHEDULES}}
MP_MODES = (None, *SPLIT_AXIS)


class Trainer:
    def __init__(self, model_config: ModelConfig, train_config: TrainConfig,
                 *, task: str = "auto", device="cuda",
                 mesh_config: Optional[MeshConfig] = None,
                 mp_mode: Optional[str] = None,
                 model: Optional[Callable] = None,
                 policy: Optional[ShardingPolicy] = None,
                 n_micro=None, hf_checkpoint=None):
        tcfg = self.tcfg = train_config
        if mp_mode not in MP_MODES:
            raise ValueError(f"mp_mode must be one of {MP_MODES}, got "
                             f"{mp_mode!r}")
        if mp_mode is not None and model_config.causal:
            raise ValueError(f"mp_mode={mp_mode!r} splits an encoder "
                             f"classifier; the config is causal")
        if mp_mode is not None and model_config.scan_layers:
            raise ValueError(f"mp_mode={mp_mode!r} keeps per-layer modules; "
                             f"the config scans the trunk")
        # the mode's stacked axis, as the JAX CLI sets it
        split = SPLIT_AXIS.get(mp_mode)
        self.policy = dataclasses.replace(
            policy or ShardingPolicy(), branch=split == AXIS_MODEL,
            stage=split == AXIS_STAGE)
        self.info = initialize(resolve_device(device))
        self.device = self.info.device
        # telemetry first, so every layer records into this run's window
        set_log_format(tcfg.log_format)
        self.registry = MetricsRegistry()
        set_registry(self.registry)
        self.metrics_sink = None
        if tcfg.metrics_dir:
            self.metrics_sink = JsonlSink(tcfg.metrics_dir)
            self.registry.attach_sink(self.metrics_sink)
        self._first_step_done = False
        mesh = self.mesh = build_mesh(mesh_config, rank=self.info.rank,
                                      world_size=self.info.world_size)
        for mode, axis in SPLIT_AXIS.items():
            # with no mode, a model axis is tensor parallelism's (or
            # replicas that compute alike)
            if mesh.shape[axis] > 1 and axis != split and (
                    mp_mode is not None or axis != AXIS_MODEL):
                raise ValueError(
                    f"mesh axis {axis}={mesh.shape[axis]} needs "
                    f"mp_mode={mode!r} (got {mp_mode!r})")
        if mesh.shape[AXIS_SEQ] > 1:
            if model_config.attention_impl != "ring":
                raise ValueError(
                    f"mesh axis seq={mesh.shape[AXIS_SEQ]} cuts the "
                    f"sequence; attention_impl "
                    f"{model_config.attention_impl!r} attends within a "
                    f"shard: use 'ring'")
        # float32 matmuls and the float32 classifier stay float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        # ------------------------------------------------------------ data
        task = resolve_task(task)  # once, so both splits agree
        self.objective = "causal_lm" if task == "lm" else "classification"
        if (self.objective == "causal_lm") != bool(model_config.causal):
            raise ValueError(
                f"task {task!r} implies objective {self.objective!r} but the "
                f"model config has causal={model_config.causal} — use a "
                f"decoder preset (gpt2-*) with --task lm, an encoder preset "
                f"with classification tasks"
            )
        sizes = (tcfg.train_size or synthetic.MRPC_TRAIN_SIZE,
                 tcfg.eval_size or synthetic.MRPC_EVAL_SIZE)
        load = dict(max_length=tcfg.max_seq_length,
                    vocab_path=tcfg.vocab_path,
                    vocab_size=model_config.vocab_size, seed=tcfg.seed,
                    synthetic_sizes=sizes)
        train_data, num_labels = load_task_arrays(task, "train", **load)
        eval_datas = {suffix: load_task_arrays(task, split, **load)[0]
                      for suffix, split in eval_splits(task)}
        if tcfg.train_size:
            train_data = {k: v[:tcfg.train_size] for k, v in train_data.items()}
        if tcfg.eval_size:
            eval_datas = {s: {k: v[:tcfg.eval_size] for k, v in d.items()}
                          for s, d in eval_datas.items()}
        if num_labels:
            model_config = dataclasses.replace(model_config,
                                               num_labels=num_labels)
        self.mcfg = model_config
        # the ranks of one batch shard read the same rows, each seq rank
        # its columns (the LM's targets shifted on the whole rows first)
        shard = dict(seed=tcfg.seed, rank=batch_index(mesh),
                     world_size=dp_degree(mesh), device=self.device,
                     seq_index=mesh.coord(AXIS_SEQ),
                     seq_size=mesh.shape[AXIS_SEQ])
        if mesh.shape[AXIS_SEQ] > 1 and self.objective == "causal_lm":
            shard["whole_rows"] = lm_whole_rows
        self.schedule_mode = mp_mode if mp_mode in SCHEDULES else None
        self.n_micro = 1
        if self.schedule_mode:
            if n_micro is None:
                raise ValueError(f"mp_mode={mp_mode!r} needs n_micro")
            self.n_micro = n_micro(mesh) if callable(n_micro) else n_micro
            check_micro_batch(tcfg.micro_batch_size, self.n_micro,
                              dp_degree(mesh))
        self.train_loader = ShardedLoader(
            train_data, global_batch_size=tcfg.global_batch_size,
            grad_accum_steps=tcfg.grad_accum_steps * self.n_micro,
            train=True, **shard,
        )
        self.eval_loaders = {
            suffix: ShardedLoader(d, global_batch_size=tcfg.eval_batch_size,
                                  train=False, **shard)
            for suffix, d in eval_datas.items()
        }

        # ----------------------------------------------------------- model
        # made on the CPU from the seed, so every device starts alike
        if model is None and mp_mode == "branch":
            model = BranchEnsembleClassifier
        if model is not None:
            module = model(model_config, seed=tcfg.seed, mesh=mesh)
        else:
            model_cls = (GPT2LMModel if model_config.causal
                         else BertForSequenceClassification)
            module = model_cls(
                model_config,
                generator=torch.Generator().manual_seed(tcfg.seed))
        if hf_checkpoint is not None:
            from pytorch_distributed_training_tpu_torch.models import (
                hf_loader,
            )

            load = (hf_loader.load_gpt2_lm if model_config.causal
                    else hf_loader.load_bert_classifier)
            # the HF weights replace the parameters only: the delayed-int8
            # amaxes stay and are calibrated below, as JAX keeps its quant
            missing, unexpected = module.load_state_dict(
                load(hf_checkpoint, model_config), strict=False)
            missing = [n for n in missing if not is_quant_name(n)]
            if missing or unexpected:
                raise KeyError(f"{hf_checkpoint}: missing {missing[:5]}, "
                               f"unexpected {unexpected[:5]}")
        if split == AXIS_STAGE and mesh.shape[AXIS_STAGE] > 1:
            module = BertStage(module, mesh)
        self.split = split
        total_updates = self.train_loader.steps_per_epoch * tcfg.num_epochs
        self.schedule = linear_warmup_schedule(
            tcfg.learning_rate, tcfg.warmup_steps, total_updates
        )
        model = module.to(self.device)
        # the specs of the whole model, then this rank's TP slice of it
        specs = self.specs = param_specs(
            {n: tuple(p.shape) for n, p in model.named_parameters()},
            self.policy, mesh.shape)
        self.tp_split = set()
        if self.policy.tp and mesh.shape[AXIS_MODEL] > 1:
            self.tp_split = tensor_parallel(model, specs,
                                            mesh.shard(AXIS_MODEL))
        context_parallel(model, mesh.shard(AXIS_SEQ))
        int8_groups(model, mesh.grad_group)
        if self.policy.fsdp and mesh.shape[AXIS_FSDP] > 1:
            self.shard(placements_of(specs),
                       fsdp_device_mesh(mesh, self.device.type), model)
        else:
            self._make_state(model, sharded=False)
        self.eval_step = make_eval_step(self.objective, mesh)
        self.checkpointer = (
            Checkpointer(tcfg.checkpoint_dir, verify=tcfg.checkpoint_verify)
            if tcfg.checkpoint_dir else None)
        restored = False
        if (tcfg.resume and self.checkpointer
                and self.checkpointer.latest_step() is not None):
            self.checkpointer.restore(self.state)
            restored = True
        if quant_buffers(self.state.module) and not restored:
            micro0 = self.train_loader.first_micro(
                tcfg.global_batch_size // tcfg.grad_accum_steps)
            for _ in range(2):
                calibrate_quant(self.state, micro0, objective=self.objective,
                                loss_scale=1.0 / tcfg.grad_accum_steps,
                                mesh=mesh)
        self.history: list[dict] = []
        self.step_log: list[dict] = []
        self.registry.emit(run_metadata(
            mesh, self.device, self.mcfg, tcfg,
            steps_per_epoch=self.train_loader.steps_per_epoch,
            objective=self.objective))

    def shard(self, placements: dict, device_mesh, model=None) -> None:
        """Shard the model (``model``, else the state's) with FSDP on
        ``device_mesh`` by ``placements`` (``parallel/sharding.py``) and
        start its optimizer afresh. The Trainer calls it when the policy
        shards over an ``fsdp`` axis of more than one rank; a one-rank
        ``device_mesh`` runs the same collectives and optimizer on one
        card."""
        model = self.state.module if model is None else model
        self._make_state(apply_fsdp(model, placements, device_mesh),
                         sharded=True)

    def _make_state(self, model, *, sharded: bool) -> None:
        """The grad norm, optimizer, DDP (unless ``sharded``), train state
        and train step of ``model``."""
        tcfg, mesh, split = self.tcfg, self.mesh, self.split
        # the grad norm of a model split over ranks (the branches or the
        # TP slices over the model axis, every stage's parameters over the
        # stage axis) or sharded over fsdp
        grad_norm = plain_grad_norm
        if self.tp_split:
            split = AXIS_MODEL
        split_group = None if split is None else mesh.group(split)
        if split_group is not None or sharded:
            grad_norm = sharded_grad_norm(
                {id(p) for name, p in model.named_parameters()
                 if split_group is not None and (
                     split == AXIS_STAGE or name.startswith(BRANCH_MODULE)
                     or name in self.tp_split)},
                split_group, mesh.group(AXIS_FSDP))
        optimizer = AdamW(
            model.parameters(), self.schedule, b1=tcfg.adam_b1,
            b2=tcfg.adam_b2, eps=tcfg.adam_eps,
            weight_decay=tcfg.weight_decay, max_grad_norm=tcfg.max_grad_norm,
            grad_norm=grad_norm,
        )
        wrapped = None
        if (not sharded and not self.schedule_mode
                and mesh.grad_group is not None):
            # DDP over this rank's batch and seq shards only: the ranks of
            # another model or stage coordinate hold other weights
            wrapped = DistributedDataParallel(
                model,
                device_ids=[self.device.index] if self.device.type == "cuda"
                else None,
                process_group=mesh.grad_group,
                broadcast_buffers=False,
            )
        self.state = create_train_state(model, optimizer, tcfg.seed,
                                        wrapped=wrapped)
        if self.tp_split:
            self.state.tp = (model_dims(self.specs), mesh.shard(AXIS_MODEL))
        if self.schedule_mode:
            self.train_step = make_pipeline_train_step(
                self.mcfg, mesh, schedule=self.schedule_mode,
                n_micro=self.n_micro, grad_accum_steps=tcfg.grad_accum_steps,
                grad_norm=grad_norm)
        else:
            self.train_step = make_train_step(
                grad_accum_steps=tcfg.grad_accum_steps,
                objective=self.objective, mesh=mesh, grad_norm=grad_norm,
            )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> list[dict]:
        cfg = self.tcfg
        spe = self.train_loader.steps_per_epoch
        # mid-epoch resume: the loader's epoch order comes from (seed,
        # epoch), so dropping the restored epoch's first `skip` batches
        # continues the same data and schedule
        start_epoch, skip = divmod(self.state.step, max(spe, 1))
        log0(f"training: {cfg.num_epochs} epochs x {spe} updates (global "
             f"batch {cfg.global_batch_size} = {cfg.grad_accum_steps} x "
             f"{cfg.global_batch_size // cfg.grad_accum_steps}"
             + (f" in {self.n_micro} pipeline microbatches"
                if self.schedule_mode else "") + "), "
             f"{self.info.world_size} process(es) on {self.device}, mesh "
             f"{self.mesh.shape}"
             + (f", from step {self.state.step}" if self.state.step else ""))
        set_registry(self.registry)  # layers record into this run's window
        self.watchdog = Watchdog(
            stall_factor=cfg.watchdog_stall_factor,
            min_stall_s=cfg.watchdog_min_stall_s,
            hard_timeout_s=cfg.watchdog_hard_timeout_s,
        ) if cfg.watchdog else None
        prev_watchdog = set_watchdog(self.watchdog)
        # the handlers only set a flag; the step loop notices it at the
        # next boundary and leaves through _preempt_exit
        self._shutdown = (GracefulShutdown().install()
                          if cfg.handle_preemption else None)
        try:
            for epoch in range(start_epoch, cfg.num_epochs):
                self._run_epoch(epoch, skip if epoch == start_epoch else 0)
        finally:
            if self._shutdown is not None:
                self._shutdown.uninstall()
            set_watchdog(prev_watchdog)
            if self.watchdog is not None:
                self.watchdog.close()
            if self.checkpointer:
                self.checkpointer.close()
            # a crash leaves the stream open (the supervisor's restart and
            # the next attempt append to it), pushed to disk
            if self.metrics_sink is not None:
                self.metrics_sink.flush(fsync=True)
        if self.metrics_sink is not None:
            self.metrics_sink.close()
        return self.history

    def _guard(self, what: str, step: int):
        """The watchdog's guard of a section, or nothing."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.guard(what, step=step)

    def _preempt_exit(self, signum: int, step: int) -> None:
        """A shutdown signal arrived: save inside the grace window, record
        the preemption and leave resumable (``Preempted``, exit 75)."""
        cfg = self.tcfg
        t0 = time.perf_counter()
        saved_step = None
        if self.checkpointer is not None:
            # a step saved just before (a periodic save) is skipped there;
            # the join commits and seals it before the exit
            self.checkpointer.save(self.state)
            self.checkpointer.wait()
            saved_step = self.state.step
        save_wall_s = time.perf_counter() - t0
        if save_wall_s > cfg.preempt_grace_s:
            log0(f"emergency checkpoint took {save_wall_s:.1f}s, over the "
                 f"{cfg.preempt_grace_s:.0f}s grace window: the checkpoint "
                 f"landed but the cluster may have killed peers; consider "
                 f"more frequent periodic saves")
        self.registry.inc("preemptions")
        self.registry.emit({
            "record": "preemption", "signal": signum, "step": step,
            "saved_step": saved_step, "save_wall_s": save_wall_s,
            "grace_s": cfg.preempt_grace_s,
        })
        if self.metrics_sink is not None:
            self.metrics_sink.flush(fsync=True)
        log0(f"preempted at step {step}: emergency checkpoint "
             + (f"at step {saved_step}" if saved_step is not None
                else "skipped (no checkpoint_dir)") + ", exiting resumable")
        raise Preempted(signum, step=step)

    def _crash(self, step: int) -> None:
        """``crash_at_step``: die like a killed host, after the last
        periodic save has committed (joined here, as JAX's: the fault is a
        crash after a checkpoint, not a torn write): no Python cleanup, no
        flush."""
        self._sync()
        if self.checkpointer:
            self.checkpointer.wait()
        # a plain print: log0 is rank-0-gated and the crashing rank is
        # often another
        print(f"injected crash at step {step} (rank {self.info.rank})",
              flush=True)
        os._exit(13)

    def _run_epoch(self, epoch: int, skip: int) -> None:
        cfg = self.tcfg
        reg = self.registry
        # per-step records synchronize on the device so the device block
        # is device time; without them no synchronize is added
        per_step = bool(cfg.metrics_dir)
        self._sync()
        t0 = time.perf_counter()
        metrics = []
        step_times: list[float] = []
        data_waits: list[float] = []
        t_prev = time.perf_counter()
        for i, batch in enumerate(self.train_loader.epoch(epoch)):
            if self._shutdown is not None and self._shutdown.requested:
                self._preempt_exit(self._shutdown.requested, self.state.step)
            t_batch = time.perf_counter()
            data_wait = t_batch - t_prev
            if i < skip:
                t_prev = time.perf_counter()
                continue
            first = not self._first_step_done
            # the first step (its kernels build) is exempt: not a hang
            with (contextlib.nullcontext() if first else
                  self._guard("train_step", self.state.step + 1)):
                metrics.append(self.train_step(self.state, batch))
                self._first_step_done = True
                t_dispatched = time.perf_counter()
                if per_step:
                    self._sync()
            t_done = time.perf_counter()
            step = self.state.step
            step_times.append(t_done - t_prev)
            data_waits.append(data_wait)
            reg.observe("train/data_wait_s", data_wait)
            loss_host = None
            if per_step:
                reg.observe("train/dispatch_s", t_dispatched - t_batch)
                reg.observe("train/device_block_s", t_done - t_dispatched)
                reg.observe("train/step_s", t_done - t_prev)
                loss_host = float(metrics[-1]["loss"])
                reg.emit({
                    "record": "step", "epoch": epoch, "step": step,
                    "data_wait_s": data_wait,
                    "dispatch_s": t_dispatched - t_batch,
                    "device_block_s": t_done - t_dispatched,
                    "step_s": t_done - t_prev, "loss": loss_host,
                    "compile_inclusive": first,
                })
            if cfg.log_every and step % cfg.log_every == 0:
                if loss_host is None:
                    loss_host = float(metrics[-1]["loss"])
                log0(f"step {step}: loss={loss_host:.4f} "
                     f"lr={self.schedule(step - 1):.2e}")
            if (self.checkpointer and cfg.checkpoint_every_steps
                    and step % cfg.checkpoint_every_steps == 0):
                self.checkpointer.save(self.state)
            if (cfg.crash_at_step and step == cfg.crash_at_step
                    and self.info.rank == cfg.crash_rank):
                self._crash(step)
            # PDT_TPU_FAULT's step faults: InjectedCrash (the supervisor
            # retries), a SIGTERM to this process (the preemption path) or
            # a hang (the watchdog's)
            get_plan().fire_step_fault(step)
            t_prev = time.perf_counter()
        with self._guard("epoch_block", self.state.step):
            # without per-step syncs a wedged device shows here
            self._sync()
        train_time = time.perf_counter() - t0
        host = self._log_steps(metrics)
        # every rank of the batch group gives its step times; rank 0's
        # record names the slowest (a collective, once an epoch)
        straggler = epoch_straggler_stats(
            step_times, data_waits, group=self.mesh.batch_group,
            device=self.device)
        samples = cfg.global_batch_size * len(metrics)
        t_eval = time.perf_counter()
        record = {
            "epoch": epoch,
            "train_loss": (float(np.mean([h[0] for h in host]))
                           if host else float("nan")),
            "samples_per_sec": samples / train_time,
            "samples_per_sec_per_chip":
                samples / train_time / self.info.world_size,
            **self.evaluate(),
        }
        reg.observe("eval/wall_s", time.perf_counter() - t_eval)
        self.history.append(record)
        log0(f"epoch {epoch}: {record}")
        if self.checkpointer:
            self.checkpointer.save(self.state)
        # the epoch record last, so the save and the eval land inside this
        # epoch's window
        reg.emit({"record": "epoch", **record, "train_wall_s": train_time,
                  "straggler": straggler,
                  "telemetry": reg.snapshot(reset=True)})

    def _log_steps(self, metrics: list[dict]) -> list[list[float]]:
        """Append the epoch's steps to ``step_log``, fetching every step's
        (loss, grad_norm) from the device in one host transfer."""
        if not metrics:
            return []
        host = torch.stack([torch.stack([m["loss"], m["grad_norm"]])
                            for m in metrics]).cpu().tolist()
        first = self.state.step - len(host)
        bubble = ({"pipeline_bubble": metrics[0]["pipeline_bubble"]}
                  if "pipeline_bubble" in metrics[0] else {})
        self.step_log += [dict(step=first + i + 1, loss=loss, grad_norm=norm,
                               **bubble)
                          for i, (loss, norm) in enumerate(host)]
        return host

    @property
    def eval_loader(self) -> ShardedLoader:
        """The primary eval split's loader."""
        return next(iter(self.eval_loaders.values()))

    def evaluate(self) -> dict:
        """Counts summed on the device per split, then over the ranks in
        one all-reduce; metrics as the JAX trainer names them (MNLI's
        second split suffixed)."""
        out = {}
        for suffix, loader in self.eval_loaders.items():
            acc = (LMMetricAccumulator() if self.objective == "causal_lm"
                   else MetricAccumulator(self.mcfg.num_labels))
            totals = None
            for batch in loader.epoch():
                counts = self.eval_step(self.state, batch)
                totals = counts if totals is None else {
                    k: totals[k] + counts[k] for k in counts
                }
            if totals is not None:
                # the counts live on the last stage, in parts over the seq
                # shards; each batch shard's model ranks hold the same ones
                acc.update(host_sum_counts(totals, (
                    self.mesh.group(AXIS_STAGE), self.mesh.group(AXIS_SEQ),
                    self.mesh.batch_group)))
            raw = acc.compute()
            if not out and suffix:
                out.update(raw)
            out.update({f"{k}_{suffix}": v for k, v in raw.items()}
                       if suffix else raw)
        return out
