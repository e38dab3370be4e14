"""The Trainer: data, model, optimizer, DDP, epochs, eval and the metric
history (counterpart: the JAX package's ``train/loop.py`` ``Trainer``, its
data-parallel classification and causal-LM paths).

The task picks the objective, as in the JAX trainer: ``lm`` trains a
causal preset (``GPT2LMModel``) on next-token cross-entropy
(``"causal_lm"``), every other task an encoder preset
(``BertForSequenceClassification``) on classification; a preset whose
``causal`` disagrees raises.

Per epoch: every optimizer step over ``[accum, micro, ...]`` batches, then
a masked eval pass over the whole validation split and one history record
with the JAX trainer's keys (``epoch``, ``train_loss``,
``samples_per_sec``, ``samples_per_sec_per_chip``, then the eval metrics:
``accuracy`` and, for binary tasks, ``f1``; for ``lm``, ``eval_loss``,
``perplexity`` and ``token_accuracy``). ``step_log`` keeps each step's
loss and grad norm, fetched from the device once per epoch.

Not ported here (ROADMAP.md, queue 1): checkpoints and resume, the
watchdog, preemption handling, telemetry sinks, runtime guards, the
native loader and prefetch, chained steps, FSDP and the mesh flags.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from pytorch_distributed_training_tpu_torch.comms.bootstrap import initialize
from pytorch_distributed_training_tpu_torch.comms.collectives import (
    host_sum_counts,
)
from pytorch_distributed_training_tpu_torch.data import synthetic
from pytorch_distributed_training_tpu_torch.data.glue import (
    eval_splits,
    load_task_arrays,
    resolve_task,
)
from pytorch_distributed_training_tpu_torch.data.pipeline import ShardedLoader
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.train.metrics import (
    LMMetricAccumulator,
    MetricAccumulator,
)
from pytorch_distributed_training_tpu_torch.train.optim import (
    AdamW,
    linear_warmup_schedule,
)
from pytorch_distributed_training_tpu_torch.train.state import (
    create_train_state,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
)
from pytorch_distributed_training_tpu_torch.utils.config import (
    ModelConfig,
    TrainConfig,
)
from pytorch_distributed_training_tpu_torch.utils.device import resolve_device
from pytorch_distributed_training_tpu_torch.utils.logging import log0


class Trainer:
    def __init__(self, model_config: ModelConfig, train_config: TrainConfig,
                 *, task: str = "auto", device="cuda"):
        tcfg = self.tcfg = train_config
        self.info = initialize(resolve_device(device))
        self.device = self.info.device
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
        shard = dict(seed=tcfg.seed, rank=self.info.rank,
                     world_size=self.info.world_size, device=self.device)
        self.train_loader = ShardedLoader(
            train_data, global_batch_size=tcfg.global_batch_size,
            grad_accum_steps=tcfg.grad_accum_steps, train=True, **shard,
        )
        self.eval_loaders = {
            suffix: ShardedLoader(d, global_batch_size=tcfg.eval_batch_size,
                                  train=False, **shard)
            for suffix, d in eval_datas.items()
        }

        # ----------------------------------------------------------- model
        # made on the CPU from the seed, so every device starts alike
        model_cls = (GPT2LMModel if model_config.causal
                     else BertForSequenceClassification)
        model = model_cls(
            model_config, generator=torch.Generator().manual_seed(tcfg.seed),
        ).to(self.device)
        total_updates = self.train_loader.steps_per_epoch * tcfg.num_epochs
        self.schedule = linear_warmup_schedule(
            tcfg.learning_rate, tcfg.warmup_steps, total_updates
        )
        optimizer = AdamW(
            model.parameters(), self.schedule, b1=tcfg.adam_b1,
            b2=tcfg.adam_b2, eps=tcfg.adam_eps,
            weight_decay=tcfg.weight_decay, max_grad_norm=tcfg.max_grad_norm,
        )
        wrapped = None
        if self.info.world_size > 1:
            wrapped = DistributedDataParallel(
                model,
                device_ids=[self.device.index] if self.device.type == "cuda"
                else None,
            )
        self.state = create_train_state(model, optimizer, tcfg.seed,
                                        wrapped=wrapped)
        self.train_step = make_train_step(
            grad_accum_steps=tcfg.grad_accum_steps, rank=self.info.rank,
            objective=self.objective,
        )
        self.eval_step = make_eval_step(self.objective)
        self.history: list[dict] = []
        self.step_log: list[dict] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> list[dict]:
        cfg = self.tcfg
        spe = self.train_loader.steps_per_epoch
        log0(f"training: {cfg.num_epochs} epochs x {spe} updates (global "
             f"batch {cfg.global_batch_size} = {cfg.grad_accum_steps} x "
             f"{cfg.global_batch_size // cfg.grad_accum_steps}), "
             f"{self.info.world_size} process(es) on {self.device}")
        for epoch in range(cfg.num_epochs):
            self._sync()
            t0 = time.perf_counter()
            metrics = []
            for batch in self.train_loader.epoch(epoch):
                metrics.append(self.train_step(self.state, batch))
                step = self.state.step
                if cfg.log_every and step % cfg.log_every == 0:
                    log0(f"step {step}: loss={float(metrics[-1]['loss']):.4f} "
                         f"lr={self.schedule(step - 1):.2e}")
            self._sync()
            train_time = time.perf_counter() - t0
            host = self._log_steps(metrics)
            samples = cfg.global_batch_size * len(metrics)
            record = {
                "epoch": epoch,
                "train_loss": (float(np.mean([h[0] for h in host]))
                               if host else float("nan")),
                "samples_per_sec": samples / train_time,
                "samples_per_sec_per_chip":
                    samples / train_time / self.info.world_size,
                **self.evaluate(),
            }
            self.history.append(record)
            log0(f"epoch {epoch}: {record}")
        return self.history

    def _log_steps(self, metrics: list[dict]) -> list[list[float]]:
        """Append the epoch's steps to ``step_log``, fetching every step's
        (loss, grad_norm) from the device in one host transfer."""
        if not metrics:
            return []
        host = torch.stack([torch.stack([m["loss"], m["grad_norm"]])
                            for m in metrics]).cpu().tolist()
        first = self.state.step - len(host)
        self.step_log += [dict(step=first + i + 1, loss=loss, grad_norm=norm)
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
                acc.update(host_sum_counts(totals))
            raw = acc.compute()
            if not out and suffix:
                out.update(raw)
            out.update({f"{k}_{suffix}": v for k, v in raw.items()}
                       if suffix else raw)
        return out
