"""The port's entry points, and what the trainers share (counterpart: the
JAX package's ``cli/__init__.py``)."""

import argparse
import dataclasses

def resolve_attention(attention, mesh_seq: int) -> dict:
    """The JAX CLIs' rule: an explicit ``--attention`` wins, else ring
    attention when a context-parallel mesh is asked for, else the preset's;
    a ``model_preset`` override dict."""
    attention = attention or ("ring" if mesh_seq > 1 else None)
    return {"attention_impl": attention} if attention else {}


def add_quant_args(p, *, delayed: bool = True,
                   delayed_grads: bool = True) -> None:
    """The JAX CLIs' int8-matmul flags (``train_dp`` all three,
    ``train_mp`` no ``--quant-delayed-grads``, ``train_lm``
    ``--matmul-impl`` only)."""
    p.add_argument("--matmul-impl", default="native",
                   choices=("native", "int8", "int8_full"),
                   help="dense-matmul path (ops/quant.py): int8 runs the "
                        "int8 x int8 -> int32 products with dynamic "
                        "quantization; int8_full the backward's too")
    if delayed:
        p.add_argument("--quant-delayed",
                       action=argparse.BooleanOptionalAction, default=False,
                       help="delayed (previous-microbatch) int8 activation "
                            "scaling: amaxes carried in the model, "
                            "calibrated on the first batch (ops/quant.py)")
    if delayed_grads:
        p.add_argument("--quant-delayed-grads",
                       action=argparse.BooleanOptionalAction, default=False,
                       help="extend delayed scaling to the backward's dy "
                            "quantization (int8_full only)")


def quant_overrides(args) -> dict:
    """The JAX CLIs' checks of the int8 flags (``SystemExit``), then the
    ``model_preset`` overrides they ask for."""
    delayed = getattr(args, "quant_delayed", False)
    delayed_grads = getattr(args, "quant_delayed_grads", False)
    if delayed and args.matmul_impl == "native":
        raise SystemExit(
            "--quant-delayed requires --matmul-impl int8|int8_full")
    if delayed_grads and not (delayed and args.matmul_impl == "int8_full"):
        raise SystemExit(
            "--quant-delayed-grads requires --quant-delayed and "
            "--matmul-impl int8_full")
    return dict(matmul_impl=args.matmul_impl, quant_delayed=delayed,
                quant_delayed_grads=delayed_grads)


def add_restart_args(parser) -> None:
    """The supervised-restart flags every train entry point shares."""
    parser.add_argument(
        "--max-restarts", type=int, default=0,
        help="restart-from-checkpoint attempts after a crash (needs "
             "--checkpoint-dir; sets resume on retries). A graceful "
             "preemption (SIGTERM -> emergency checkpoint, exit 75) never "
             "spends one of these.")
    parser.add_argument(
        "--restart-window-s", type=float, default=0.0,
        help="make the restart budget sliding: --max-restarts within this "
             "many seconds (older restarts expire). 0 = lifetime budget.")


def run_supervised(args, tcfg, build_trainer):
    """Check the restart and resume flags (``SystemExit``, JAX's messages)
    and run ``build_trainer(cfg)`` under ``run_with_restarts``: each
    attempt builds a Trainer from ``cfg`` (``resume`` on retries) and runs
    it; the trainer of the attempt that finished."""
    from pytorch_distributed_training_tpu_torch.utils.supervisor import (
        run_with_restarts,
    )

    if args.max_restarts and not tcfg.checkpoint_dir:
        raise SystemExit("--max-restarts needs --checkpoint-dir to resume "
                         "from")
    if args.max_restarts and not tcfg.resume:
        # a retry resumes from the latest checkpoint there: one an older
        # run left would continue that run's trajectory, not this one's
        from pytorch_distributed_training_tpu_torch.train.checkpoint import (
            latest_step,
        )

        if latest_step(tcfg.checkpoint_dir) is not None:
            raise SystemExit(
                f"checkpoint dir {tcfg.checkpoint_dir!r} already holds a "
                f"checkpoint; pass --resume to continue it or point "
                f"--checkpoint-dir at a fresh directory")

    def attempt(i: int):
        trainer = build_trainer(
            dataclasses.replace(tcfg, resume=tcfg.resume or i > 0))
        trainer.run()
        return trainer

    return run_with_restarts(
        attempt, max_restarts=args.max_restarts,
        restart_window_s=args.restart_window_s,
        checkpoint_dir=tcfg.checkpoint_dir if args.max_restarts else None)
