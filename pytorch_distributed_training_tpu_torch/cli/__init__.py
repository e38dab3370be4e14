"""The port's entry points, and what the trainers share (counterpart: the
JAX package's ``cli/__init__.py``)."""

NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1, slice 5 item {})"


def resolve_attention(attention, mesh_seq: int) -> dict:
    """The JAX CLIs' rule: an explicit ``--attention`` wins, else ring
    attention when a context-parallel mesh is asked for, else the preset's;
    a ``model_preset`` override dict."""
    attention = attention or ("ring" if mesh_seq > 1 else None)
    return {"attention_impl": attention} if attention else {}


def raise_not_ported(checks) -> None:
    """``checks``: (asked, flag, slice 5 item) triples; the first asked
    raises ``NotImplementedError`` naming its ROADMAP item."""
    for asked, flag, item in checks:
        if asked:
            raise NotImplementedError(f"{flag} {NOT_PORTED.format(item)}")


def parallel_checks(args) -> tuple:
    """Tensor and context parallelism (slice 5 item 4), from whichever of
    ``--tp``, ``--mesh-model``, ``--mesh-seq`` and ``--attention`` the
    parser has (``--mesh-model`` only where no model-parallel mode takes
    it)."""
    tp = getattr(args, "tp", False)
    model = getattr(args, "mesh_model", 1)
    return (
        (tp, "--tp", 4),
        (model > 1, f"--mesh-model {model}", 4),
        (args.mesh_seq > 1, f"--mesh-seq {args.mesh_seq}", 4),
        (args.attention == "ring", "--attention ring", 4),
    )
