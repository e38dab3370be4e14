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
