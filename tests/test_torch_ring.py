"""Port parity, context parallelism over the mesh's ``seq`` axis: the
PyTorch package's ring attention (``ops/ring_attention.py``) driven in one
process and over 4 gloo processes against the JAX package's
``reference_attention`` (JAX ``tests/test_ring_attention.py:40-112``:
forward, gradients, JAX's fallbacks), its probabilities' dropout, BERT
through ``train_dp`` at (data 2, seq 2) against one process and the JAX
package's data-parallel step on the same rows (JAX ``:115-189``), GPT-2
through ``train_lm`` at fsdp 2 × seq 2 and model 2 × seq 2 (with ``--tp``)
against one process, and the CLIs' attention rule and mesh errors against
the JAX CLIs', on the CPU (the gloo harness of ``tests/test_torch_tp.py``).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.cli import (
    resolve_attention as jax_resolve_attention,
)
from pytorch_distributed_training_tpu.ops.attention import (
    make_attention_bias as jax_make_attention_bias,
)
from pytorch_distributed_training_tpu.ops.attention import (
    reference_attention as jax_reference_attention,
)
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu_torch.cli import (
    resolve_attention,
    train_dp,
    train_lm,
    train_mp,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import AxisShard
from pytorch_distributed_training_tpu_torch.data.pipeline import ShardedLoader
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
)
from pytorch_distributed_training_tpu_torch.ops import ring_attention as ring
from pytorch_distributed_training_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_bias,
    reference_attention,
)
from pytorch_distributed_training_tpu_torch.ops.dropout import (
    fold_in,
    keep_mask,
)
from pytorch_distributed_training_tpu_torch.train.step import (
    lm_shift_and_mask,
    lm_whole_rows,
)
from test_torch_tp import (
    BERT,
    LM,
    REPO,
    _jax_steps,
    _launch,
    _nest,
    assert_same_run,
    lm_spec,
)

torch.set_num_threads(2)

B, S, N, D = 4, 32, 2, 8


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, N, D)).astype(np.float32)
            for _ in range(3)]


def _mask():
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0  # padding across shard boundaries
    mask[3, 5:] = 0
    return mask


def _jax_forward_and_grads(q, k, v, mask, causal, cot):
    """JAX ``reference_attention``: the output with the padding bias, and
    the q/k/v gradients of sum(out * cot) without it, as the JAX ring
    tests take them."""
    bias = jax_make_attention_bias(jnp.asarray(mask))
    out = jax_reference_attention(*map(jnp.asarray, (q, k, v)), bias,
                                  causal=causal)
    grads = jax.grad(lambda q, k, v: jnp.sum(jax_reference_attention(
        q, k, v, None, causal=causal) * cot), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_matches_jax(out, grads, want, want_grads, mask):
    for b in range(B):  # padded query rows are garbage in both
        n = int(mask[b].sum())
        np.testing.assert_allclose(out[b, :n], want[b, :n], atol=1e-5,
                                   rtol=1e-5)
    for g, w, name in zip(grads, want_grads, "qkv"):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_in_one_process_matches_jax_reference(causal, n_shards):
    q, k, v = _qkv()
    mask = _mask()
    cot = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    want, want_grads = _jax_forward_and_grads(q, k, v, mask, causal, cot)
    bias = make_attention_bias(torch.from_numpy(mask))
    out = ring.ring_attention(*map(torch.from_numpy, (q, k, v)), bias,
                              n_shards=n_shards, causal=causal)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    (ring.ring_attention(*leaves, n_shards=n_shards, causal=causal)
     * torch.from_numpy(cot)).sum().backward()
    _assert_matches_jax(out.numpy(), [t.grad.numpy() for t in leaves],
                        want, want_grads, mask)


_RING_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from pytorch_distributed_training_tpu_torch.comms.bootstrap import (
        initialize, shutdown)
    from pytorch_distributed_training_tpu_torch.comms.mesh import build_mesh
    from pytorch_distributed_training_tpu_torch.ops.attention import (
        dot_product_attention, make_attention_bias)
    from pytorch_distributed_training_tpu_torch.utils.config import (
        MeshConfig)
    out = sys.argv[1]
    info = initialize(torch.device("cpu"))
    mesh = build_mesh(MeshConfig(data=1, seq=info.world_size),
                      rank=info.rank, world_size=info.world_size)
    seq = mesh.shard("seq")
    arrays = dict(np.load(sys.argv[2]))
    cols = arrays["q"].shape[1] // seq.size
    def mine(a):
        return torch.from_numpy(a[:, seq.index * cols:
                                  (seq.index + 1) * cols].copy())
    bias = make_attention_bias(mine(arrays["mask"]))
    res = {"groups": np.array(seq.ranks)}
    for causal in (False, True):
        leaves = [mine(arrays[k]).requires_grad_() for k in "qkv"]
        res[f"out{int(causal)}"] = dot_product_attention(
            *leaves, bias, impl="ring", causal=causal, seq=seq
        ).detach().numpy()
        (dot_product_attention(*leaves, impl="ring", causal=causal,
                               seq=seq) * mine(arrays["cot"])).sum(
        ).backward()
        for k, t in zip("qkv", leaves):
            res[f"d{k}{int(causal)}"] = t.grad.numpy()
    np.savez(f"{out}.{info.rank}.npz", **res)
    shutdown()
""")


def test_ring_over_gloo_matches_jax_reference(tmp_path):
    # seq 4 over 4 processes: each holds 8 of the 32 columns; the K/V
    # blocks and the bias hop, the K/V gradients hop back
    from test_torch_tp import _free_port

    q, k, v = _qkv(seed=1)
    mask = _mask()
    cot = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, mask=mask, cot=cot)
    base = dict(os.environ, CUDA_VISIBLE_DEVICES="", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), GLOO_SOCKET_IFNAME="lo",
                PYTHONPATH=REPO, OMP_NUM_THREADS="1", WORLD_SIZE="4")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RING_SCRIPT, str(tmp_path / "ring"),
         str(tmp_path / "in.npz")], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r))) for r in range(4)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    parts = [dict(np.load(tmp_path / f"ring.{r}.npz")) for r in range(4)]
    assert all(list(p["groups"]) == [0, 1, 2, 3] for p in parts)
    for causal in (0, 1):
        want, want_grads = _jax_forward_and_grads(q, k, v, mask, causal, cot)

        def whole(key):
            return np.concatenate([p[f"{key}{causal}"] for p in parts], 1)

        _assert_matches_jax(whole("out"), [whole(f"d{n}") for n in "qkv"],
                            want, want_grads, mask)


@pytest.mark.parametrize("case", ["one-shard", "full-bias", "ragged"])
def test_ring_falls_back_as_jax(case):
    # JAX's three fallbacks: one shard, a bias not of the key-padding
    # form, a length the shards do not divide
    q, k, v = (torch.from_numpy(t) for t in _qkv(seed=4))
    bias, n = None, 4
    if case == "one-shard":
        n = 1
    elif case == "full-bias":
        bias = torch.randn(B, 1, S, S, generator=torch.Generator()
                           .manual_seed(0))
    else:
        q, k, v = (t[:, :30] for t in (q, k, v))
    got = ring.ring_attention(q, k, v, bias, n_shards=n, causal=True)
    assert torch.equal(got, reference_attention(q, k, v, bias, causal=True))
    want = jax_reference_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)),
        None if bias is None else jnp.asarray(bias.numpy()), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_ring_shard_without_seq_axis_and_bad_bias():
    # dot_product_attention("ring") at a seq axis of one rank is the
    # reference (JAX's first fallback); with the sequence cut, a bias other
    # than the key-padding form has no whole sequence to fall back to
    q, k, v = (torch.from_numpy(t) for t in _qkv(seed=5))
    bias = make_attention_bias(torch.from_numpy(_mask()))
    for causal in (False, True):
        assert torch.equal(
            dot_product_attention(q, k, v, bias, impl="ring", causal=causal,
                                  dropout_rate=0.1, dropout_seed=3),
            reference_attention(q, k, v, bias, causal=causal,
                                dropout_rate=0.1, dropout_seed=3))
    shard = AxisShard(group=None, index=0, size=2, ranks=(0, 1))
    with pytest.raises(ValueError, match="key-padding bias"):
        ring.ring_attention_shard(q, k, v, torch.zeros(B, 1, S, S),
                                  seq=shard)


def test_ring_dropout_per_hop_masks(monkeypatch):
    # rate 0.1: finite, alike at one seed, unlike the deterministic output;
    # rate 0 with a seed is deterministic; step j of shard my draws from
    # fold_in(fold_in(seed, j), my), so every (hop, shard) block has a mask
    # of its own
    q, k, v = (torch.from_numpy(t) for t in _qkv(seed=6))
    seeds = []
    plain = ring.raw_dropout

    def recorded(x, rate, seed, site=0, impl="kernel"):
        seeds.append((seed, site, tuple(x.shape)))
        return plain(x, rate, seed, site, impl)

    monkeypatch.setattr(ring, "raw_dropout", recorded)
    kw = dict(n_shards=4, causal=True, dropout_site=2)
    det = ring.ring_attention(q, k, v, **kw)
    a = ring.ring_attention(q, k, v, dropout_rate=0.1, dropout_seed=9, **kw)
    b = ring.ring_attention(q, k, v, dropout_rate=0.1, dropout_seed=9, **kw)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.allclose(a, det)
    assert torch.equal(ring.ring_attention(q, k, v, dropout_rate=0.0,
                                           dropout_seed=9, **kw), det)
    want = [(fold_in(fold_in(9, j), my), 2, (B, N, S // 4, S // 4))
            for my in range(4) for j in range(4)]
    assert seeds == want * 2
    masks = {keep_mask((B, N, 8, 8), 0.1, s, 2).numpy().tobytes()
             for s, _, _ in want}
    assert len(masks) == 16


def test_loader_cuts_columns_after_whole_row_targets():
    # each seq rank keeps its columns of every [.., batch, S] leaf; the
    # labels and the whole-row target counts stay whole; the LM targets
    # are shifted on the whole row, so a shard's last column keeps its
    # target; a length the axis does not divide raises
    rng = np.random.default_rng(0)
    data = {"input_ids": rng.integers(0, 99, (8, 12)).astype(np.int32),
            "attention_mask": np.ones((8, 12), np.int32),
            "labels": rng.integers(0, 2, 8).astype(np.int32)}
    kw = dict(global_batch_size=4, grad_accum_steps=2, seed=1)
    whole = next(iter(ShardedLoader(data, **kw).epoch(0)))
    parts = [next(iter(ShardedLoader(data, seq_index=i, seq_size=3,
                                     whole_rows=lm_whole_rows, **kw)
                       .epoch(0))) for i in range(3)]
    targets, mask = lm_shift_and_mask(whole)
    for i, part in enumerate(parts):
        cols = slice(4 * i, 4 * i + 4)
        for key in ("input_ids", "attention_mask"):
            assert torch.equal(part[key], whole[key][..., cols])
        assert torch.equal(part["labels"], whole["labels"])
        assert torch.equal(part["lm_targets"], targets[..., cols])
        assert torch.equal(part["lm_mask"], mask[..., cols])
        assert torch.equal(part["lm_count"], mask.sum(-1))
    assert parts[0]["lm_mask"][..., -1].eq(1).all()
    with pytest.raises(ValueError, match="not divisible by the seq axis"):
        ShardedLoader(data, seq_size=5, **kw)


# ------------------------------------------------------ context parallel


def test_bert_train_dp_data2_seq2_equals_one_process_and_jax(tmp_path):
    # train_dp --mesh-seq 2 over 4 ranks: data 2 x seq 2, ring attention
    # by the JAX CLI rule, the CLS row from seq shard 0, dropout off
    argv = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
            "--train-size", "32", "--eval-size", "24",
            "--global-batch-size", "16", "--micro-batch-size", "8",
            "--eval-batch-size", "8", "--num-epochs", "1", "--log-every",
            "0", "--no-bf16", "--warmup-steps", "1", "--learning-rate",
            "1e-3", "--max-grad-norm", str(BERT["train"]["max_grad_norm"])]
    spec = dict(cli="train_dp", dropout=0.0)
    res = _launch(tmp_path, {
        "one": (1, dict(spec, argv=argv)),
        "cp": (4, dict(spec, argv=argv + ["--mesh-seq", "2"])),
    })
    cp = res["cp"]
    assert_same_run(cp, res["one"], rtol=1e-5, atol=1e-5)
    assert [(r["coords"]["data"], r["coords"]["seq"]) for r in cp["recs"]] \
        == [(0, 0), (0, 1), (1, 0), (1, 1)]
    losses, want = _jax_steps()
    for s, loss in zip(cp["recs"][0]["steps"], losses):
        np.testing.assert_allclose(s["loss"], loss, rtol=1e-5)
    got = params_from_jax(_nest(cp["whole"]))
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=3e-5, err_msg=name)


def test_train_lm_context_parallel_equals_one_process(tmp_path):
    # --mesh-seq 2 over 4 ranks: fsdp 2 x seq 2 (FSDP's replicate dim the
    # seq axis, the shifted target at each shard's edge); --tp
    # --no-scan-layers --mesh-model 2 --mesh-seq 2: model 2 x seq 2
    res = _launch(tmp_path, {
        "one_scan": (1, lm_spec()),
        "one_loop": (1, lm_spec("--no-scan-layers")),
        "f2s2": (4, lm_spec("--mesh-seq", "2")),
        "m2s2": (4, lm_spec("--tp", "--no-scan-layers", "--mesh-model", "2",
                            "--mesh-seq", "2")),
    })
    assert_same_run(res["f2s2"], res["one_scan"], rtol=1e-5, atol=1e-5)
    assert_same_run(res["m2s2"], res["one_loop"], rtol=1e-5, atol=1e-5)
    f2s2, m2s2 = res["f2s2"]["recs"], res["m2s2"]["recs"]
    assert [(r["coords"]["fsdp"], r["coords"]["seq"]) for r in f2s2] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert f2s2[0]["sharded"] and not m2s2[0]["sharded"]
    assert [(r["coords"]["model"], r["coords"]["seq"]) for r in m2s2] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert len(m2s2[0]["tp_split"]) == 20


# --------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("attention,seq", [
    (None, 1), (None, 2), ("ring", 1), ("ring", 4), ("flash", 2),
    ("reference", 4), ("flash", 1)])
def test_resolve_attention_as_jax(attention, seq):
    assert resolve_attention(attention, seq) == jax_resolve_attention(
        attention, seq)


TINY_DP = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
           "--train-size", "32", "--eval-size", "16",
           "--global-batch-size", "16", "--num-epochs", "1",
           "--log-every", "0"]


@pytest.mark.parametrize("cli,flags,mesh", [
    (train_lm, ["--mesh-seq", "2"], dict(data=1, fsdp=-1, seq=2)),
    (train_lm, ["--tp", "--mesh-model", "2"], dict(data=1, fsdp=-1,
                                                   model=2)),
    (train_lm, ["--mesh-data", "2", "--mesh-fsdp", "1", "--mesh-seq", "2"],
     dict(data=2, fsdp=1, seq=2)),
    (train_dp, ["--mesh-seq", "3"], dict(data=-1, seq=3)),
], ids=["lm-seq2", "lm-tp-model2", "lm-data2-seq2", "dp-seq3"])
def test_cli_mesh_errors_as_jax(cli, flags, mesh):
    with pytest.raises(ValueError) as want:
        JaxMeshConfig(**mesh).resolved_shape(1)
    argv = (LM if cli is train_lm else TINY_DP) + flags
    with pytest.raises(ValueError) as got:
        cli.train(argv)
    assert str(got.value) == str(want.value)


def test_train_mp_ring_at_seq_one_is_reference():
    # --attention ring at a seq axis of 1: reference attention, bit for bit
    # (--mesh-seq 2 under train_mp's modes: tests/test_torch_cp_mp.py)
    argv = ["--model", "tiny", "--task", "synthetic", "--device", "cpu",
            "--train-size", "32", "--eval-size", "16",
            "--global-batch-size", "16", "--num-epochs", "1",
            "--log-every", "0", "--n-branches", "2"]
    got = train_mp.train(argv + ["--attention", "ring"])
    want = train_mp.train(argv + ["--attention", "reference"])
    assert got.mcfg.attention_impl == "ring"
    assert got.step_log == want.step_log
