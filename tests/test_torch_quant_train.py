"""Port parity, int8 training: the PyTorch package's ``ops/quant.py``
training half (``int8_dense`` in ``fwd`` and ``full`` mode, the delayed
variants, ``dy_calibration_mode``) against the JAX package's on the same
numpy inputs; tiny BERT and gpt2-tiny, per-layer and scanned, int8,
int8_full and delayed (± dy), through one forward, ``calibrate_quant``
and one train step against the JAX step (weights and amaxes bridged by
``models/convert.py``; the counterparts of JAX ``tests/test_quant.py:
59-498``); the schedules' delayed amaxes over gloo at stage 2 against
stage mode (the sequential carry of JAX ``tests/test_pipeline.py:
608-859``) and their refusals against JAX's; int8_full, dynamic and
delayed, over data 2, seq 2, fsdp 2 and ``--tp`` model 2 against one
process (JAX ``tests/test_quant.py:284``); and the CLIs' flags against
the JAX CLIs', on the CPU.

Tolerances: ``full`` mode's products, rescales and quantizers are
bit-equal to JAX's on identical inputs (integer products are exact);
``fwd`` mode's float backward sums in another order (atol 1e-5). At the
model level the activations differ from JAX's by float32 rounding (~1e-7),
which may move an element across an int8 rounding boundary: losses rtol
1e-5, gradients atol 2e-4, amaxes rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu.cli import train_dp as jax_train_dp
from pytorch_distributed_training_tpu.cli import train_mp as jax_train_mp
from pytorch_distributed_training_tpu.comms.mesh import (
    build_mesh as jax_build_mesh,
)
from pytorch_distributed_training_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from pytorch_distributed_training_tpu.models.gpt2 import GPT2LMModel as JaxGPT2
from pytorch_distributed_training_tpu.ops import quant as jq
from pytorch_distributed_training_tpu.parallel.pipeline import (
    GPipeClassifier as JaxGPipeClassifier,
)
from pytorch_distributed_training_tpu.parallel.pipeline import (
    make_1f1b_train_step as jax_make_1f1b_train_step,
)
from pytorch_distributed_training_tpu.train import (
    calibrate_quant as jax_calibrate_quant,
)
from pytorch_distributed_training_tpu.train import (
    create_train_state as jax_create_train_state,
)
from pytorch_distributed_training_tpu.train import (
    make_train_step as jax_make_train_step,
)
from pytorch_distributed_training_tpu.train.step import (
    _sink_zeros as jax_sink_zeros,
)
from pytorch_distributed_training_tpu.utils.config import (
    MeshConfig as JaxMeshConfig,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import (
    train_dp,
    train_lm,
    train_mp,
)
from pytorch_distributed_training_tpu_torch.comms.mesh import (
    AXIS_NAMES,
    Mesh,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
    DenseGeneral,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    params_from_jax,
    params_to_jax,
    quant_to_jax,
)
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.ops import quant as tq
from pytorch_distributed_training_tpu_torch.parallel.pipeline import (
    GPipeClassifier,
    make_pipeline_train_step,
)
from pytorch_distributed_training_tpu_torch.train.state import TrainState
from pytorch_distributed_training_tpu_torch.train.step import (
    calibrate_quant,
    make_train_step,
)
from pytorch_distributed_training_tpu_torch.utils.config import model_preset
from test_torch_mp import _run
from test_torch_tp import _launch, assert_same_run

torch.set_num_threads(2)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t32(t) -> np.ndarray:
    return t.detach().float().numpy()


# ------------------------------------------------------------------ ops

# (x, kernel) shapes by n_contract: DenseGeneral's query and out layouts
OP_SHAPES = {1: ((3, 5, 32), (32, 4, 8)), 2: ((3, 5, 4, 8), (4, 8, 16))}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _op_inputs(n_contract, seed=0):
    xs, ks = OP_SHAPES[n_contract]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=xs).astype(np.float32)
    k = (rng.normal(size=ks) * 0.1).astype(np.float32)
    dy = rng.normal(size=xs[:len(xs) - n_contract] + ks[n_contract:])
    return x, k, dy.astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_contract", [1, 2])
@pytest.mark.parametrize("mode", ["fwd", "full"])
def test_int8_dense_matches_jax(mode, n_contract, dtype):
    tdt, jdt = DTYPES[dtype]
    x, k, dy = _op_inputs(n_contract)
    y, vjp = jax.vjp(lambda a, b: jq.int8_dense(a, b, n_contract, mode),
                     jnp.asarray(x, jdt), jnp.asarray(k))
    jdx, jdw = vjp(jnp.asarray(dy, jdt))
    tx = torch.tensor(x).to(tdt).requires_grad_()
    tk = torch.tensor(k).requires_grad_()
    ty = tq.int8_dense(tx, tk, n_contract, mode)
    ty.backward(torch.tensor(dy).to(tdt))
    assert ty.dtype == tdt and tx.grad.dtype == tdt
    np.testing.assert_array_equal(_t32(ty), _f32(y))
    if mode == "full":  # int8 dgrad and wgrad: bit for bit
        np.testing.assert_array_equal(_t32(tx.grad), _f32(jdx))
        np.testing.assert_array_equal(_t32(tk.grad), _f32(jdw))
    else:
        np.testing.assert_allclose(_t32(tx.grad), _f32(jdx), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(_t32(tk.grad), _f32(jdw), rtol=0,
                                   atol=1e-5)


def test_quantizers_and_int8_mm_match_jax():
    x, k, _ = _op_inputs(2, seed=1)
    q, s = tq.quantize_per_tensor(torch.tensor(x))
    jqx, js = jq.quantize_per_tensor(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
    assert float(s) == float(js)
    q, s = tq.quantize_per_channel(torch.tensor(k), (0, 1))
    jqk, js = jq.quantize_per_channel(jnp.asarray(k), (0, 1))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqk))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the int32 product, exact: against numpy's int64 one
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (19, 40)).astype(np.int8)
    bt = rng.integers(-127, 128, (12, 40)).astype(np.int8)
    got = tq.int8_mm(torch.from_numpy(a), torch.from_numpy(bt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ bt.astype(np.int64).T)


def test_int8_dense_delayed_matches_jax():
    x, k, dy = _op_inputs(1, seed=3)
    amax_prev = np.float32(0.7 * np.abs(x).max())  # stale: some saturate

    def f(a, b, m):
        return jq.int8_dense_delayed(a, b, m, 1, "full")

    (y, new), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k),
                            jnp.asarray(amax_prev))
    jdx, jdw, jdm = vjp((jnp.asarray(dy), jnp.zeros(())))
    tx = torch.tensor(x).requires_grad_()
    tk = torch.tensor(k).requires_grad_()
    tm = torch.tensor(amax_prev).requires_grad_()
    ty, tnew = tq.int8_dense_delayed(tx, tk, tm, 1, "full")
    assert not tnew.requires_grad
    ty.backward(torch.tensor(dy))
    np.testing.assert_array_equal(_t32(ty), _f32(y))
    assert float(tnew) == float(new)
    np.testing.assert_array_equal(_t32(tx.grad), _f32(jdx))
    np.testing.assert_array_equal(_t32(tk.grad), _f32(jdw))
    assert float(tm.grad) == float(jdm) == 0.0


@pytest.mark.parametrize("calibrate", [False, True],
                         ids=["carried", "calibrate"])
def test_int8_dense_delayed_grads_matches_jax(calibrate):
    x, k, dy = _op_inputs(1, seed=4)
    amax_prev = np.float32(np.abs(x).max())
    # carried dy amaxes far from this microbatch's: the scales differ
    dy_amaxes = np.array([0.5, 3.0], np.float32) * np.abs(dy).max()

    def f(a, b, sink):
        return jq.int8_dense_delayed_grads(
            a, b, jnp.asarray(amax_prev), jnp.asarray(dy_amaxes), sink, 1,
            calibrate)

    (y, new), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k),
                            jnp.zeros(2, jnp.float32))
    jdx, jdw, obs = vjp((jnp.asarray(dy), jnp.zeros(())))
    y_delayed = jq.int8_dense_delayed(jnp.asarray(x), jnp.asarray(k),
                                      jnp.asarray(amax_prev), 1, "full")[0]
    tx = torch.tensor(x).requires_grad_()
    tk = torch.tensor(k).requires_grad_()
    sink = torch.tensor(dy_amaxes)
    if calibrate:
        with tq.dy_calibration_mode():
            ty, tnew = tq.int8_dense_delayed_grads(
                tx, tk, torch.tensor(amax_prev), sink, 1)
    else:
        ty, tnew = tq.int8_dense_delayed_grads(
            tx, tk, torch.tensor(amax_prev), sink, 1)
    # the forward is the delayed one's; the backward reads the dy amaxes
    # carried when the forward ran, then writes this microbatch's
    np.testing.assert_array_equal(sink.numpy(), dy_amaxes)
    ty.backward(torch.tensor(dy))
    np.testing.assert_array_equal(_t32(ty), _f32(y))
    np.testing.assert_array_equal(_t32(ty), _f32(y_delayed))
    assert float(tnew) == float(new)
    np.testing.assert_array_equal(sink.numpy(), np.asarray(obs))
    np.testing.assert_array_equal(_t32(tx.grad), _f32(jdx))
    np.testing.assert_array_equal(_t32(tk.grad), _f32(jdw))


def test_dy_calibration_mode_restores_the_outer_value():
    assert not tq.calibrating()
    with tq.dy_calibration_mode():
        with tq.dy_calibration_mode():
            assert tq.calibrating()
        assert tq.calibrating()  # JAX's context sets False here
    assert not tq.calibrating()


# ------------------------------------------------------------ the models

QUANT = {
    "int8": dict(matmul_impl="int8"),
    "int8_full": dict(matmul_impl="int8_full"),
    "delayed": dict(matmul_impl="int8_full", quant_delayed=True),
    "delayed_grads": dict(matmul_impl="int8_full", quant_delayed=True,
                          quant_delayed_grads=True),
}
MODEL_CASES = {
    # name: (model, scan_layers, quant)
    "bert-int8": ("bert", False, "int8"),
    "bert-delayed_grads": ("bert", False, "delayed_grads"),
    "bert-scan-delayed": ("bert", True, "delayed"),
    "gpt2-int8_full": ("gpt2", False, "int8_full"),
    "gpt2-scan-delayed_grads": ("gpt2", True, "delayed_grads"),
}
MODELS = {"bert": ("tiny", JaxBert, BertForSequenceClassification,
                   "classification"),
          "gpt2": ("gpt2-tiny", JaxGPT2, GPT2LMModel, "causal_lm")}
PLAIN = dict(compute_dtype="float32", hidden_dropout=0.0,
             attention_dropout=0.0, attention_impl="reference")


def _model_batch(kind, accum=2, rows=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 1024, (accum, rows, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 1, 11:] = 0
    batch = {"input_ids": ids, "attention_mask": mask,
             "token_type_ids": np.zeros_like(ids)}
    if kind == "bert":
        batch["labels"] = rng.integers(0, 2, (accum, rows)).astype(np.int32)
    return batch


def _grads_tree(module, scan):
    return params_to_jax({n: p.grad for n, p in module.named_parameters()},
                         scan_layers=scan)


def _assert_trees(got, want, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, a in jax.tree_util.tree_flatten_with_path(want)[0]:
        b = got
        for key in path:
            b = b[key.key]
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_forward_calibration_and_step_match_jax(case):
    kind, scan, quant = MODEL_CASES[case]
    preset, jax_cls, port_cls, objective = MODELS[kind]
    jcfg = jax_preset(preset, scan_layers=scan, **PLAIN, **QUANT[quant])
    jmodel = jax_cls(jcfg)
    batch = _model_batch(kind)
    example = {k: jnp.asarray(v[0]) for k, v in batch.items()
               if k != "labels"}
    jstate = jax_create_train_state(jmodel, optax.sgd(1.0),
                                    jax.random.key(0), example)
    delayed = jstate.quant is not None
    assert delayed == bool(QUANT[quant].get("quant_delayed"))
    np_params = jax.tree.map(np.asarray, jstate.params)
    np_quant = None if not delayed else jax.tree.map(np.asarray,
                                                     jstate.quant)
    model = port_cls(model_preset(preset, scan_layers=scan, **PLAIN,
                                  **QUANT[quant]),
                     generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(np_params, scan_layers=scan,
                                          quant=np_quant))
    assert sum(isinstance(m, DenseGeneral) and m.int8_mode is not None
               for m in model.modules()) == 6 * (1 if scan else 2)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    micro0 = {k: v[0] for k, v in tb.items()}

    # eval forward: the carried amaxes read, not written
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        logits = model(micro0["input_ids"], micro0["attention_mask"],
                       micro0["token_type_ids"])
    variables = {"params": jstate.params}
    if delayed:
        variables["quant"] = jstate.quant
        sinks = jax_sink_zeros(jstate.quant)
        if sinks is not None:
            variables["quant_sink"] = sinks
    want = jmodel.apply(variables, example["input_ids"],
                        example["attention_mask"], example["token_type_ids"],
                        deterministic=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n

    state = TrainState(model=model, module=model,
                       optimizer=torch.optim.SGD(model.parameters(), lr=1.0),
                       dropout_seed=0)
    if delayed:
        jstate = jax_calibrate_quant(
            jstate, {k: jnp.asarray(v[0]) for k, v in batch.items()},
            objective=objective, loss_scale=0.5)
        calibrate_quant(state, micro0, objective=objective, loss_scale=0.5)
        _assert_trees(quant_to_jax(model.state_dict(), scan_layers=scan),
                      jstate.quant, rtol=1e-4)
    jnew, metrics = jax_make_train_step(grad_accum_steps=2,
                                        objective=objective)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_train_step(grad_accum_steps=2, objective=objective)(state, tb)
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)
    want_grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                              jstate.params, jnew.params)
    _assert_trees(_grads_tree(model, scan), want_grads, rtol=0, atol=2e-4)
    if delayed:  # every amax after the step: the last microbatch's
        _assert_trees(quant_to_jax(model.state_dict(), scan_layers=scan),
                      jnew.quant, rtol=1e-4)


def test_convert_carries_the_quant_collection_both_ways():
    # BERT per layer and scanned, and TriBert's branch-stacked amaxes
    from pytorch_distributed_training_tpu.models.branch import (
        BranchEnsembleClassifier as JaxBranch,
    )
    from pytorch_distributed_training_tpu_torch.models.branch import (
        BranchEnsembleClassifier,
    )

    qcfg = dict(PLAIN, **QUANT["delayed_grads"])
    ids = jnp.ones((2, 16), jnp.int32)
    for scan in (False, True):
        v = jax.jit(JaxBert(jax_preset("tiny", scan_layers=scan,
                                       **qcfg)).init)(jax.random.key(0), ids,
                                                      ids)
        quant = jax.tree.map(np.asarray, v["quant"])
        sd = params_from_jax(jax.tree.map(np.asarray, v["params"]),
                             scan_layers=scan, quant=quant)
        model = BertForSequenceClassification(model_preset(
            "tiny", scan_layers=scan, **qcfg))
        model.load_state_dict(sd)
        if scan:
            assert model.bert.layers_scan.layer.attention.query.amax.shape \
                == (2,)
        _assert_trees(quant_to_jax(model.state_dict(), scan_layers=scan),
                      quant, rtol=0, atol=0)
        assert "amax" not in str(params_to_jax(model.state_dict(),
                                               scan_layers=scan))
    jb = JaxBranch(jax_preset("tiny", num_layers=1, **qcfg), n_branches=3)
    v = jax.jit(lambda r: jb.init(r, ids, ids, jnp.zeros_like(ids),
                                  deterministic=True))(jax.random.key(0))
    quant = jax.tree.map(np.asarray, v["quant"])
    model = BranchEnsembleClassifier(model_preset("tiny", num_layers=1,
                                                  **qcfg), 3)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, v["params"]), quant=quant))
    assert model.branches["2"].layers[0].mlp_up.dy_amax.shape == (2,)
    _assert_trees(quant_to_jax(model.state_dict()), quant, rtol=0, atol=0)


def test_native_params_and_names_unchanged_by_int8():
    # the int8 path keeps the native layer's names and shapes; a model
    # trained int8 evaluates native by flipping the flag
    native = BertForSequenceClassification(model_preset("tiny", **PLAIN))
    q = BertForSequenceClassification(model_preset(
        "tiny", **PLAIN, **QUANT["delayed_grads"]))
    shapes = {n: p.shape for n, p in native.named_parameters()}
    assert {n: p.shape for n, p in q.named_parameters()} == shapes
    sd = {k: v for k, v in q.state_dict().items()
          if not k.endswith("amax")}
    native.load_state_dict(sd)
    assert not q.bert.pooler.int8_mode and not q.classifier.int8_mode
    with pytest.raises(ValueError, match="matmul_impl must be"):
        model_preset("tiny", matmul_impl="fp8")
    with pytest.raises(ValueError, match="'full' backward layout only"):
        model_preset("tiny", matmul_impl="int8", quant_delayed=True,
                     quant_delayed_grads=True)


# ------------------------------------------------------------- schedules


def _mesh(**sizes) -> Mesh:
    shape = {a: sizes.get(a, 1) for a in AXIS_NAMES}
    return Mesh(shape=shape, coords={a: 0 for a in AXIS_NAMES},
                groups={a: None for a in AXIS_NAMES})


def test_schedules_refuse_delayed_grads_as_jax(eight_devices):
    jcfg = jax_preset("tiny", scan_layers=True, **PLAIN,
                      **QUANT["delayed_grads"])
    jmesh = jax_build_mesh(JaxMeshConfig(data=4, stage=2))
    cfg = model_preset("tiny", **PLAIN, **QUANT["delayed_grads"])
    with pytest.raises(ValueError) as want:
        JaxGPipeClassifier(jcfg, jmesh, 2)
    with pytest.raises(ValueError) as got:
        GPipeClassifier(cfg, _mesh(stage=2), 2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        make_pipeline_train_step(cfg, _mesh(stage=2), schedule="pipeline",
                                 n_micro=2, grad_accum_steps=1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_make_1f1b_train_step(jcfg, jmesh, None, n_micro=2,
                                 grad_accum_steps=1)
    with pytest.raises(ValueError) as got:
        make_pipeline_train_step(cfg, _mesh(stage=2), schedule="1f1b",
                                 n_micro=2, grad_accum_steps=1)
    assert str(got.value) == str(want.value)


def _amaxes(weights) -> dict:
    return {k: v for k, v in weights.items() if k.endswith("amax")}


def test_schedules_stream_delayed_amaxes_as_stage_mode(tmp_path):
    # GPipe and 1F1B at stage 2 (A 2, N 4, micro 8) over gloo against one
    # process of stage mode at 8 microbatches of 2 rows: pipeline
    # microbatch j quantizes on j - 1's amaxes at every site, as the
    # sequential carry does (JAX tests/test_pipeline.py:608-699); both
    # calibrated on the first 8 rows
    spec = dict(dropout=0.0, clip=0.0, layers=2, calibrate_rows=8,
                quant=QUANT["delayed"])
    res = _run(tmp_path, {
        "one": (1, dict(spec, mode="stage", mesh={}, micro=2)),
        **{mode: (2, dict(spec, mode=mode, mesh=dict(data=1, stage=2),
                          n_micro=4))
           for mode in ("pipeline", "1f1b")},
    })
    want = res["one"]
    for mode in ("pipeline", "1f1b"):
        got = res[mode]
        for a, b in zip(want["recs"][0]["steps"], got["recs"][0]["steps"]):
            np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
            np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                       rtol=1e-5)
        assert got["weights"].keys() == want["weights"].keys()
        amaxes = _amaxes(want["weights"])
        assert len(amaxes) == 12 and all(v > 0 for v in amaxes.values())
        for name, w in want["weights"].items():
            torch.testing.assert_close(got["weights"][name], w, rtol=1e-5,
                                       atol=1e-6, msg=name)


# --------------------------------------------------- sharded against one

SHARDED_TRAIN = dict(num_epochs=1, train_size=32, eval_size=16,
                     global_batch_size=16, micro_batch_size=8,
                     eval_batch_size=8, warmup_steps=1, learning_rate=1e-3,
                     max_grad_norm=0.0, log_every=0, max_seq_length=32)


def test_int8_full_sharded_runs_equal_one_process(tmp_path):
    # dynamic and delayed (± dy) int8_full at data 2 x seq 2 and fsdp 2 x
    # model 2 (--tp): every amax global, so each run equals one process;
    # the dy amaxes scale with the rank's loss, the batch and seq shards
    # times the whole batch's
    base = dict(preset="tiny", task="synthetic", dropout=0.0,
                train=SHARDED_TRAIN)
    runs = {}
    for q in ("int8_full", "delayed_grads"):
        spec = dict(base, quant=QUANT[q])
        runs[f"one-{q}"] = (1, dict(spec, mesh=dict(data=1)))
        runs[f"d2s2-{q}"] = (4, dict(spec, mesh=dict(data=2, seq=2),
                                     attention="ring"))
        runs[f"f2m2-{q}"] = (4, dict(spec, mesh=dict(data=1, fsdp=2,
                                                     model=2),
                                     tp=True, fsdp=True))
    res = _launch(tmp_path, runs)
    for q in ("int8_full", "delayed_grads"):
        one = res[f"one-{q}"]
        for name, scale in (("d2s2", 4.0), ("f2m2", 2.0)):
            got = res[f"{name}-{q}"]
            assert_same_run(got, one, rtol=1e-5, atol=3e-5)
            if q == "int8_full":
                continue
            want = one["recs"][0]["quant"]
            for rec in got["recs"]:
                assert rec["quant"].keys() == want.keys()
                for k, w in want.items():
                    f = scale if k.endswith("dy_amax") else 1.0
                    np.testing.assert_allclose(
                        np.asarray(rec["quant"][k]), np.asarray(w) * f,
                        rtol=1e-4, err_msg=f"{name} {k}")


# ------------------------------------------------------------ the CLIs


def _exit_message(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value)


@pytest.mark.parametrize("flags", [
    ["--quant-delayed"],
    ["--matmul-impl", "int8", "--quant-delayed", "--quant-delayed-grads"],
    ["--matmul-impl", "int8_full", "--quant-delayed-grads"],
])
def test_train_dp_quant_flag_checks_as_jax(flags):
    argv = ["--model", "tiny", "--task", "synthetic"] + flags
    assert _exit_message(train_dp.main, argv + ["--device", "cpu"]) == (
        _exit_message(jax_train_dp.main, argv))


def test_cli_quant_flags_as_jax():
    from pytorch_distributed_training_tpu.cli import train_lm as jax_train_lm

    for port, jax_cli in ((train_dp, jax_train_dp), (train_lm, jax_train_lm),
                          (train_mp, jax_train_mp)):
        a = vars(port.build_parser().parse_args([]))
        b = vars(jax_cli.build_parser().parse_args([]))
        for flag in ("matmul_impl", "quant_delayed", "quant_delayed_grads"):
            assert (flag in a) == (flag in b), (port.__name__, flag)
            if flag in a:
                assert a[flag] == b[flag]
    assert _exit_message(
        train_mp.main, ["--model", "tiny", "--quant-delayed", "--device",
                        "cpu"]) == _exit_message(
        jax_train_mp.main, ["--model", "tiny", "--quant-delayed"])


def test_int8_flags_run_through_the_clis():
    tiny = ["--task", "synthetic", "--device", "cpu", "--train-size", "16",
            "--eval-size", "8", "--global-batch-size", "8",
            "--micro-batch-size", "4", "--num-epochs", "1", "--log-every",
            "0"]
    t = train_dp.train(["--model", "tiny", "--matmul-impl", "int8_full",
                        "--quant-delayed", "--quant-delayed-grads"] + tiny)
    amaxes = [b for n, b in t.state.module.named_buffers()]
    assert len(amaxes) == 24 and all((b > 0).all() for b in amaxes)
    assert all(np.isfinite(s["loss"]) for s in t.step_log)
    t = train_lm.train(["--model", "gpt2-tiny", "--matmul-impl", "int8"]
                       + tiny[2:])
    assert t.mcfg.matmul_impl == "int8" and not t.mcfg.quant_delayed
    t = train_mp.train(["--model", "tiny", "--matmul-impl", "int8",
                        "--quant-delayed", "--mp-mode", "1f1b"] + tiny)
    assert all(np.isfinite(s["loss"]) for s in t.step_log)
