"""Port parity, generation: the PyTorch package's dense decode cache
(``models/bert.py`` ``DenseKV``), ``models/generate.py``,
``models/relayout.py`` and the one-shot ``cli/generate_lm.py`` (with
``--checkpoint-dir`` and ``--hf-checkpoint``, and ``serve_lm`` booting
from a checkpoint) against a no-cache reference loop and the JAX
package's ``generate`` on bridged weights, on the CPU.

Tolerances: greedy ids token for token (float32, dropout off); relaid-out
weights and the scanned forward bit for bit."""

import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.models.generate import (
    generate as jax_generate,
)
from pytorch_distributed_training_tpu.models.gpt2 import (
    GPT2LMModel as JaxGPT2,
)
from pytorch_distributed_training_tpu.models.relayout import (
    unstack_scanned_params as jax_unstack,
)
from pytorch_distributed_training_tpu.utils.config import (
    model_preset as jax_preset,
)
from pytorch_distributed_training_tpu_torch.cli import (
    generate_lm,
    serve_lm,
    train_lm,
)
from pytorch_distributed_training_tpu_torch.models.bert import (
    BertForSequenceClassification,
    DenseKV,
)
from pytorch_distributed_training_tpu_torch.models.convert import params_to_jax
from pytorch_distributed_training_tpu_torch.models.generate import generate
from pytorch_distributed_training_tpu_torch.models.gpt2 import GPT2LMModel
from pytorch_distributed_training_tpu_torch.models.relayout import (
    has_scanned_trunk,
    stack_layer_params,
    unstack_scanned_params,
)
from pytorch_distributed_training_tpu_torch.train import checkpoint as ckpt
from pytorch_distributed_training_tpu_torch.utils.config import model_preset

torch.set_num_threads(2)

NO_DROPOUT = dict(compute_dtype="float32", attention_impl="reference",
                  hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def lm():
    cfg = model_preset("gpt2-tiny", **NO_DROPOUT)
    return GPT2LMModel(cfg, generator=torch.Generator().manual_seed(0)).eval()


def _greedy_no_cache(model, prompt, steps):
    """Reference loop: a full forward over the growing prefix each step."""
    ids = torch.as_tensor(prompt, dtype=torch.long)
    with torch.no_grad():
        for _ in range(steps):
            nxt = model(ids)[:, -1].argmax(-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids


def _jax(model, prompt, steps, lengths=None):
    """JAX ``generate`` (greedy) on the port model's weights, bridged."""
    cfg = jax_preset("gpt2-tiny", **NO_DROPOUT)
    params = params_to_jax(model.state_dict(),
                           scan_layers=model.config.scan_layers)
    jmodel = JaxGPT2(dataclasses.replace(
        cfg, scan_layers=model.config.scan_layers))
    return np.asarray(jax_generate(jmodel, params, prompt,
                                   max_new_tokens=steps,
                                   prompt_lengths=lengths))


def _ragged(rng, lengths, vocab, width=None):
    prompt = np.zeros((len(lengths), width or max(lengths)), np.int32)
    for i, n in enumerate(lengths):
        prompt[i, :n] = rng.integers(1, vocab, n)
    return prompt


# ---------------------------------------------------------- the generator


def test_greedy_cache_matches_no_cache_and_jax(lm):
    prompt = np.random.default_rng(0).integers(
        1, lm.config.vocab_size, (3, 7)).astype(np.int32)
    got = generate(lm, prompt, max_new_tokens=6)
    assert torch.equal(got, _greedy_no_cache(lm, prompt, 6))
    np.testing.assert_array_equal(got.numpy(), _jax(lm, prompt, 6))


def test_padded_rows_first_token(lm):
    lengths = np.array([4, 7], np.int32)
    prompt = _ragged(np.random.default_rng(1), lengths, lm.config.vocab_size)
    got = generate(lm, prompt, max_new_tokens=1, prompt_lengths=lengths)
    for i, n in enumerate(lengths):
        with torch.no_grad():
            want = int(lm(torch.as_tensor(prompt[i:i + 1, :n]))[0, -1]
                       .argmax())
        assert int(got[i, 7]) == want, f"row {i}"


def test_padded_matches_exact_per_row_and_jax(lm):
    lengths = np.array([3, 7, 5], np.int32)
    prompt = _ragged(np.random.default_rng(5), lengths, lm.config.vocab_size)
    out = generate(lm, prompt, max_new_tokens=6, prompt_lengths=lengths)
    for i, n in enumerate(lengths):
        exact = generate(lm, prompt[i:i + 1, :n], max_new_tokens=6)[0, n:]
        assert torch.equal(out[i, 7:], exact), f"row {i} (len {n})"
    np.testing.assert_array_equal(out.numpy(),
                                  _jax(lm, prompt, 6, lengths))


def test_eot_freeze(lm):
    prompt = np.random.default_rng(2).integers(
        1, lm.config.vocab_size, (1, 5))
    free = generate(lm, prompt, max_new_tokens=5)
    eot = int(free[0, 5])  # the first generated token becomes the stop
    frozen = generate(lm, prompt, max_new_tokens=5, eot_id=eot)
    assert (frozen[0, 5:] == eot).all()


def test_sampling_deterministic_per_seed(lm):
    prompt = np.random.default_rng(3).integers(
        1, lm.config.vocab_size, (2, 6))

    def sample(seed):
        return generate(lm, prompt, max_new_tokens=4, temperature=0.8,
                        top_k=8, generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(7), sample(7), sample(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a < lm.config.vocab_size).all()
    with pytest.raises(ValueError, match="generator"):
        generate(lm, prompt, max_new_tokens=1, temperature=0.5)


def test_top_k_one_is_greedy(lm):
    prompt = np.random.default_rng(4).integers(
        1, lm.config.vocab_size, (2, 6))
    sampled = generate(lm, prompt, max_new_tokens=5, temperature=1.3,
                       top_k=1, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sampled, generate(lm, prompt, max_new_tokens=5))


def test_rejects_non_causal_and_too_long(lm):
    enc = BertForSequenceClassification(model_preset("tiny"))
    with pytest.raises(ValueError, match="causal"):
        generate(enc, np.ones((1, 4), np.int32), max_new_tokens=1)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(lm, np.ones((1, 100), np.int32), max_new_tokens=29)


def test_dense_cache_chunks_equal_one_prefill(lm):
    # a prompt fed as two chunks writes and attends as one prefill
    ids = torch.randint(1, lm.config.vocab_size, (2, 9))
    with torch.no_grad():
        one = DenseKV.zeros(lm.config, 2, 12)
        want = lm(ids, cache=one)
        two = DenseKV.zeros(lm.config, 2, 12)
        head = lm(ids[:, :4], cache=two)
        tail = lm(ids[:, 4:], cache=two)
    assert one.index == two.index == 9
    torch.testing.assert_close(torch.cat([head, tail], 1), want, rtol=0,
                               atol=1e-5)
    for a, b in zip(one.keys + one.values, two.keys + two.values):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ------------------------------------------------------------- relayout


@pytest.mark.parametrize("kind", ["gpt2", "bert"])
def test_relayout_roundtrip_and_jax(kind):
    if kind == "gpt2":
        model = GPT2LMModel(model_preset("gpt2-tiny", scan_layers=True))
    else:
        model = BertForSequenceClassification(
            model_preset("tiny", scan_layers=True))
    scanned = model.state_dict()
    assert has_scanned_trunk(scanned)
    flat = unstack_scanned_params(scanned)
    assert not has_scanned_trunk(flat)
    last = "blocks.1." if kind == "gpt2" else "bert.layers.1."
    assert any(k.startswith(last) for k in flat)
    back = stack_layer_params(flat)
    assert sorted(back) == sorted(scanned)
    assert all(torch.equal(back[k], scanned[k]) for k in scanned)
    # the same reshape of names as JAX's, on bridged trees
    want = jax_unstack(params_to_jax(scanned, scan_layers=True))
    got = params_to_jax(flat)
    assert jax.tree.all(jax.tree.map(np.array_equal, got, want))


def test_scanned_model_generates_like_unscanned(lm):
    cfg = dataclasses.replace(lm.config, scan_layers=True)
    scanned = GPT2LMModel(cfg)
    scanned.load_state_dict(stack_layer_params(lm.state_dict()))
    ids = torch.randint(1, cfg.vocab_size, (2, 10))
    with torch.no_grad():
        assert torch.equal(scanned(ids), lm(ids))
    prompt = np.asarray([[5, 3, 7, 2], [1, 1, 4, 9]])
    out = generate(scanned, prompt, max_new_tokens=6)
    assert torch.equal(out, generate(lm, prompt, max_new_tokens=6))
    np.testing.assert_array_equal(out.numpy(), _jax(scanned, prompt, 6))


# -------------------------------------------------------- entry points


_CPU = ["--model", "gpt2-tiny", "--device", "cpu"]


def test_generate_cli_smoke_and_prompt_file(tmp_path, capsys):
    text = generate_lm.main(_CPU + ["--prompt", "hello",
                                    "--max-new-tokens", "4",
                                    "--no-stop-at-eot"])
    assert isinstance(text, str)
    pf = tmp_path / "prompts.txt"
    prompts = ["hello there", "a much longer prompt line", "bye"]
    pf.write_text("\n".join(prompts) + "\n")
    capsys.readouterr()
    texts = generate_lm.main(_CPU + ["--prompt-file", str(pf),
                                     "--max-new-tokens", "4",
                                     "--no-stop-at-eot"])
    assert isinstance(texts, list) and len(texts) == 3
    printed = capsys.readouterr().out.splitlines()
    assert printed == [p + t for p, t in zip(prompts, texts)]
    solo = generate_lm.main(_CPU + ["--prompt", prompts[2],
                                    "--max-new-tokens", "4",
                                    "--no-stop-at-eot"])
    assert solo == texts[2]


@pytest.fixture(scope="module")
def lm_checkpoint(tmp_path_factory):
    """A checkpoint the port's ``train_lm`` wrote: gpt2-tiny, its default
    scanned trunk, 2 steps."""
    d = tmp_path_factory.mktemp("lm") / "ck"
    train_lm.main(_CPU + ["--train-size", "32", "--eval-size", "16",
                          "--global-batch-size", "16",
                          "--micro-batch-size", "8", "--num-epochs", "1",
                          "--log-every", "0", "--learning-rate", "1e-2",
                          "--warmup-steps", "0",
                          "--checkpoint-dir", str(d)])
    return str(d)


def _decoded(model, prompt: str, n: int):
    from pytorch_distributed_training_tpu_torch.data.bpe import ByteTokenizer

    ids = np.asarray([ByteTokenizer().text_ids(prompt)])
    out = generate(model, ids, max_new_tokens=n).numpy()[0, ids.shape[1]:]
    return ByteTokenizer().decode(out)


def test_generate_cli_scanned_checkpoint(lm_checkpoint):
    assert ckpt.saved_params_scanned(lm_checkpoint)
    args = generate_lm.build_parser().parse_args(
        _CPU + ["--checkpoint-dir", lm_checkpoint])
    model, step = generate_lm.load_model_and_params(
        args, generate_lm.build_tokenizer(args))
    assert step == 2 and model.config.scan_layers
    saved = ckpt.restore_params(lm_checkpoint)
    assert all(torch.equal(model.state_dict()[k], saved[k]) for k in saved)
    text = generate_lm.main(_CPU + ["--prompt", "hello", "--max-new-tokens",
                                    "5", "--no-stop-at-eot",
                                    "--checkpoint-dir", lm_checkpoint])
    assert text == _decoded(model, "hello", 5)
    # JAX's generate on the same weights, re-laid out by the bridge
    prompt = np.asarray([[5, 3, 7, 2]])
    flat = GPT2LMModel(model_preset("gpt2-tiny"), device="meta")
    flat.load_state_dict(unstack_scanned_params(saved), assign=True)
    np.testing.assert_array_equal(
        generate(model, prompt, max_new_tokens=5).numpy(),
        np.asarray(jax_generate(JaxGPT2(jax_preset("gpt2-tiny")),
                                params_to_jax(flat.state_dict()), prompt,
                                max_new_tokens=5)))


def test_generate_cli_step_resolution(lm_checkpoint, tmp_path):
    """The boot step is JAX ``cli/generate_lm``'s: the newest verified
    step; when none verifies (a legacy manifest-less step, or every
    manifest failing) the latest step, unverified, with JAX's log line; an
    empty directory exits. ``serve_lm --checkpoint-dir`` boots the same
    way. A torn copy (step 2's largest data file truncated) is tried
    unverified and then fails to read; a copy whose data file grew (its
    manifest fails on size, its tensors intact) boots step 2."""
    import logging
    import os
    import shutil

    from torch.distributed.checkpoint.api import CheckpointException

    from pytorch_distributed_training_tpu_torch.train import manifest
    from pytorch_distributed_training_tpu_torch.utils.logging import (
        get_logger,
    )

    def load(d):
        args = generate_lm.build_parser().parse_args(
            _CPU + ["--checkpoint-dir", str(d)])
        return generate_lm.load_model_and_params(
            args, generate_lm.build_tokenizer(args))

    def damaged(name, damage):
        copy = shutil.copytree(lm_checkpoint, tmp_path / name)
        step = ckpt.step_path(str(copy), 2)
        data = max((os.path.join(step, f) for f in os.listdir(step)
                    if f != manifest.MANIFEST_NAME), key=os.path.getsize)
        damage(data)
        assert not manifest.verify_step(step)[0]
        return copy

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    lines = Lines()
    get_logger().addHandler(lines)
    try:
        legacy = shutil.copytree(lm_checkpoint, tmp_path / "legacy")
        os.remove(os.path.join(ckpt.step_path(str(legacy), 2),
                               manifest.MANIFEST_NAME))
        assert load(legacy)[1] == 2

        def truncate(path):
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)

        torn = damaged("torn", truncate)
        assert generate_lm.boot_step(str(torn)) == 2
        want = (f"no integrity-verified checkpoint under {torn} (legacy "
                f"save?); loading latest step 2 unverified")
        assert lines.lines[-1] == want
        with pytest.raises(CheckpointException):
            load(torn)
        assert lines.lines[-1] == want
        with pytest.raises(CheckpointException):
            serve_lm.main(_CPU + ["--checkpoint-dir", str(torn)],
                          in_stream=io.StringIO(""),
                          out_stream=io.StringIO())

        def grow(path):
            with open(path, "ab") as f:
                f.write(b"\0" * 16)

        grown = damaged("grown", grow)
        model, step = load(grown)
        assert step == 2
        saved = ckpt.restore_params(lm_checkpoint)
        assert all(torch.equal(model.state_dict()[k], saved[k])
                   for k in saved)
        stats = serve_lm.main(
            _CPU + ["--checkpoint-dir", str(grown), "--prompt-buckets",
                    "16", "--max-new-tokens-cap", "4"],
            in_stream=io.StringIO(""), out_stream=io.StringIO())
        assert stats["weights_step"] == 2
    finally:
        get_logger().removeHandler(lines)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no checkpoint"):
        load(tmp_path / "empty")


def test_generate_cli_hf_checkpoint(tmp_path):
    import transformers

    cfg = model_preset("gpt2-tiny")
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=cfg.vocab_size, n_positions=cfg.max_position_embeddings,
        n_embd=cfg.hidden_size, n_layer=cfg.num_layers, n_head=cfg.num_heads,
        n_inner=cfg.intermediate_size, activation_function="gelu_new"))
    torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    argv = _CPU + ["--hf-checkpoint", str(tmp_path)]
    args = generate_lm.build_parser().parse_args(argv)
    model, step = generate_lm.load_model_and_params(
        args, generate_lm.build_tokenizer(args))
    assert step is None
    assert torch.equal(model.wte.embedding, hf.transformer.wte.weight)
    text = generate_lm.main(argv + ["--prompt", "hi", "--max-new-tokens",
                                    "4", "--no-stop-at-eot"])
    assert text == _decoded(model, "hi", 4)


def test_serve_lm_boots_from_a_checkpoint(lm_checkpoint):
    out = io.StringIO()
    stats = serve_lm.main(
        _CPU + ["--checkpoint-dir", lm_checkpoint, "--prompt-buckets",
                "16,32", "--max-new-tokens-cap", "8"],
        in_stream=io.StringIO(json.dumps(
            {"id": "a", "prompt": "hello", "max_new_tokens": 4}) + "\n"),
        out_stream=out)
    assert stats["weights_step"] == 2 and stats["finished"] == 1
    events = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [e["event"] for e in events].count("token") == 4
    random = serve_lm.main(_CPU + ["--prompt-buckets", "16",
                                   "--max-new-tokens-cap", "4"],
                           in_stream=io.StringIO(""), out_stream=io.StringIO())
    assert random["weights_step"] is None
