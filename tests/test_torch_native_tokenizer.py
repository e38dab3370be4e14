"""Port parity, the C++ WordPiece encoder (``data/native_tokenizer.py``):
the cases of the JAX package's ``tests/test_native_tokenizer.py`` on a
vocab written in ``tmp_path``, each holding the port's ids equal to the
port's Python encoder, JAX's Python encoder and JAX's C++ encoder; and
``load_task_arrays`` with a vocab encoding in C++ as the Python encoder
would, on the CPU."""

import sys
import types

import numpy as np
import pytest

from pytorch_distributed_training_tpu.data.native_tokenizer import (
    NativeWordPieceEncoder as JaxNativeWordPieceEncoder,
)
from pytorch_distributed_training_tpu.data.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from pytorch_distributed_training_tpu.data.tokenizer import (
    encode_pairs as jax_encode_pairs,
)
from pytorch_distributed_training_tpu_torch.data import glue
from pytorch_distributed_training_tpu_torch.data.native_tokenizer import (
    NativeWordPieceEncoder,
)
from pytorch_distributed_training_tpu_torch.data.tokenizer import (
    WordPieceTokenizer,
    encode_pairs,
)
from test_torch_native_loader import jax_native, jax_native_lib


def _check(vocab, a, b, max_length):
    """The port's C++ ids, equal to its Python encoder's and to JAX's C++
    and Python encoders'."""
    got = NativeWordPieceEncoder(vocab)
    out = got.encode_pairs(a, b, max_length=max_length)
    assert jax_native_lib("wordpiece"), dict(jax_native._libs)
    jax_nat = JaxNativeWordPieceEncoder(vocab)
    wants = [encode_pairs(WordPieceTokenizer(vocab), a, b,
                          max_length=max_length),
             jax_encode_pairs(JaxWordPieceTokenizer(vocab), a, b,
                              max_length=max_length),
             jax_nat.encode_pairs(a, b, max_length=max_length)]
    for want in wants:
        assert out.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    got.close()
    jax_nat.close()
    return out


VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]",
    "the", "quick", "brown", "fox", "jump", "##s", "##ed", "##ing",
    "over", "lazy", "dog", "un", "##believ", "##able", ",", ".", "!", "'",
    "a", "b", "c", "1", "2", "##3",
]

TEXTS_A = [
    "the quick brown fox jumps",
    "unbelievable!",
    "the lazy dog , the fox .",
    "a b c 123",
    "zzz unknown words here",
    "",
    "the " * 200,  # forces truncation
]
TEXTS_B = [
    "the dog jumped over",
    "the fox",
    "unbelievable , a b",
    "",
    "the the the",
    "fox",
    "dog " * 200,
]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("wp") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(p)


def test_pair_parity(vocab_file):
    _check(vocab_file, TEXTS_A, TEXTS_B, 32)
    _check(vocab_file, TEXTS_A, None, 16)  # single sentences


def test_unicode_rows_fall_back_to_python(vocab_file):
    _check(vocab_file, ["the quick fox", "café naïve", "the dog"],
           ["the dog", "über fox", "lazy"], 24)


def test_thread_count_invariance(vocab_file):
    rng = np.random.default_rng(0)
    words = ["the", "quick", "fox", "jumps", "unbelievable", "zzz", "a", "1"]
    texts = [" ".join(rng.choice(words, rng.integers(1, 40)))
             for _ in range(257)]
    one = NativeWordPieceEncoder(vocab_file, n_threads=1)
    many = NativeWordPieceEncoder(vocab_file, n_threads=8)
    x = one.encode_pairs(texts, None, max_length=48)
    y = many.encode_pairs(texts, None, max_length=48)
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    one.close()
    many.close()
    _check(vocab_file, texts, None, 48)


def test_special_ids_match(vocab_file):
    py = WordPieceTokenizer(vocab_file)
    nat = NativeWordPieceEncoder(vocab_file)
    assert (nat.pad_id, nat.unk_id, nat.cls_id, nat.sep_id) == (
        py.pad_id, py.unk_id, py.cls_id, py.sep_id)
    nat.close()


def test_pad_fill_when_pad_id_not_zero(tmp_path):
    # the padding is the vocab's [PAD] id on the C++ rows (row 0) and the
    # Python fallback's (row 1, non-ASCII)
    vocab = ["the", "fox", "[PAD]", "[UNK]", "[CLS]", "[SEP]", "dog"]
    p = tmp_path / "vocab_pad2.txt"
    p.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    got = _check(str(p), ["the fox", "café fox"], ["dog", "dog"], 16)
    for row in range(2):
        pad = got["attention_mask"][row] == 0
        assert (got["input_ids"][row][pad] == 2).all()


def test_ascii_control_separator_parity(vocab_file):
    # \x1c-\x1f are whitespace to Python's \s, dropped by both encoders
    _check(vocab_file, ["the \x1c fox", "dog\x1d\x1e\x1f", "\x1conly"], None,
           8)


def test_max_length_too_small_raises(vocab_file):
    nat = NativeWordPieceEncoder(vocab_file)
    with pytest.raises(ValueError, match="special tokens"):
        nat.encode_pairs(["the"], ["fox"], max_length=2)
    with pytest.raises(ValueError, match="special tokens"):
        nat.encode_pairs(["the"], None, max_length=1)
    nat.close()
    # an all-whitespace b column needs only 2 specials, as in Python
    _check(vocab_file, ["the"], [" "], 2)


def test_load_task_arrays_encodes_in_cpp(vocab_file, monkeypatch):
    # a stand-in ``datasets`` with two MRPC rows (one non-ASCII): the
    # arrays with a vocab equal the Python encoder's, and the C++ path ran
    rows = {"sentence1": ["the quick fox", "café dog"],
            "sentence2": ["the lazy dog", "fox"], "label": [1, 0]}
    fake = types.ModuleType("datasets")
    fake.load_dataset = lambda *a, **k: rows
    monkeypatch.setitem(sys.modules, "datasets", fake)
    calls = []
    real = NativeWordPieceEncoder.encode_pairs

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(NativeWordPieceEncoder, "encode_pairs", spy)
    got, n = glue.load_task_arrays("mrpc", "train", max_length=12,
                                   vocab_path=vocab_file)
    want = encode_pairs(WordPieceTokenizer(vocab_file), rows["sentence1"],
                        rows["sentence2"], max_length=12)
    assert n == 2 and calls == [1]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["labels"].tolist() == [1, 0]
