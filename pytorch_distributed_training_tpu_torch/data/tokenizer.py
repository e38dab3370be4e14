"""Pair tokenization for the classification tasks (counterpart: the JAX
package's ``data/tokenizer.py``, whose behaviour this copy keeps exactly).

``WordPieceTokenizer`` encodes with a BERT ``vocab.txt`` when one is
given; ``HashTokenizer`` maps words onto stable ids for fully offline
runs. ``assemble_pair_row`` is the one pair-encoding contract ([CLS] a
[SEP] (b [SEP]), token types 0/1, longest-first truncation), shared by
text encoding (``encode_pairs``) and the synthetic task.
"""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102

_WORD_RE = re.compile(r"\w+|[^\w\s]")


def basic_tokenize(text: str, lower: bool = False) -> list[str]:
    if lower:
        text = text.lower()
    return _WORD_RE.findall(text)


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT vocab file."""

    def __init__(self, vocab_path: str, lower: bool = False):
        self.vocab: dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.lower = lower
        self.pad_id = self.vocab.get("[PAD]", PAD_ID)
        self.unk_id = self.vocab.get("[UNK]", UNK_ID)
        self.cls_id = self.vocab.get("[CLS]", CLS_ID)
        self.sep_id = self.vocab.get("[SEP]", SEP_ID)

    def word_ids(self, word: str) -> list[int]:
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    piece_id = self.vocab[piece]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def text_ids(self, text: str) -> list[int]:
        out: list[int] = []
        for w in basic_tokenize(text, self.lower):
            out.extend(self.word_ids(w))
        return out


class HashTokenizer:
    """Deterministic word -> id hashing into [first_regular_id, vocab_size):
    stable across hosts and runs (seeded by the word bytes only)."""

    def __init__(self, vocab_size: int = 28996, lower: bool = False):
        self.vocab_size = vocab_size
        self.lower = lower
        self.pad_id, self.unk_id = PAD_ID, UNK_ID
        self.cls_id, self.sep_id = CLS_ID, SEP_ID
        self._first = SEP_ID + 1

    def text_ids(self, text: str) -> list[int]:
        out = []
        for w in basic_tokenize(text, self.lower):
            h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
            out.append(self._first + h % (self.vocab_size - self._first))
        return out


def assemble_pair_row(
    a: list[int],
    b: list[int],
    max_length: int,
    *,
    cls_id: int = CLS_ID,
    sep_id: int = SEP_ID,
) -> tuple[list[int], list[int]]:
    """[CLS] a [SEP] (b [SEP]), truncated longest-first to ``max_length``.
    Returns (ids, token_types)."""
    specials = 2 + (1 if b else 0)
    a, b = list(a), list(b)
    while len(a) + len(b) > max_length - specials:
        if len(a) >= len(b):
            a.pop()
        else:
            b.pop()
    ids = [cls_id] + a + [sep_id]
    types = [0] * len(ids)
    if b:
        ids += b + [sep_id]
        types += [1] * (len(b) + 1)
    return ids, types


def encode_pairs(
    tokenizer,
    texts_a: Sequence[str],
    texts_b: Sequence[str] | None,
    max_length: int = 128,
) -> dict[str, np.ndarray]:
    """[CLS] a [SEP] (b [SEP]) encoding, truncated and padded to
    ``max_length``: fixed-length int32 arrays."""
    n = len(texts_a)
    input_ids = np.full((n, max_length), tokenizer.pad_id, np.int32)
    token_type = np.zeros((n, max_length), np.int32)
    mask = np.zeros((n, max_length), np.int32)
    for i in range(n):
        a = tokenizer.text_ids(texts_a[i])
        b = tokenizer.text_ids(texts_b[i]) if texts_b is not None else []
        ids, types = assemble_pair_row(
            a, b, max_length, cls_id=tokenizer.cls_id, sep_id=tokenizer.sep_id
        )
        input_ids[i, : len(ids)] = ids
        token_type[i, : len(ids)] = types
        mask[i, : len(ids)] = 1
    return {
        "input_ids": input_ids,
        "attention_mask": mask,
        "token_type_ids": token_type,
    }
