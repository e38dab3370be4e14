"""Byte-level BPE tokenizer of the GPT-2 family (counterpart: the JAX
package's ``data/bpe.py``, whose behaviour this copy keeps exactly).

``ByteLevelBPETokenizer`` loads the standard ``encoder.json`` +
``merges.txt``: GPT-2's byte->unicode alphabet, its pre-tokenization
regex, greedy lowest-rank merges. ``ByteTokenizer`` is the offline
fallback: raw UTF-8 bytes as ids 0..255.
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Iterable

try:  # exact \p{L}/\p{N} classes need the `regex` module
    import regex as _re

    _HAS_REGEX = True
except ImportError:  # pragma: no cover - depends on the installation
    import re as _re

    _HAS_REGEX = False

# GPT-2's pre-tokenization pattern (contractions, space-prefixed words /
# numbers / punctuation runs, whitespace).
_GPT2_PAT_P = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
# re-compatible approximation when `regex` is unavailable: [^\W\d_]
# approximates \p{L} and \d approximates \p{N}.
_GPT2_PAT_RE = r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+"""

_PRETOK = _re.compile(_GPT2_PAT_P if _HAS_REGEX else _GPT2_PAT_RE)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte->printable-unicode alphabet."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ByteLevelBPETokenizer:
    """GPT-2 byte-level BPE over standard ``encoder.json``/``merges.txt``."""

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        merges: list[tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, tuple[str, ...]] = {}
        # GPT-2 conventions: <|endoftext|> is bos/eos/pad in one
        self.eot_id = self.encoder.get("<|endoftext|>", 0)
        self.pad_id = self.eot_id
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> tuple[str, ...]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    out.extend(word[i:])
                    break
                out.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    out.append(a + b)
                    i = j + 2
                else:
                    out.append(word[j])
                    i = j + 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._cache[token] = word
        return word

    def text_ids(self, text: str) -> list[int]:
        ids: list[int] = []
        for tok in _PRETOK.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        # unknown ids (a model vocab larger than the tokenizer's) become
        # U+FFFD instead of crashing after generation completed
        text = "".join(self.decoder.get(int(i), "�") for i in ids)
        return bytes(
            self.byte_decoder.get(c, ord("?")) for c in text
        ).decode("utf-8", errors="replace")


class ByteTokenizer:
    """Offline fallback: raw UTF-8 bytes -> ids 0..255 (lossless, stable)."""

    vocab_size = 256
    eot_id = 0
    pad_id = 0

    def text_ids(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")
