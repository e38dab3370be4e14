"""Bulk WordPiece encoding on the C++ encoder (counterpart: the JAX
package's ``data/native_tokenizer.py`` ``NativeWordPieceEncoder``).

``encode_pairs`` has ``data/tokenizer.py``'s ``encode_pairs`` contract over
a ``WordPieceTokenizer``: a whole split is tokenized across a thread pool
(``native/src/wordpiece.cpp``) in one ctypes call. On ASCII text the ids
are the Python encoder's, byte for byte; a row with any non-ASCII byte is
encoded again by the port's Python ``WordPieceTokenizer`` (Python's
``\\w`` is unicode-aware, the C++ word test is byte-level), so no row
diverges silently.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from pytorch_distributed_training_tpu_torch.data.tokenizer import (
    WordPieceTokenizer,
    assemble_pair_row,
)
from pytorch_distributed_training_tpu_torch.native import load_wordpiece_lib


class NativeWordPieceEncoder:
    """Owns a C++ vocab handle; encodes pair batches to fixed-length arrays."""

    def __init__(self, vocab_path: str, *, lower: bool = False,
                 n_threads: int | None = None):
        lib = load_wordpiece_lib()
        if lib is None:
            raise RuntimeError(
                "native wordpiece encoder unavailable (no C++ toolchain?): "
                "use data.tokenizer.encode_pairs"
            )
        self._lib = lib
        with open(vocab_path, "rb") as f:
            blob = f.read()
        self._h = lib.wp_create(blob, len(blob), int(lower))
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self.pad_id = lib.wp_special_id(self._h, 0)
        self.unk_id = lib.wp_special_id(self._h, 1)
        self.cls_id = lib.wp_special_id(self._h, 2)
        self.sep_id = lib.wp_special_id(self._h, 3)
        # the Python encoder for non-ASCII rows, made when first needed
        self._vocab_path = vocab_path
        self._lower = lower
        self._py: WordPieceTokenizer | None = None

    def _python_tok(self) -> WordPieceTokenizer:
        if self._py is None:
            self._py = WordPieceTokenizer(self._vocab_path, lower=self._lower)
        return self._py

    @staticmethod
    def _pack(texts: list[bytes]):
        off = np.zeros(len(texts) + 1, np.int64)
        for i, t in enumerate(texts):
            off[i + 1] = off[i] + len(t)
        return b"".join(texts), off

    def encode_pairs(self, texts_a, texts_b, max_length: int = 128):
        """Same output contract as ``data.tokenizer.encode_pairs``."""
        n = len(texts_a)
        # Per-row specials rule, matching the Python twin: a row needs
        # [CLS]+[SEP] (2) plus a second [SEP] only if its b tokenizes
        # non-empty (any non-whitespace char yields >= 1 token via [UNK]
        # fallback, so a strip() check is exact). The twin raises
        # IndexError for rows that cannot fit; we raise up front.
        if max_length < 2 or (
            texts_b is not None
            and max_length < 3
            and any(t.strip() for t in texts_b)
        ):
            raise ValueError(
                f"max_length={max_length} cannot hold a row's "
                "special tokens"
            )
        # C++ writes only the used prefix of each row; padding comes from
        # this pre-fill, so it must be pad_id (not 0) to match the Python
        # twin byte-for-byte on vocabs where [PAD] != 0.
        ids = np.full((n, max_length), self.pad_id, np.int32)
        types = np.zeros((n, max_length), np.int32)
        mask = np.zeros((n, max_length), np.int32)
        a_bytes = [t.encode("utf-8") for t in texts_a]
        b_bytes = (
            [t.encode("utf-8") for t in texts_b]
            if texts_b is not None
            else None
        )
        non_ascii = [
            i for i in range(n)
            if not texts_a[i].isascii()
            or (texts_b is not None and not texts_b[i].isascii())
        ]
        a_blob, a_off = self._pack(a_bytes)
        if b_bytes is not None:
            b_blob, b_off = self._pack(b_bytes)
            b_ptr = b_blob
            b_off_ptr = b_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        else:
            b_ptr = None
            b_off_ptr = None
        self._lib.wp_encode_pairs(
            self._h,
            a_blob, a_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b_ptr, b_off_ptr,
            n, max_length, self.n_threads,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        for i in non_ascii:  # unicode rows: Python semantics, overwrite
            tok = self._python_tok()
            a_ids = tok.text_ids(texts_a[i])
            b_ids = tok.text_ids(texts_b[i]) if texts_b is not None else []
            row_ids, row_types = assemble_pair_row(
                a_ids, b_ids, max_length, cls_id=tok.cls_id, sep_id=tok.sep_id
            )
            ids[i] = self.pad_id
            types[i] = 0
            mask[i] = 0
            ids[i, : len(row_ids)] = row_ids
            types[i, : len(row_ids)] = row_types
            mask[i, : len(row_ids)] = 1
        return {
            "input_ids": ids,
            "attention_mask": mask,
            "token_type_ids": types,
        }

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.wp_destroy(self._h)
            self._h = None

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:
            pass
