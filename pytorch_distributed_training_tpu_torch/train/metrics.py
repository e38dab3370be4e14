"""Eval metrics from per-batch counts (counterpart: the JAX package's
``train/metrics.py`` ``MetricAccumulator`` and ``LMMetricAccumulator``):
accuracy = correct / total and binary F1 = 2tp / (2tp + fp + fn) with
positive label 1 (the GLUE/MRPC convention); for causal-LM eval, the mean
next-token NLL, its perplexity (the NLL clamped at 30) and the token
accuracy.
"""

from __future__ import annotations

import math


class MetricAccumulator:
    """Folds per-batch count dicts; computes accuracy (+ F1 when binary)."""

    FIELDS = ("correct", "total", "tp", "fp", "fn")

    def __init__(self, num_labels: int = 2):
        self.num_labels = num_labels
        self.reset()

    def reset(self) -> None:
        self._c = {k: 0.0 for k in self.FIELDS}

    def update(self, counts: dict) -> None:
        for k in self.FIELDS:
            if k in counts:
                self._c[k] += float(counts[k])

    def compute(self) -> dict:
        total = self._c["total"]
        out = {"accuracy": self._c["correct"] / total if total else 0.0}
        if self.num_labels == 2:
            denom = 2 * self._c["tp"] + self._c["fp"] + self._c["fn"]
            out["f1"] = 2 * self._c["tp"] / denom if denom else 0.0
        return out


class LMMetricAccumulator:
    """Folds causal-LM eval counts: eval loss, perplexity, token accuracy."""

    FIELDS = ("nll_sum", "token_count", "token_correct")

    def __init__(self, num_labels: int = 0):  # signature-compatible
        self.reset()

    def reset(self) -> None:
        self._c = {k: 0.0 for k in self.FIELDS}

    def update(self, counts: dict) -> None:
        for k in self.FIELDS:
            if k in counts:
                self._c[k] += float(counts[k])

    def compute(self) -> dict:
        n = self._c["token_count"]
        nll = self._c["nll_sum"] / n if n else 0.0
        return {
            "eval_loss": nll,
            "perplexity": math.exp(min(nll, 30.0)),
            "token_accuracy": self._c["token_correct"] / n if n else 0.0,
        }
