"""Eval metrics from confusion counts (counterpart: the JAX package's
``train/metrics.py`` ``MetricAccumulator``): accuracy = correct / total and
binary F1 = 2tp / (2tp + fp + fn) with positive label 1 (the GLUE/MRPC
convention), folded from per-batch count dicts.
"""

from __future__ import annotations


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
