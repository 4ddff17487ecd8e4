"""Client-local batching (``repro/data/pipeline.py``).

``ClientData.epoch`` shuffles with the same numpy stream as the
reference (one ``permutation`` per epoch from ``default_rng(seed)``), so
the two packages see the same batches in the same order.  The stacked
whole-round batches of the reference's vectorized engine are not ported
yet.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class ClientData:
    """One client's local dataset with epoch iteration (Alg. 2)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, *,
                 batch_size: int, seed: int = 0):
        self.images = images
        self.labels = labels
        self.batch_size = min(batch_size, len(images))
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.images)

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        """Full batches of one shuffled pass; a ragged tail is dropped."""
        idx = self._rng.permutation(len(self.images))
        for b in range(self.steps_per_epoch):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield {"images": self.images[sel], "labels": self.labels[sel]}

    @property
    def steps_per_epoch(self) -> int:
        return max(len(self.images) // self.batch_size, 1)
