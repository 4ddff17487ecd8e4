"""Client-local batching (``repro/data/pipeline.py``).

``ClientData.epoch`` shuffles with the same numpy stream as the
reference (one ``permutation`` per epoch from ``default_rng(seed)``), so
the two packages see the same batches in the same order.
``stacked_epochs`` and ``stack_round`` stack a whole round's batches for
the vectorized round engine from the same draws, so a sequential and a
stacked consumer stay in lockstep.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

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

    def stacked_epochs(self, num_epochs: int, steps: Optional[int] = None
                       ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """A whole local round's batches, stacked on a leading step axis
        of length ``steps`` (default: the real ones), and the (steps,)
        bool mask of real steps.  The real steps are exactly the batches
        ``epoch()`` yields, from the same draws; the tail repeats the
        last real batch, marked invalid."""
        stack: list = []
        for _ in range(num_epochs):
            stack.extend(self.epoch())
        n_real = len(stack)
        steps = n_real if steps is None else steps
        if steps < n_real:
            raise ValueError(f"steps={steps} < {n_real} real batches")
        stack.extend([stack[-1]] * (steps - n_real))
        batches = {k: np.stack([b[k] for b in stack]) for k in stack[0]}
        return batches, np.arange(steps) < n_real


def stack_round(datas: Sequence[ClientData], num_epochs: int
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Every client's ``stacked_epochs`` on a leading client axis, in the
    given order, padded to the round's most steps: ``(batches, valid)``
    with leaves (C, S, B, ...) and the (C, S) mask of real steps.  The
    clients must share one batch shape
    (``repro_torch.fl.engine.uniform_batch_shape``)."""
    steps = max(d.steps_per_epoch for d in datas) * num_epochs
    per = [d.stacked_epochs(num_epochs, steps) for d in datas]
    batches = {k: np.stack([b[k] for b, _ in per]) for k in per[0][0]}
    valid = np.stack([v for _, v in per])
    return batches, valid
