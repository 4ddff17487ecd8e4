"""Synthetic class-structured image datasets (``repro/data/synthetic.py``).

Every class has a deterministic smooth prototype and its samples are
prototype plus noise: distinct per-class distributions (so non-IID
partitions bite) in image-shaped arrays for the U-Net.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    image_size: int
    channels: int = 3
    samples_per_class: int = 512


CIFAR10_LIKE = DatasetSpec("cifar10-like", num_classes=10, image_size=32)
CELEBA_LIKE = DatasetSpec("celeba-like", num_classes=4, image_size=64)
SMOKE_DATA = DatasetSpec("smoke", num_classes=4, image_size=16,
                         samples_per_class=64)


def _class_prototype(rng: np.random.Generator, size: int, channels: int):
    """Smooth low-frequency pattern per class: a 4x4 grid, bilinearly
    upsampled."""
    coarse = rng.normal(size=(4, 4, channels))
    xi = np.linspace(0, 3, size)
    x0 = np.floor(xi).astype(int)
    x1 = np.minimum(x0 + 1, 3)
    w = xi - x0
    rows = (coarse[x0] * (1 - w)[:, None, None]
            + coarse[x1] * w[:, None, None])
    proto = (rows[:, x0] * (1 - w)[None, :, None]
             + rows[:, x1] * w[None, :, None])
    return np.tanh(proto * 1.5)


def make_dataset(spec: DatasetSpec, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, H, W, C) float32 in [-1, 1], labels (N,) int32)."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_class_prototype(rng, spec.image_size, spec.channels)
                       for _ in range(spec.num_classes)])
    images, labels = [], []
    for c in range(spec.num_classes):
        noise = rng.normal(scale=0.35,
                           size=(spec.samples_per_class, spec.image_size,
                                 spec.image_size, spec.channels))
        x = np.clip(protos[c][None] + noise, -1.0, 1.0)
        images.append(x.astype(np.float32))
        labels.append(np.full((spec.samples_per_class,), c, np.int32))
    perm = rng.permutation(spec.num_classes * spec.samples_per_class)
    return np.concatenate(images)[perm], np.concatenate(labels)[perm]
