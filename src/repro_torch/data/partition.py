"""Non-IID federated partitioners (``repro/data/partition.py``; paper
§V-A2): ``shards_per_client`` (each client holds k classes), Dir(alpha)
label skew, and IID."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def iid(labels: np.ndarray, num_clients: int, seed: int = 0
        ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def shards_per_client(labels: np.ndarray, num_clients: int,
                      classes_per_client: int, seed: int = 0
                      ) -> List[np.ndarray]:
    """Each client gets ``classes_per_client`` class-sorted shards."""
    rng = np.random.default_rng(seed)
    num_shards = num_clients * classes_per_client
    by_class: Dict[int, np.ndarray] = {}
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        by_class[int(c)] = idx
    order = np.concatenate([by_class[c] for c in sorted(by_class)])
    shards = np.array_split(order, num_shards)
    shard_ids = rng.permutation(num_shards)
    out = []
    for n in range(num_clients):
        take = shard_ids[n * classes_per_client:(n + 1) * classes_per_client]
        out.append(np.sort(np.concatenate([shards[s] for s in take])))
    return out


def dirichlet(labels: np.ndarray, num_clients: int, alpha: float = 0.3,
              seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    while True:
        buckets: List[List[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for b, part in zip(buckets, np.split(idx, cuts)):
                b.extend(part.tolist())
        if min(len(b) for b in buckets) >= min_size:
            return [np.sort(np.asarray(b)) for b in buckets]
