"""Client construction from a :class:`DataSpec`
(``repro/experiment/data.py``): the reference's datasets, partitions and
per-client shuffle seeds, so both packages build the same clients."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.data import (CELEBA_LIKE, CIFAR10_LIKE, SMOKE_DATA,
                              ClientData, DatasetSpec, dirichlet, iid,
                              make_dataset, shards_per_client)
from repro_torch.experiment.spec import ExperimentSpec
from repro_torch.fl.client import Client

DATASETS = {
    "smoke": SMOKE_DATA,
    "cifar10-like": CIFAR10_LIKE,
    "celeba-like": CELEBA_LIKE,
}


def dataset_spec(name: str) -> DatasetSpec:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: "
                       f"{sorted(DATASETS)}")
    return DATASETS[name]


def register_dataset(name: str, ds: DatasetSpec, *,
                     overwrite: bool = False) -> None:
    """Add a synthetic dataset that ``spec.data.dataset`` can name."""
    if name in DATASETS and not overwrite:
        raise ValueError(f"dataset {name!r} already registered "
                         "(pass overwrite=True to replace)")
    DATASETS[name] = ds


def make_clients(spec: ExperimentSpec
                 ) -> Tuple[List[Client], np.ndarray, np.ndarray]:
    """``(clients, images, labels)``: the spec's client population and
    the whole dataset (for FID-style references).  The dataset and the
    partition are seeded by ``spec.seed``, client i's shuffle by i."""
    ds = dataset_spec(spec.data.dataset)
    images, labels = make_dataset(ds, seed=spec.seed)
    n = spec.fl.num_clients
    if spec.data.partition == "shards":
        parts = shards_per_client(labels, n, spec.data.classes_per_client,
                                  seed=spec.seed)
    elif spec.data.partition == "iid":
        parts = iid(labels, n, seed=spec.seed)
    elif spec.data.partition == "dirichlet":
        parts = dirichlet(labels, n, alpha=spec.data.alpha, seed=spec.seed)
    else:
        raise ValueError(f"unknown partition {spec.data.partition!r}")
    clients = [Client(i, ClientData(images[p], labels[p],
                                    batch_size=spec.data.batch_size, seed=i),
                      ds.num_classes)
               for i, p in enumerate(parts)]
    return clients, images, labels
