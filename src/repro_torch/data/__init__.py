"""Synthetic client data, numpy copies of ``repro.data``: the datasets,
the non-IID partitioners and the per-client batch iterator draw exactly
the reference's numbers from the same seeds."""
from repro_torch.data.partition import dirichlet, iid, shards_per_client
from repro_torch.data.pipeline import ClientData
from repro_torch.data.synthetic import (CELEBA_LIKE, CIFAR10_LIKE, SMOKE_DATA,
                                        DatasetSpec, make_dataset)

__all__ = ["CELEBA_LIKE", "CIFAR10_LIKE", "ClientData", "DatasetSpec",
           "SMOKE_DATA", "dirichlet", "iid", "make_dataset",
           "shards_per_client"]
