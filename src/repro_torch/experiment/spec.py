"""Declarative experiment specification (``repro/experiment/spec.py``).

An :class:`ExperimentSpec` is the front door to the port's trainers: the
model config's name, the FL hyper-parameters, the data partition, the
method, the selection and aggregation ablations, the round engine, the
persistent-optimizer flag, the eval cadence and one seed, frozen and
JSON-round-trippable.  Its fields and defaults are the reference's, so
a ``spec.json`` written by either package loads in the other and is
written back key for key.

``FaultSpec``, ``CommSpec`` and ``ObsSpec`` are defined where the
reference defines them (:mod:`repro_torch.fl.faults`,
:mod:`repro_torch.fl.compress`, :mod:`repro_torch.obs.spec`) and
re-exported here.  The trainers refuse what they do not implement yet:
a ``mesh`` (ROADMAP A.13).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.configs.base import FLConfig, fl_from_dict
from repro_torch.fl.compress import CommSpec
from repro_torch.fl.faults import FaultSpec
from repro_torch.obs.spec import ObsSpec

TOPOLOGIES = ("hierarchical", "flat")
__all__ = ["CommSpec", "DataSpec", "ExperimentSpec", "FaultSpec", "ObsSpec",
           "TOPOLOGIES"]


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Client data: a synthetic dataset and its non-IID partition."""
    dataset: str = "smoke"          # repro_torch.experiment.data.DATASETS
    partition: str = "shards"       # shards | iid | dirichlet
    classes_per_client: int = 1     # shards partition sharpness
    alpha: float = 0.5              # dirichlet concentration
    batch_size: int = 32


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment.  ``method`` resolves through the registry
    (:mod:`repro_torch.experiment.registry`); ``topology`` "" takes the
    method's.  ``backend`` is the reference's compute backend, carried
    into ``ModelConfig.backend`` and never read; ``precision`` (fp32 |
    bf16, None: ``$FEDPHD_PRECISION`` or fp32) goes into
    ``ModelConfig.precision``."""
    name: str = "experiment"
    method: str = "fedphd"
    model: str = "ddpm-unet-smoke"  # repro_torch.configs.get_config key
    fl: FLConfig = FLConfig()
    data: DataSpec = DataSpec()
    topology: str = ""
    selection: str = "sh"           # "sh" | "random"
    aggregation: str = "sh"         # "sh" | "fedavg"
    prune: bool = True
    engine: Optional[str] = None    # auto | vectorized | sequential
    backend: Optional[str] = None
    precision: Optional[str] = None
    persistent_opt: bool = False
    state_store: str = "auto"       # auto | device | host
    mesh: Optional[dict] = None     # {axis: size}; ROADMAP A.13
    lr: float = 2e-4
    eval_every: int = 0             # 0: never call the eval hook
    seed: int = 0
    fault: FaultSpec = FaultSpec()
    comm: CommSpec = CommSpec()
    obs: ObsSpec = ObsSpec()

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        if isinstance(d.get("fl"), dict):
            d["fl"] = fl_from_dict(d["fl"])
        if isinstance(d.get("data"), dict):
            d["data"] = DataSpec(**d["data"])
        if isinstance(d.get("fault"), dict):
            d["fault"] = FaultSpec.from_dict(d["fault"])
        if isinstance(d.get("comm"), dict):
            d["comm"] = CommSpec.from_dict(d["comm"])
        if isinstance(d.get("obs"), dict):
            d["obs"] = ObsSpec.from_dict(d["obs"])
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = {str(k): int(v) for k, v in d["mesh"].items()}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))
