"""Declarative experiment specification (``repro/experiment/spec.py``).

An :class:`ExperimentSpec` is the front door to the port's trainers: the
model config's name, the FL hyper-parameters, the data partition, the
method, the selection and aggregation ablations, the round engine, the
persistent-optimizer flag, the eval cadence and one seed, frozen and
JSON-round-trippable.  Its fields and defaults are the reference's, so
a ``spec.json`` written by either package loads in the other and is
written back key for key.

The reference keeps three of its nested specs in modules that import
JAX (``fl/faults.py``, ``fl/compress.py``) or the obs layer; the port
keeps its own copies here, with the same fields, validation and
``from_dict``.  The trainers refuse what they do not implement yet: an
enabled ``fault`` or a ``comm.quant`` other than "none" (ROADMAP A.10),
enabled ``obs`` (A.11), a ``mesh`` (A.13).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.configs.base import FLConfig, fl_from_dict
from repro_torch.experiment.resolve import resolve_obs
from repro_torch.fl.compress import QUANTS

TOPOLOGIES = ("hierarchical", "flat")


class _Spec:
    """``replace``/``to_dict``/``from_dict`` (unknown keys dropped) of a
    frozen dataclass."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class FaultSpec(_Spec):
    """The reference's fault model (``repro/fl/faults.py:FaultSpec``),
    all probabilities per round; see that class for each field.  The
    port implements only the disabled spec."""
    arrival: float = 1.0
    dropout: float = 0.0
    straggler_frac: float = 0.0
    slowdown: float = 2.0
    deadline: float = 1.0
    churn: float = 0.0
    staleness: float = 0.5
    seed: int = 0

    def __post_init__(self):
        for name in ("arrival", "dropout", "straggler_frac", "churn",
                     "staleness"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault.{name}={v} not in [0, 1]")
        if self.slowdown < 1.0:
            raise ValueError(f"fault.slowdown={self.slowdown} < 1")
        if not 0.0 < self.deadline <= 1.0:
            raise ValueError(f"fault.deadline={self.deadline} not in (0, 1]")

    @property
    def enabled(self) -> bool:
        """True iff any fault can fire."""
        return (self.arrival < 1.0 or self.dropout > 0.0
                or self.churn > 0.0 or self.deadline < 1.0
                or (self.straggler_frac > 0.0 and self.slowdown > 1.0))


@dataclasses.dataclass(frozen=True)
class CommSpec(_Spec):
    """The uplink's compression (``repro/fl/compress.py:CommSpec``)."""
    quant: str = "none"          # none | int8 | fp8

    def __post_init__(self):
        if self.quant not in QUANTS:
            raise ValueError(f"comm.quant={self.quant!r} not in {QUANTS}")

    @property
    def enabled(self) -> bool:
        return self.quant != "none"


@dataclasses.dataclass(frozen=True)
class ObsSpec(_Spec):
    """Tracing and metrics (``repro/obs/spec.py:ObsSpec``).  ``enabled``
    None defers to ``$FEDPHD_OBS``."""
    enabled: Optional[bool] = None
    trace: str = ""
    flush_every: int = 1
    compile_tracking: bool = True

    def __post_init__(self):
        if self.flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got "
                             f"{self.flush_every}")

    @property
    def resolved_enabled(self) -> bool:
        """``enabled`` if explicit, else ``$FEDPHD_OBS`` > off."""
        if self.enabled is not None:
            return bool(self.enabled)
        return resolve_obs()


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
