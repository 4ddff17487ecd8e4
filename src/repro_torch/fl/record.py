"""The round-history schema (``repro/fl/record.py``): one
:class:`RoundRecord` per round, readable as attributes or as
``rec["key"]``, and :class:`RunResult`, which unpacks as
``history, evals``.

``eval`` carries the eval hook's result: a trainer calls
``eval_fn(params, cfg, round)`` every ``eval_every`` rounds and stores
what it returns here (JSON-serializable, for checkpointed histories).
``availability`` is the round's realized fault schedule
(:meth:`repro_torch.fl.faults.RoundFaults.availability`), None when
faults are off."""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple


@dataclasses.dataclass
class RoundRecord:
    """One communication round.  ``edge_sh`` holds the per-edge SH
    scores; ``pruned`` marks the round whose cloud aggregation compacted
    the model; ``comm_gb == comm_up_gb + comm_down_gb``;
    ``availability`` is ``{"online": int, "arrived"/"dropped"/"late":
    [cids], "budgets": [steps a selected client]}`` under an enabled
    fault spec, else None."""
    round: int
    loss: float
    comm_gb: float
    comm_up_gb: Optional[float] = None
    comm_down_gb: Optional[float] = None
    params_m: float = 0.0
    selected: List[int] = dataclasses.field(default_factory=list)
    eval: Any = None
    edge_sh: Optional[List[float]] = None
    pruned: bool = False
    availability: Optional[dict] = None

    def __getitem__(self, key: str):
        if key not in self.__dataclass_fields__:
            raise KeyError(key)
        return getattr(self, key)

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def keys(self):
        return self.__dataclass_fields__.keys()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RoundRecord":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**known)


class RunResult(NamedTuple):
    """``Trainer.run``'s result; ``evals`` lists the ``(round, eval)``
    pairs of the records that carry an eval result (an ``eval_fn`` that
    returns None leaves none)."""
    history: List[RoundRecord]
    evals: List[Tuple[int, Any]]


def evals_of(history: List[RoundRecord]) -> List[Tuple[int, Any]]:
    return [(r.round, r.eval) for r in history if r.eval is not None]
