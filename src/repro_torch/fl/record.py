"""The round-history schema (``repro/fl/record.py``): one
:class:`RoundRecord` per round, readable as attributes or as
``rec["key"]``, and :class:`RunResult`, which unpacks as
``history, evals``.  The reference's ``eval`` and ``availability``
fields come with the eval hook and faults (ROADMAP A.7, A.10); until
then ``evals`` is empty."""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple


@dataclasses.dataclass
class RoundRecord:
    """One communication round.  ``edge_sh`` holds the per-edge SH
    scores; ``pruned`` marks the round whose cloud aggregation compacted
    the model; ``comm_gb == comm_up_gb + comm_down_gb``."""
    round: int
    loss: float
    comm_gb: float
    comm_up_gb: Optional[float] = None
    comm_down_gb: Optional[float] = None
    params_m: float = 0.0
    selected: List[int] = dataclasses.field(default_factory=list)
    edge_sh: Optional[List[float]] = None
    pruned: bool = False

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


class RunResult(NamedTuple):
    """``Trainer.run``'s result; ``evals`` lists ``(round, eval)``
    pairs, none until the eval hook is ported."""
    history: List[RoundRecord]
    evals: List[Tuple[int, Any]]
