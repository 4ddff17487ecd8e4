"""The ``Trainer`` protocol every registered method satisfies
(``repro/experiment/trainer.py``)."""
from __future__ import annotations

from typing import Any, Dict, List, Protocol, Tuple, runtime_checkable

from repro_torch.fl.record import RoundRecord, RunResult


@runtime_checkable
class Trainer(Protocol):
    """One federated trainer, round-stepped and checkpointable.

    - ``history`` holds one :class:`RoundRecord` a round.
    - ``eval_fn(params, cfg, round)`` runs every ``eval_every`` rounds
      inside ``run_round``; its result goes to ``RoundRecord.eval``.
    - ``state()`` returns ``(arrays, meta)``: a tree for
      ``repro_torch.checkpoint.save`` and JSON-serializable metadata;
      ``restore(arrays, meta)`` on a trainer built with the same
      arguments resumes the run, bitwise on the CPU.
    """

    history: List[RoundRecord]
    params: Any

    def run_round(self, r: int) -> RoundRecord: ...

    def run(self, rounds: int) -> RunResult: ...

    def state(self) -> Tuple[Any, Dict[str, Any]]: ...

    def restore(self, arrays: Any, meta: Dict[str, Any]) -> None: ...
