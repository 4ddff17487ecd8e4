"""ObsSpec: the declarative, sweepable obs configuration
(``repro/obs/spec.py``).

A frozen dataclass field on ``ExperimentSpec``, JSON-round-trippable
(``to_dict``/``from_dict`` drop unknown keys, so old manifests keep
loading), addressable from sweep axes as ``"obs.enabled"`` etc.
``repro_torch.experiment.spec`` re-exports it.

``enabled`` is a tri-state: ``None`` (the default) defers to
``$FEDPHD_OBS`` through :func:`repro_torch.experiment.resolve.resolve_obs`,
so a spec that never mentions obs can still be traced from the
environment, while an explicit ``True``/``False`` always wins.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.experiment.resolve import resolve_obs


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Tracing and metrics configuration (disabled by default)."""
    # tri-state: True/False are explicit; None resolves $FEDPHD_OBS > off
    enabled: Optional[bool] = None
    # trace.jsonl path; "" = next to the run's checkpoint (or the CWD)
    trace: str = ""
    # events buffered before a file flush; 1 = write-through
    flush_every: int = 1
    # watch the host caches and flag growth the tracker did not expect
    compile_tracking: bool = True

    def __post_init__(self):
        if self.flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got "
                             f"{self.flush_every}")

    @property
    def resolved_enabled(self) -> bool:
        """``enabled`` if explicit, else ``$FEDPHD_OBS`` > off."""
        return resolve_obs(None if self.enabled is None else
                           ("on" if self.enabled else "off"))

    def replace(self, **kw) -> "ObsSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ObsSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
