"""Method registry (``repro/experiment/registry.py``): one table from
method name to trainer factory, so the runner and callers resolve
trainers by name.  Extensions register their own::

    from repro_torch.experiment import register_method

    def make_my_method(spec, cfg, clients, eval_fn, device):
        return MyTrainer(cfg, spec.fl, clients, device=device, ...)

    register_method("my-method", "hierarchical", make_my_method)

A factory returns an object of the
:class:`repro_torch.experiment.trainer.Trainer` protocol.  The port's
factories take the device the trainer runs on as a fifth argument.

The built-ins are the hierarchical ``fedphd`` and ``fedphd-os``.  The
reference's other methods are not ported yet; asking for one raises and
names the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.experiment.spec import TOPOLOGIES, ExperimentSpec

TrainerFactory = Callable  # (spec, cfg, clients, eval_fn, device) -> Trainer

# the reference's methods that wait for a later item
UNPORTED = {
    **{m: "A.9 (flat baselines)" for m in ("fedavg", "fedprox", "moon",
                                           "scaffold", "feddiffuse")},
    "fedavg-stale": "A.9 and A.10 (flat baselines, staleness)",
    "fedphd-stale": "A.10 (faults and staleness aggregation)",
}


@dataclasses.dataclass(frozen=True)
class MethodEntry:
    name: str
    topology: str                       # "hierarchical" | "flat"
    factory: TrainerFactory


_METHODS: Dict[str, MethodEntry] = {}


def register_method(name: str, topology: str, factory: TrainerFactory,
                    *, overwrite: bool = False) -> None:
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology {topology!r} not in {TOPOLOGIES}")
    if name in _METHODS and not overwrite:
        raise ValueError(f"method {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _METHODS[name] = MethodEntry(name, topology, factory)


def method_entry(name: str) -> MethodEntry:
    if name not in _METHODS:
        if name in UNPORTED:
            raise NotImplementedError(
                f"method {name!r} is not ported yet: ROADMAP "
                f"{UNPORTED[name]}; registered: {registered_methods()}")
        raise KeyError(f"unknown method {name!r}; registered: "
                       f"{registered_methods()}")
    return _METHODS[name]


def registered_methods() -> List[str]:
    return sorted(_METHODS)


def make_trainer(spec: ExperimentSpec, cfg: ModelConfig, clients,
                 eval_fn=None, *, device="cuda"):
    """Resolve ``spec.method`` and build its trainer on ``device``.
    Enabled obs raises: tracing is ROADMAP A.11."""
    entry = method_entry(spec.method)
    if spec.topology and spec.topology != entry.topology:
        raise ValueError(f"spec.topology={spec.topology!r} but method "
                         f"{spec.method!r} is {entry.topology}")
    if spec.obs.resolved_enabled:
        raise NotImplementedError("obs tracing (spec.obs or $FEDPHD_OBS) "
                                  "is ROADMAP A.11")
    return entry.factory(spec, cfg, clients, eval_fn, device)


# ---------------------------------------------------------------------------
# built-in methods
# ---------------------------------------------------------------------------

def _fedphd_factory(prune_mode: str = "") -> TrainerFactory:
    def make(spec: ExperimentSpec, cfg, clients, eval_fn, device):
        from repro_torch.core.hfl import FedPhD
        fl = spec.fl
        if prune_mode:
            fl = dataclasses.replace(fl, prune_mode=prune_mode)
        return FedPhD(cfg, fl, clients, rng_seed=spec.seed,
                      selection=spec.selection,
                      aggregation=spec.aggregation, prune=spec.prune,
                      lr=spec.lr, engine=spec.engine,
                      persistent_opt=spec.persistent_opt,
                      state_store=spec.state_store, mesh=spec.mesh,
                      eval_fn=eval_fn, eval_every=spec.eval_every,
                      fault=spec.fault, quant=spec.comm.quant,
                      device=device)
    return make


register_method("fedphd", "hierarchical", _fedphd_factory())
# FedPhD-OS: one-shot L2 pruning at r = 0 instead of sparse-train rounds
register_method("fedphd-os", "hierarchical", _fedphd_factory("oneshot_l2"))
