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

The built-ins are the hierarchical ``fedphd`` and ``fedphd-os``, the
flat baselines ``fedavg``, ``fedprox``, ``moon``, ``scaffold`` and
``feddiffuse`` (:class:`repro_torch.fl.baselines.FlatTrainer`), and the
staleness ablations ``fedphd-stale`` and ``fedavg-stale``: FedAvg over
the on-time reporters with the late deltas merged a round later, which
only differ from FedAvg under a ``spec.fault`` that makes stragglers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.experiment.spec import TOPOLOGIES, ExperimentSpec

TrainerFactory = Callable  # (spec, cfg, clients, eval_fn, device) -> Trainer

# the reference's methods that wait for a later item (name -> item)
UNPORTED: Dict[str, str] = {}


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
                 eval_fn=None, *, tracer=None, device="cuda"):
    """Resolve ``spec.method`` and build its trainer on ``device``.

    ``tracer`` (a live :class:`repro_torch.obs.Tracer`) is bound after
    construction through the trainer's ``bind_tracer``, so the factory
    signature stays as it is and third-party registrations keep
    working; a trainer without ``bind_tracer`` is not traced."""
    entry = method_entry(spec.method)
    if spec.topology and spec.topology != entry.topology:
        raise ValueError(f"spec.topology={spec.topology!r} but method "
                         f"{spec.method!r} is {entry.topology}")
    trainer = entry.factory(spec, cfg, clients, eval_fn, device)
    if tracer is not None and tracer.enabled:
        bind = getattr(trainer, "bind_tracer", None)
        if bind is not None:
            bind(tracer)
    return trainer


def _spec_mesh(spec: ExperimentSpec, device):
    """``spec.mesh`` ({axis -> size} or None) as a live ``DeviceMesh`` on
    ``device``'s type (:func:`repro_torch.launch.mesh.make_spec_mesh`)."""
    if not spec.mesh:
        return None
    from repro_torch.launch.mesh import make_spec_mesh   # starts a world
    return make_spec_mesh(spec.mesh, device=device)


# ---------------------------------------------------------------------------
# built-in methods
# ---------------------------------------------------------------------------

def _fedphd_factory(prune_mode: str = "",
                    aggregation: str = "") -> TrainerFactory:
    def make(spec: ExperimentSpec, cfg, clients, eval_fn, device):
        from repro_torch.core.hfl import FedPhD
        fl = spec.fl
        if prune_mode:
            fl = dataclasses.replace(fl, prune_mode=prune_mode)
        return FedPhD(cfg, fl, clients, rng_seed=spec.seed,
                      selection=spec.selection,
                      aggregation=aggregation or spec.aggregation,
                      prune=spec.prune,
                      lr=spec.lr, engine=spec.engine,
                      persistent_opt=spec.persistent_opt,
                      state_store=spec.state_store,
                      mesh=_spec_mesh(spec, device),
                      eval_fn=eval_fn, eval_every=spec.eval_every,
                      fault=spec.fault, quant=spec.comm.quant,
                      device=device)
    return make


register_method("fedphd", "hierarchical", _fedphd_factory())
# FedPhD-OS: one-shot L2 pruning at r = 0 instead of sparse-train rounds
register_method("fedphd-os", "hierarchical", _fedphd_factory("oneshot_l2"))
# the staleness ablations (repro_torch.fl.faults)
register_method("fedphd-stale", "hierarchical",
                _fedphd_factory(aggregation="staleness"))


def _flat_factory(method: str, aggregation: str = "fedavg") -> TrainerFactory:
    def make(spec: ExperimentSpec, cfg, clients, eval_fn, device):
        from repro_torch.fl.baselines import FlatTrainer
        return FlatTrainer(method, cfg, spec.fl, clients, lr=spec.lr,
                           rng_seed=spec.seed, engine=spec.engine,
                           persistent_opt=spec.persistent_opt,
                           state_store=spec.state_store,
                           mesh=_spec_mesh(spec, device),
                           eval_fn=eval_fn, eval_every=spec.eval_every,
                           aggregation=aggregation, fault=spec.fault,
                           quant=spec.comm.quant, device=device)
    return make


register_method("fedavg-stale", "flat",
                _flat_factory("fedavg", aggregation="staleness"))


# the paper's Table II baselines (repro_torch.fl.baselines.FLAT_METHODS)
for _m in ("fedavg", "fedprox", "feddiffuse", "moon", "scaffold"):
    register_method(_m, "flat", _flat_factory(_m))
