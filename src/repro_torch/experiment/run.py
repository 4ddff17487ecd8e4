"""Running an experiment (``repro/experiment/run.py``): spec -> trainer ->
run -> checkpoint and resume.

:class:`Experiment` builds a spec's model config, clients and trainer
and drives its rounds; ``save`` and ``load`` carry the trainer's
``state()``/``restore()`` through the npz + manifest checkpoint, with
the spec in the metadata.  A resumed run is bitwise equal to an
unbroken one on the CPU, on either engine
(``tests/test_torch_experiment.py``).  The trainer's arrays and host
streams use the reference's keys, so the reference loads the port's
checkpoint and the reverse; the generator's state (``torch_rng``) is
the port's own.  ``spec.obs`` enabled (or ``$FEDPHD_OBS``) traces the
run to ``obs.trace`` or, by default, ``<ckpt>.trace.jsonl``; a resumed
run appends to the same file behind a new ``meta`` line.

On a world of several ranks (a spec with a ``mesh``, one process a
device) every rank runs the experiment and holds the same trainer
state, so rank 0 alone writes the checkpoint and the trace
(:func:`repro_torch.launch.mesh.is_writer`); every rank reads the
checkpoint on resume.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.experiment.data import make_clients
from repro_torch.experiment.registry import make_trainer
from repro_torch.experiment.spec import ExperimentSpec
from repro_torch.fl.client import Client
from repro_torch.fl.record import RoundRecord
from repro_torch.launch.mesh import is_writer
from repro_torch.obs.trace import NULL_TRACER, make_tracer

CKPT_FORMAT = 1


class Experiment:
    """A spec bound to live state: clients, trainer and history, on
    ``device``.  ``clients`` may be injected; by default they come from
    ``spec.data``, and ``images``/``labels`` keep the whole dataset.
    ``eval_fn(params, cfg, round)`` runs every ``spec.eval_every``
    rounds, its result in ``RoundRecord.eval``.  ``tracer`` is
    ``make_tracer(spec.obs, default_path=trace_path)``: the NULL_TRACER
    unless ``spec.obs`` resolves enabled."""

    def __init__(self, spec: ExperimentSpec, *,
                 clients: Optional[List[Client]] = None,
                 eval_fn: Optional[Callable] = None,
                 trace_path: Optional[str] = None, device="cuda"):
        self.spec = spec
        self.model_cfg = get_config(spec.model)
        if spec.backend:
            self.model_cfg = self.model_cfg.replace(backend=spec.backend)
        if spec.precision:
            self.model_cfg = self.model_cfg.replace(precision=spec.precision)
        self.images = self.labels = None
        if clients is None:
            clients, self.images, self.labels = make_clients(spec)
        self.clients = clients
        self.tracer = make_tracer(spec.obs, default_path=trace_path) \
            if is_writer() else NULL_TRACER
        self.trainer = make_trainer(spec, self.model_cfg, clients, eval_fn,
                                    tracer=self.tracer, device=device)

    # the current (possibly pruned) config, params and history
    @property
    def cfg(self):
        return self.trainer.cfg

    @property
    def params(self):
        return self.trainer.params

    @property
    def history(self) -> List[RoundRecord]:
        return self.trainer.history

    @property
    def next_round(self) -> int:
        return len(self.trainer.history) + 1

    def run(self, rounds: Optional[int] = None, *,
            ckpt: Optional[str] = None,
            save_every: int = 0) -> List[RoundRecord]:
        """Advance to round ``rounds`` (absolute; default
        ``spec.fl.rounds``); nothing to do if the history is there.
        With ``ckpt`` and ``save_every=k`` a checkpoint is written every
        k rounds before the last (the final save is ``run_spec``'s).
        Rounds are stepped (``run_round``), not pipelined: a checkpoint
        between rounds needs the round finished, and the pipeline would
        hold a second round's state on the card."""
        target = rounds or self.spec.fl.rounds
        for r in range(self.next_round, target + 1):
            self.trainer.run_round(r)
            if ckpt and save_every and r % save_every == 0 and r < target:
                self.save(ckpt)
        self.tracer.flush()
        return self.trainer.history

    # -- checkpointing -------------------------------------------------------
    def save(self, path: str) -> None:
        """One checkpoint (npz + manifest): the trainer's arrays and
        streams, its history and the spec; written by rank 0 alone."""
        if not is_writer():
            return
        arrays, meta = self.trainer.state()
        meta = {**meta, "spec": self.spec.to_dict(), "format": CKPT_FORMAT}
        checkpoint.save(path, arrays, metadata=meta)

    @classmethod
    def load(cls, path: str, *, clients: Optional[List[Client]] = None,
             eval_fn: Optional[Callable] = None,
             device="cuda") -> "Experiment":
        """Rebuild the experiment from its checkpoint and restore its
        state; ``clients`` only if the run injected its own.  A traced
        run's tracer appends to ``<path>.trace.jsonl`` behind a new
        ``meta`` line, so the earlier sessions' spans stay."""
        arrays, meta = checkpoint.load(path)
        spec = ExperimentSpec.from_dict(meta["spec"])
        exp = cls(spec, clients=clients, eval_fn=eval_fn,
                  trace_path=default_trace_path(path), device=device)
        exp.trainer.restore(arrays, meta)
        return exp


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path + ".manifest.json")


def default_trace_path(ckpt: Optional[str]) -> Optional[str]:
    """Where a traced run writes when ``obs.trace`` is unset: next to the
    checkpoint (``<ckpt>.trace.jsonl``), or None (``trace.jsonl`` in the
    CWD, :func:`repro_torch.obs.trace.make_tracer`)."""
    return (ckpt + ".trace.jsonl") if ckpt else None


def run_spec(spec: Optional[ExperimentSpec], *, rounds: Optional[int] = None,
             clients: Optional[List[Client]] = None,
             eval_fn: Optional[Callable] = None,
             ckpt: Optional[str] = None, resume: bool = False,
             save_every: int = 1, device="cuda") -> Experiment:
    """Build (or, with ``resume``, load from ``ckpt``) and run an
    experiment on ``device``.  A resumed run takes the checkpoint's spec
    (``spec`` must be None; ``rounds`` extends the run).  With ``ckpt``
    the state is saved every ``save_every`` rounds and after the last."""
    if resume:
        if spec is not None:
            raise ValueError("resume=True loads the checkpointed spec; "
                             "pass spec=None (use rounds= to extend the "
                             "run)")
        if not (ckpt and checkpoint_exists(ckpt)):
            raise FileNotFoundError(f"resume requested but no checkpoint "
                                    f"at {ckpt!r}")
        exp = Experiment.load(ckpt, clients=clients, eval_fn=eval_fn,
                              device=device)
    else:
        exp = Experiment(spec, clients=clients, eval_fn=eval_fn,
                         trace_path=default_trace_path(ckpt), device=device)
    exp.run(rounds, ckpt=ckpt, save_every=save_every)
    if ckpt:
        exp.save(ckpt)
    exp.tracer.flush()
    return exp
