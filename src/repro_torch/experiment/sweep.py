"""Sweeps (``repro/experiment/sweep.py``): axis grids over
:class:`ExperimentSpec` with a resumable on-disk manifest, run through
the port's :func:`repro_torch.experiment.run.run_spec`.

A :class:`SweepSpec` is a base spec plus ``axes`` mapping any (possibly
dotted: ``fl.*``, ``data.*``, ``comm.*``, ``fault.*``, ``obs.*``) spec
field to a list of values, with ``include`` points, ``exclude`` matches
and dedup on the concrete spec::

    SweepSpec(name="table2",
              base=ExperimentSpec(model="ddpm-unet-smoke"),
              axes={"method": ["fedphd", "fedavg"], "seed": [0, 1, 2],
                    "data.alpha": [0.1, 0.5]},
              exclude=[{"method": "fedavg", "data.alpha": 0.1}])

``expand()`` gives the reference's run ids and order (sorted axes,
``k=v`` pairs: ``data.alpha=0.1,method=fedphd,seed=2``), and a sweep
JSON loads in either package.  ``run_sweep()`` keeps the manifest
(``sweep.json``) up to date after every change; each run checkpoints
into ``runs/<run_id>/ckpt.npz``, so a killed sweep resumes mid-grid
(done runs are skipped) and mid-run (``run_spec(resume=True)``).

Executors: ``sequential`` (in process; the only one a Python
``eval_fn`` reaches), ``process`` (spawn-context worker processes) and
``k8s`` (:class:`repro_torch.experiment.cluster.K8sExecutor`, one Job a
grid point over shared storage, testable in memory with
``FakeCluster``).  The device is an argument of ``run_sweep``, the
executors and the workers (default ``cuda``), never a spec field, so
one sweep JSON drives either package.  On a CUDA device the process
executor runs one worker: the vectorized engine sizes its client chunk
from the whole card's memory (``fl/engine.py:client_chunk``), so two
workers on one card would each plan for all of it.

Aggregation is :mod:`repro_torch.experiment.report`; the CLI is
``python -m repro_torch.experiment.runner --sweep sweep.json``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import time
import traceback
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

from repro_torch.experiment.run import checkpoint_exists, run_spec
from repro_torch.experiment.spec import ExperimentSpec

MANIFEST_FORMAT = 1
MANIFEST_NAME = "sweep.json"
EXECUTORS = ("sequential", "process", "k8s")
STATUSES = ("pending", "running", "done", "failed")


# ---------------------------------------------------------------------------
# Dotted spec paths: one namespace over ExperimentSpec and its nested
# frozen dataclasses (fl.*, data.*, comm.*, fault.*, obs.*).
# ---------------------------------------------------------------------------

def spec_get(spec: Any, path: str) -> Any:
    """Read a (possibly dotted) field: ``spec_get(s, "fl.rounds")``.
    Works on ExperimentSpec objects and their ``to_dict()`` form."""
    obj = spec
    for part in path.split("."):
        if isinstance(obj, Mapping):
            if part not in obj:
                raise ValueError(f"unknown sweep axis {path!r}")
            obj = obj[part]
        else:
            if not hasattr(obj, part):
                raise ValueError(f"unknown sweep axis {path!r}")
            obj = getattr(obj, part)
    return obj


def spec_with(spec: ExperimentSpec,
              overrides: Mapping[str, Any]) -> ExperimentSpec:
    """Apply ``{dotted_path: value}`` overrides to a spec.  One level of
    nesting is all the spec has (``fl.*``, ``data.*``, ``comm.*``,
    ``fault.*``, ``obs.*``); unknown fields raise ValueError naming the
    offending axis."""
    top: Dict[str, Any] = {}
    nested: Dict[str, Dict[str, Any]] = {}
    for path, v in overrides.items():
        head, _, rest = path.partition(".")
        if rest:
            if "." in rest:
                raise ValueError(f"sweep axis {path!r} nests too deep")
            nested.setdefault(head, {})[rest] = v
        else:
            top[head] = v
    for head, kw in nested.items():
        sub = getattr(spec, head, None)
        if not dataclasses.is_dataclass(sub):
            raise ValueError(f"unknown sweep axis {head!r} (not a nested "
                             "spec field)")
        try:
            top[head] = dataclasses.replace(sub, **kw)
        except TypeError:
            bad = sorted(set(kw) - {f.name for f in dataclasses.fields(sub)})
            raise ValueError(f"unknown sweep axis '{head}.{bad[0]}'")
    unknown = sorted(set(top) - {f.name for f in dataclasses.fields(spec)})
    if unknown:
        raise ValueError(f"unknown sweep axis {unknown[0]!r}")
    return spec.replace(**top)


# run-ids must be filesystem-safe (they name the per-run checkpoint
# directories) and stable across expansions: sorted axes, "k=v" pairs
_ID_KEEP = re.compile(r"[^A-Za-z0-9._=,+-]+")


def run_id_of(overrides: Mapping[str, Any]) -> str:
    """Stable, filesystem-safe id of one grid point (sorted overrides)."""
    if not overrides:
        return "base"
    parts = ",".join(f"{k}={overrides[k]}" for k in sorted(overrides))
    return _ID_KEEP.sub("-", parts)


class SweepRun(NamedTuple):
    """One expanded grid point: its stable id, the axis overrides that
    produced it, and the concrete spec."""
    run_id: str
    overrides: Dict[str, Any]
    spec: ExperimentSpec


# ---------------------------------------------------------------------------
# SweepSpec.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A declarative grid over :class:`ExperimentSpec`.

    ``axes`` maps dotted spec paths to value lists; ``include`` appends
    explicit override points beyond the product; ``exclude`` drops any
    expanded point whose *effective* values (override or base) match all
    of an exclude entry's keys.  ``rounds`` optionally overrides the
    absolute target round of every run (default: each spec's
    ``fl.rounds``); ``group_by`` is the default report grouping
    (default: every non-seed axis — seeds are what mean±std runs over).
    """
    name: str = "sweep"
    base: ExperimentSpec = ExperimentSpec()
    axes: Mapping[str, Sequence[Any]] = \
        dataclasses.field(default_factory=dict)
    include: Tuple[Mapping[str, Any], ...] = ()
    exclude: Tuple[Mapping[str, Any], ...] = ()
    rounds: Optional[int] = None
    group_by: Tuple[str, ...] = ()

    def __post_init__(self):
        # canonicalize container types (lists are the natural JSON and
        # call-site form) so equality and round-trips are type-agnostic
        object.__setattr__(self, "axes",
                           {k: list(v) for k, v in self.axes.items()})
        object.__setattr__(self, "include",
                           tuple(dict(p) for p in self.include))
        object.__setattr__(self, "exclude",
                           tuple(dict(p) for p in self.exclude))
        object.__setattr__(self, "group_by", tuple(self.group_by))

    def replace(self, **kw) -> "SweepSpec":
        return dataclasses.replace(self, **kw)

    def default_group_by(self) -> Tuple[str, ...]:
        explicit = tuple(self.group_by)
        if explicit:
            return explicit
        axes = tuple(k for k in sorted(self.axes) if k != "seed")
        return axes or ("method",)

    # -- expansion -----------------------------------------------------------
    def expand(self) -> List[SweepRun]:
        """Concrete (run_id, overrides, spec) points: cartesian product
        over sorted axes, plus ``include``, minus ``exclude``, deduped
        on the concrete spec.  Deterministic order; id collisions
        between distinct specs are an error."""
        keys = sorted(self.axes)
        grid = [dict(zip(keys, combo))
                for combo in itertools.product(*(tuple(self.axes[k])
                                                 for k in keys))] \
            if keys else [{}]
        points = grid + [dict(inc) for inc in self.include]

        runs: List[SweepRun] = []
        seen_specs: Dict[str, str] = {}    # canonical spec json -> run_id
        by_id: Dict[str, str] = {}         # run_id -> canonical spec json
        for overrides in points:
            if any(self._matches(overrides, exc) for exc in self.exclude):
                continue
            spec = spec_with(self.base, overrides)
            canon = spec.to_json(indent=0)
            if canon in seen_specs:        # include duplicating a grid point
                continue
            rid = run_id_of(overrides)
            if rid in by_id:
                raise ValueError(f"run-id collision: {rid!r} maps to two "
                                 "distinct specs")
            seen_specs[canon] = rid
            by_id[rid] = canon
            runs.append(SweepRun(
                rid, dict(overrides),
                spec.replace(name=f"{self.name}/{rid}")))
        return runs

    def _matches(self, overrides: Mapping[str, Any],
                 exc: Mapping[str, Any]) -> bool:
        return all(overrides.get(k, spec_get(self.base, k)) == v
                   for k, v in exc.items())

    # -- JSON round-trip -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "base": self.base.to_dict(),
            "axes": {k: list(v) for k, v in self.axes.items()},
            "include": [dict(p) for p in self.include],
            "exclude": [dict(p) for p in self.exclude],
            "rounds": self.rounds,
            "group_by": list(self.group_by),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SweepSpec":
        # strict: a typoed key ("axis", "excludes") must not silently
        # run a different grid than the file declares
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown SweepSpec field(s): "
                             f"{sorted(unknown)}")
        return cls(
            name=d.get("name", "sweep"),
            base=ExperimentSpec.from_dict(d.get("base", {})),
            axes={k: list(v) for k, v in d.get("axes", {}).items()},
            include=tuple(dict(p) for p in d.get("include", ())),
            exclude=tuple(dict(p) for p in d.get("exclude", ())),
            rounds=d.get("rounds"),
            group_by=tuple(d.get("group_by", ())),
        )

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "SweepSpec":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Manifest: the sweep's single source of truth on disk.
# ---------------------------------------------------------------------------

def manifest_path(out: str) -> str:
    return os.path.join(out, MANIFEST_NAME)


def load_manifest(out: str) -> Optional[dict]:
    path = manifest_path(out)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_manifest(out: str, man: dict) -> None:
    """Atomic write (tmp + rename): a kill mid-write must not corrupt
    the resume state."""
    path = manifest_path(out)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _run_ckpt(rid: str) -> str:
    # stored relative to the sweep dir so the whole tree is relocatable
    return os.path.join("runs", rid, "ckpt.npz")


def _trace_span(entry: dict, name: str, t0: float, t1: float,
                **attrs) -> None:
    """Append an executor-side span to the run's manifest trace.

    Same shape as the obs trace.jsonl span lines (repro_torch.obs.trace) but
    with ``time.time()`` epoch stamps — manifest spans must stay
    comparable across executor invocations, since retries and
    kill-and-resume spread one run's attempts over several processes.
    Stored unconditionally: the executor path is cold (per attempt, not
    per round), so there is nothing to protect with an obs gate, and
    the queue/retry/backoff/preemption record survives in ``sweep.json``
    for ``repro_torch.experiment.report`` to aggregate.

    Span names: ``sweep/queue`` (ready -> launch/submit),
    ``sweep/attempt`` (launch -> settle; ``attrs.outcome`` in done |
    error | timeout | worker-died | preempted | incomplete |
    submit-error), ``sweep/backoff`` (the scheduled retry delay).
    """
    entry.setdefault("trace", []).append(
        {"ev": "span", "name": name, "t0": t0, "t1": t1,
         "dur_s": t1 - t0, "attrs": attrs})


def init_manifest(sweep: SweepSpec, out: str) -> dict:
    """Create — or reconcile with — the on-disk manifest.

    An existing manifest's per-run statuses are kept for every run-id
    whose concrete spec is unchanged; runs whose spec changed (the sweep
    definition was edited) reset to pending, and run-ids no longer in
    the grid are dropped.  A fresh expansion therefore never loses
    completed work it can still trust.
    """
    runs = sweep.expand()
    prev = load_manifest(out) or {"runs": {}}
    man = {
        "format": MANIFEST_FORMAT,
        "sweep": sweep.to_dict(),
        "runs": {},
    }
    for run in runs:
        old = prev["runs"].get(run.run_id)
        spec_dict = run.spec.to_dict()
        if old is not None and old.get("spec") == spec_dict:
            man["runs"][run.run_id] = old
            # a run left "running" by a kill resumes from its checkpoint
            if old.get("status") == "running":
                old["status"] = "pending"
        else:
            man["runs"][run.run_id] = {
                "status": "pending",
                "overrides": run.overrides,
                "spec": spec_dict,
                "ckpt": _run_ckpt(run.run_id),
                "rounds_done": 0,
                "wall_s": 0.0,
                "history": [],
                "error": None,
                "attempts": 0,
                "trace": [],
            }
    os.makedirs(out, exist_ok=True)
    write_manifest(out, man)
    return man


def manifest_status(man: dict) -> Dict[str, int]:
    counts = {s: 0 for s in STATUSES}
    for entry in man["runs"].values():
        counts[entry["status"]] = counts.get(entry["status"], 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Execution.
# ---------------------------------------------------------------------------

class SweepResult(NamedTuple):
    """``run_sweep``'s return: the final manifest (also on disk at
    ``manifest_path(out)``) and the sweep dir."""
    manifest: dict
    out: str

    @property
    def complete(self) -> bool:
        return all(e["status"] == "done" for e in self.manifest["runs"].values())


def _ckpt_spec_matches(ckpt: str, spec_dict: dict) -> bool:
    """Cheap pre-resume check: the per-run checkpoint manifest records
    the spec it trained under; a stale checkpoint left by an EDITED
    sweep (different spec at the same run-id path) must be rerun, not
    resumed — otherwise the manifest would silently record the old
    spec's trajectory as the new run."""
    try:
        with open(ckpt + ".manifest.json") as f:
            meta = json.load(f).get("metadata", {})
    except (OSError, ValueError):
        return False
    return meta.get("spec") == spec_dict


def _finish_entry(entry: dict, history: List[dict],
                  wall_s: float) -> None:
    entry["status"] = "done"
    entry["error"] = None
    entry["wall_s"] = float(entry.get("wall_s") or 0.0) + wall_s
    entry["history"] = history
    entry["rounds_done"] = len(history)


def _target_rounds(sweep: SweepSpec, entry: Mapping[str, Any]) -> int:
    """The absolute round a run must reach: the sweep-level override,
    else the run's own ``fl.rounds`` — so re-invoking a finished sweep
    with a larger ``rounds`` EXTENDS every run instead of silently
    reporting the old, shorter histories as complete."""
    return sweep.rounds or spec_get(entry["spec"], "fl.rounds")


def _attempt(spec_dict: dict, ckpt: str, rounds: Optional[int],
             eval_fn, save_every: int, device="cuda"):
    """Run (or resume) ONE grid point on ``device`` — the shared
    resume-or-fresh core of every executor.  A retried run re-enters
    here and picks up the previous attempt's last per-round checkpoint,
    so a transient crash costs only the rounds since the last save.

    A stale checkpoint left by an EDITED sweep (different spec at the
    same run-id path) reruns fresh, not resumes."""
    t0 = time.perf_counter()
    if checkpoint_exists(ckpt) and _ckpt_spec_matches(ckpt, spec_dict):
        exp = run_spec(None, resume=True, ckpt=ckpt, rounds=rounds,
                       eval_fn=eval_fn, save_every=save_every,
                       device=device)
    else:
        exp = run_spec(ExperimentSpec.from_dict(spec_dict), ckpt=ckpt,
                       rounds=rounds, eval_fn=eval_fn,
                       save_every=save_every, device=device)
    return ([r.to_dict() for r in exp.history],
            time.perf_counter() - t0)


@dataclasses.dataclass
class ExecContext:
    """Everything an :class:`Executor` needs beyond the manifest: the
    sweep definition, the run-level policy knobs of ``run_sweep`` and
    the torch device every run trains on."""
    sweep: SweepSpec
    rounds: Optional[int] = None
    save_every: int = 1
    eval_fn: Any = None
    raise_on_error: bool = False
    timeout_s: Optional[float] = None
    max_retries: int = 0
    backoff_s: float = 1.0
    device: str = "cuda"

    def target_rounds(self, entry: Mapping[str, Any]) -> int:
        return _target_rounds(self.sweep, entry)


class Executor:
    """One way of running the pending grid points of a sweep.

    Subclasses set the capability flags (validated centrally by
    ``run_sweep`` so every executor rejects unsupported knobs the same
    way) and implement ``run``, which must drive each run-id in
    ``order`` to ``done``/``failed`` under the shared manifest contract:
    status transitions + ``write_manifest`` after every change, retries
    with exponential backoff, quarantine on exhausted retries, and
    ``raise_on_error`` aborting the grid with the failing run's error.
    """
    name = "abstract"
    supports_eval_fn = False    # can a Python callable reach the run?
    supports_timeout = False    # can a hung attempt be killed?

    def run(self, man: dict, out: str, order: List[str],
            ctx: ExecContext) -> None:
        raise NotImplementedError


class SequentialExecutor(Executor):
    """In-process, one run at a time — the reference executor (and the
    only one a Python ``eval_fn`` can reach)."""
    name = "sequential"
    supports_eval_fn = True
    supports_timeout = False

    def run(self, man: dict, out: str, order: List[str],
            ctx: ExecContext) -> None:
        t_exec0 = time.time()
        for rid in order:
            entry = man["runs"][rid]
            ckpt = os.path.join(out, entry["ckpt"])
            os.makedirs(os.path.dirname(ckpt), exist_ok=True)
            # queue = waiting in-process behind the earlier grid points
            _trace_span(entry, "sweep/queue", t_exec0, time.time())
            last_exc = None
            for attempt in range(1, ctx.max_retries + 2):
                if attempt > 1:
                    t_b = time.time()
                    time.sleep(ctx.backoff_s * 2 ** (attempt - 2))
                    _trace_span(entry, "sweep/backoff", t_b, time.time(),
                                attempt=attempt - 1)
                entry["status"] = "running"
                entry["attempts"] = int(entry.get("attempts") or 0) + 1
                write_manifest(out, man)
                t_a = time.time()
                try:
                    history, wall_s = _attempt(entry["spec"], ckpt,
                                               ctx.rounds, ctx.eval_fn,
                                               ctx.save_every, ctx.device)
                except Exception as e:  # noqa: BLE001 — recorded+retried
                    last_exc = e
                    _trace_span(entry, "sweep/attempt", t_a, time.time(),
                                attempt=int(entry["attempts"]),
                                outcome="error")
                    entry["error"] = traceback.format_exc()
                    entry["status"] = "pending"  # retry-eligible until
                    write_manifest(out, man)     # the for-else quarantines
                    continue
                _trace_span(entry, "sweep/attempt", t_a, time.time(),
                            attempt=int(entry["attempts"]), outcome="done")
                _finish_entry(entry, history, wall_s)
                write_manifest(out, man)
                break
            else:
                entry["status"] = "failed"        # retries exhausted
                write_manifest(out, man)
                if ctx.raise_on_error:
                    raise last_exc


class ProcessExecutor(Executor):
    """Spawn-context process pool: one worker process per in-flight run,
    wall-clock timeouts, grid-level parallelism on the CPU; one worker
    on a CUDA device (:func:`process_workers`).

    ``initializer`` (the port's addition, as ``multiprocessing.Pool``'s)
    is for registration: a picklable function, called with no arguments
    in each worker before its run, that registers the configs and
    datasets the run needs.  A spawned worker imports the package afresh
    and sees only the built-in ones."""
    name = "process"
    supports_eval_fn = False
    supports_timeout = True

    def __init__(self, max_workers: Optional[int] = None,
                 initializer=None):
        self.max_workers = max_workers
        self.initializer = initializer

    def run(self, man: dict, out: str, order: List[str],
            ctx: ExecContext) -> None:
        workers = process_workers(self.max_workers, len(order), ctx.device)
        _run_procs(man, out, order, ctx.rounds, workers,
                   ctx.save_every, ctx.raise_on_error, ctx.timeout_s,
                   ctx.max_retries, ctx.backoff_s, ctx.device,
                   self.initializer)


def process_workers(max_workers: Optional[int], n_runs: int,
                    device="cuda") -> int:
    """The process executor's pool size: ``max_workers``, by default
    ``min(n_runs, 4)``, on the CPU; one on a CUDA device, where more
    raises.  Each worker's vectorized engine sizes its client chunk
    from the whole card's memory (``fl/engine.py:client_chunk``), so two
    at once on one card would each plan for all of it."""
    if str(device).startswith("cuda"):
        if max_workers is not None and max_workers > 1:
            raise ValueError(
                f"max_workers={max_workers} on {device!r}: the process "
                "executor runs one worker a card, because each run sizes "
                "its client chunk from the whole card's memory "
                "(fl/engine.py:client_chunk) and two would each plan for "
                "all of it")
        return 1
    return max(max_workers or min(n_runs, 4), 1)


def resolve_executor(executor, max_workers: Optional[int] = None):
    """Name -> Executor instance; constructed instances pass through
    (the injection point for ``K8sExecutor(cluster=FakeCluster())``)."""
    if not isinstance(executor, str):
        # duck-typed so injected executors (e.g. cluster.K8sExecutor,
        # which avoids importing this module) need not subclass Executor
        if not callable(getattr(executor, "run", None)):
            raise TypeError(f"executor must be a name from {EXECUTORS} or "
                            f"an Executor-like instance with .run(), got "
                            f"{type(executor).__name__}")
        return executor
    if executor == "sequential":
        return SequentialExecutor()
    if executor == "process":
        return ProcessExecutor(max_workers=max_workers)
    if executor == "k8s":
        from repro_torch.experiment.cluster import K8sExecutor
        return K8sExecutor(max_workers=max_workers)
    raise ValueError(f"executor {executor!r} not in {EXECUTORS}")


def run_sweep(sweep: SweepSpec, out: str, *,
              executor: str = "sequential",
              max_workers: Optional[int] = None,
              limit: Optional[int] = None,
              eval_fn=None,
              save_every: int = 1,
              raise_on_error: bool = False,
              timeout_s: Optional[float] = None,
              max_retries: int = 0,
              backoff_s: float = 1.0,
              device="cuda") -> SweepResult:
    """Execute (or resume) a sweep into ``out``, every run on
    ``device`` (default ``cuda``; ``cpu`` runs the kernels' plain
    versions).

    The manifest at ``<out>/sweep.json`` is written before and after
    every run, and each run checkpoints through ``run_spec(ckpt=...)``,
    so a kill at ANY point resumes: completed runs are skipped, the
    interrupted run continues from its last per-round checkpoint, and
    the rest of the grid follows.  ``limit`` stops this invocation after
    that many run *attempts* — failures count, so a failing grid cannot
    spin — and the manifest stays resumable (the CI smoke job uses it
    as a deterministic "kill").

    ``executor`` is a name from :data:`EXECUTORS` or a constructed
    :class:`Executor`.  ``"process"`` fans runs out over spawn-context
    worker processes (one per in-flight run, one at a time on a CUDA
    device: :func:`process_workers`); ``"k8s"`` submits one
    containerized Job per run over shared storage
    (:mod:`repro_torch.experiment.cluster`).  A Python ``eval_fn`` cannot
    cross either boundary (use the sequential executor, or bake evals
    into a registered method).

    Fault tolerance: a crashed run is retried up to ``max_retries``
    times with exponential backoff (``backoff_s * 2**(attempt-1)``),
    resuming from its last checkpoint each time; exhausted retries
    quarantine the run as ``status="failed"`` with the LAST attempt's
    error in ``entry["error"]`` while the rest of the grid completes
    (unless ``raise_on_error``).  ``timeout_s`` (process/k8s executors)
    kills any single attempt exceeding the wall-clock budget — a hung
    run cannot stall the grid.
    """
    exe = resolve_executor(executor, max_workers)
    if eval_fn is not None and not exe.supports_eval_fn:
        raise ValueError("eval_fn cannot cross the process boundary; "
                         "use executor='sequential'")
    if timeout_s is not None and not exe.supports_timeout:
        raise ValueError("timeout_s needs executor='process' or 'k8s' (a "
                         "hung in-process run cannot be interrupted)")
    if isinstance(exe, ProcessExecutor):     # one worker a card
        process_workers(exe.max_workers, 1, device)
    man = init_manifest(sweep, out)
    # a "done" run re-enters the queue when the target round count grew
    # (sweep.rounds raised, or the base fl.rounds edited in place)
    order = [rid for rid, e in man["runs"].items()
             if e["status"] != "done"
             or e["rounds_done"] < _target_rounds(sweep, e)]
    if limit is not None:
        order = order[:max(limit, 0)]

    ctx = ExecContext(sweep=sweep, rounds=sweep.rounds,
                      save_every=save_every, eval_fn=eval_fn,
                      raise_on_error=raise_on_error, timeout_s=timeout_s,
                      max_retries=max_retries, backoff_s=backoff_s,
                      device=str(device))
    exe.run(man, out, order, ctx)
    return SweepResult(man, out)


def _proc_worker(conn, spec_dict: dict, ckpt: str, rounds: Optional[int],
                 save_every: int, device="cuda", initializer=None) -> None:
    """Process-executor child: run ONE grid point on ``device``, report
    the result (or the full traceback) back over the pipe.  Module-level
    for spawn picklability."""
    try:
        if initializer is not None:
            initializer()
        history, wall_s = _attempt(spec_dict, ckpt, rounds, None,
                                   save_every, device)
        conn.send(("done", history, wall_s))
    except Exception:  # noqa: BLE001 — shipped to the parent verbatim
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _run_procs(man: dict, out: str, order: List[str],
               rounds: Optional[int], workers: int,
               save_every: int, raise_on_error: bool,
               timeout_s: Optional[float], max_retries: int,
               backoff_s: float, device="cuda", initializer=None) -> None:
    """Process-per-run scheduler with wall-clock timeouts and retry,
    ``workers`` runs in flight.

    One spawn-context process per in-flight run (spawn, not fork: a
    forked child of a process with a live CUDA context cannot use CUDA;
    spawn re-imports repro_torch in each worker from PYTHONPATH),
    results returned over a Pipe.  A run whose attempt exceeds
    ``timeout_s`` is terminated (then killed) and treated like a crash;
    crashes requeue with exponential backoff until ``max_retries``
    attempts are exhausted, then quarantine as ``failed`` without
    stopping the grid.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    # (rid, attempt, not_before): retries wait out their backoff here
    ready: List[Tuple[str, int, float]] = [(rid, 1, 0.0) for rid in order]
    running: Dict[str, dict] = {}
    # epoch stamp of when each rid last became launchable (executor
    # start, or backoff expiry) — the t0 of its sweep/queue span
    ready_since: Dict[str, float] = {rid: time.time() for rid in order}

    def _launch(rid: str, attempt: int) -> None:
        entry = man["runs"][rid]
        entry["status"] = "running"
        entry["attempts"] = int(entry.get("attempts") or 0) + 1
        now = time.time()
        _trace_span(entry, "sweep/queue", ready_since.pop(rid, now), now,
                    attempt=int(entry["attempts"]))
        ckpt = os.path.join(out, entry["ckpt"])
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_proc_worker,
                           args=(send, entry["spec"], ckpt, rounds,
                                 save_every, device, initializer))
        proc.start()
        send.close()    # parent's copy of the child end must not keep
        running[rid] = {"proc": proc, "conn": recv,     # the pipe open
                        "attempt": attempt, "t0": time.time(),
                        "deadline": (time.monotonic() + timeout_s)
                        if timeout_s else None}
        write_manifest(out, man)

    def _attempt_span(rid: str, st: dict, outcome: str) -> None:
        _trace_span(man["runs"][rid], "sweep/attempt", st["t0"],
                    time.time(),
                    attempt=int(man["runs"][rid].get("attempts") or 0),
                    outcome=outcome)

    def _fail_or_retry(rid: str, attempt: int, err: str) -> bool:
        """Record the attempt's error; requeue with backoff or
        quarantine.  Returns True when the run is terminally failed."""
        entry = man["runs"][rid]
        entry["error"] = err
        if attempt <= max_retries:
            entry["status"] = "pending"
            nb = time.monotonic() + backoff_s * 2 ** (attempt - 1)
            now = time.time()
            _trace_span(entry, "sweep/backoff", now,
                        now + backoff_s * 2 ** (attempt - 1),
                        attempt=attempt)
            ready_since[rid] = now + backoff_s * 2 ** (attempt - 1)
            ready.append((rid, attempt + 1, nb))
        else:
            entry["status"] = "failed"
        write_manifest(out, man)
        return entry["status"] == "failed"

    def _reap(rid: str) -> dict:
        st = running.pop(rid)
        st["conn"].close()
        return st

    failed_rid = None
    while (ready or running) and failed_rid is None:
        while ready and len(running) < workers:
            i = next((j for j, (_, _, nb) in enumerate(ready)
                      if nb <= time.monotonic()), None)
            if i is None:
                break
            rid, attempt, _ = ready.pop(i)
            _launch(rid, attempt)
        progressed = False
        for rid in list(running):
            st = running[rid]
            proc = st["proc"]
            if st["conn"].poll():
                msg = st["conn"].recv()
                _reap(rid)
                proc.join()
                progressed = True
                if msg[0] == "done":
                    _attempt_span(rid, st, "done")
                    _finish_entry(man["runs"][rid], msg[1], msg[2])
                    write_manifest(out, man)
                else:
                    _attempt_span(rid, st, "error")
                    if _fail_or_retry(rid, st["attempt"], msg[1]) \
                            and raise_on_error:
                        failed_rid = rid
                        break
            elif st["deadline"] is not None \
                    and time.monotonic() > st["deadline"]:
                # hung (or just slow past the budget): terminate, then
                # kill if it ignores SIGTERM — the grid must not stall
                proc.terminate()
                proc.join(5)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
                _reap(rid)
                progressed = True
                _attempt_span(rid, st, "timeout")
                err = (f"TimeoutError: run exceeded "
                       f"timeout_s={timeout_s} (terminated)")
                if _fail_or_retry(rid, st["attempt"], err) \
                        and raise_on_error:
                    failed_rid = rid
                    break
            elif not proc.is_alive():
                # dead with no message: segfault / OOM-kill / external
                _reap(rid)
                progressed = True
                _attempt_span(rid, st, "worker-died")
                err = f"WorkerDied: exitcode={proc.exitcode}"
                if _fail_or_retry(rid, st["attempt"], err) \
                        and raise_on_error:
                    failed_rid = rid
                    break
        if not progressed:
            time.sleep(0.05)

    if failed_rid is not None:
        for st in running.values():    # raise_on_error: stop the grid
            st["proc"].terminate()
            st["proc"].join()
            st["conn"].close()
        write_manifest(out, man)
        raise RuntimeError(
            f"sweep run {failed_rid!r} failed after "
            f"{man['runs'][failed_rid].get('attempts')} attempt(s):\n"
            f"{man['runs'][failed_rid]['error']}")
