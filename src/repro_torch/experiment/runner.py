"""The port's single-run CLI (``repro/experiment/runner.py``): a JSON
spec or a named preset is the whole experiment, and ``--resume``
continues a killed run from its checkpoint::

    PYTHONPATH=src python -m repro_torch.experiment.runner \\
        --preset smoke --rounds 1 --out runs/smoke --device cpu
    PYTHONPATH=src python -m repro_torch.experiment.runner \\
        --out runs/smoke --resume --rounds 2 --device cpu

``--out`` receives what the reference's runner writes: ``spec.json``,
``ckpt.npz`` with ``ckpt.npz.manifest.json`` (the resumable checkpoint,
which ``python -m repro_torch.serve --ckpt`` serves) and
``history.json``.  ``--device`` defaults to ``cuda``.  ``--trace
[PATH]`` traces the run (:mod:`repro_torch.obs`; bare, to
``<out>/ckpt.npz.trace.jsonl``) and adds the trace's summary to the
metrics.

``--sweep grid.json`` switches to grid mode: the JSON is a
:class:`repro_torch.experiment.sweep.SweepSpec` (either package's), every
run trains and checkpoints under ``--out/runs/<run_id>/`` on
``--device``, the resumable manifest is ``--out/sweep.json`` and the
report ``--out/report.json`` and ``report.md``.  Re-invoking the same
command resumes; ``--max-runs N`` stops after N run attempts::

    PYTHONPATH=src python -m repro_torch.experiment.runner \\
        --sweep examples/sweep_smoke.json --out runs/sweep --device cpu

``--executor process`` runs one worker on a CUDA device; ``--executor
k8s --k8s-fake`` drives the k8s executor against the in-memory
``FakeCluster``.

A spec with a ``mesh`` runs one process a device, every rank the same
command (``torchrun --nproc-per-node N -m
repro_torch.experiment.runner --spec mesh.json ...``); rank 0 alone
writes ``--out`` and prints.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Union

from repro_torch.configs.base import FLConfig
from repro_torch.experiment.cli import add_obs_flags, write_metrics
from repro_torch.experiment.report import report_markdown, write_report
from repro_torch.experiment.resolve import ENGINES, PRECISIONS
from repro_torch.experiment.run import Experiment, checkpoint_exists, run_spec
from repro_torch.experiment.spec import DataSpec, ExperimentSpec
from repro_torch.experiment.sweep import (EXECUTORS, SweepResult, SweepSpec,
                                          manifest_status, run_sweep)
from repro_torch.launch.mesh import is_writer
from repro_torch.obs.metrics import summarize_trace

PRESETS = {
    # the CI smoke config: 6 clients / 2 edges on the 16x16 smoke U-Net,
    # pruning at the round-2 cloud aggregation
    "smoke": ExperimentSpec(
        name="smoke", method="fedphd", model="ddpm-unet-smoke",
        fl=FLConfig(num_clients=6, num_edges=2, local_epochs=1,
                    edge_agg_every=1, cloud_agg_every=2, rounds=4,
                    sparse_rounds=2, prune_ratio=0.44, sh_a=1000.0),
        data=DataSpec(dataset="smoke", classes_per_client=1, batch_size=32)),
    # the paper's §V setup
    "paper": ExperimentSpec(
        name="paper", method="fedphd", model="ddpm-unet-cifar10",
        fl=FLConfig(num_clients=20, num_edges=2, local_epochs=1,
                    edge_agg_every=1, cloud_agg_every=5, rounds=100,
                    sparse_rounds=50, prune_ratio=0.44, sh_a=15000.0),
        data=DataSpec(dataset="cifar10-like", classes_per_client=2,
                      batch_size=32)),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.experiment.runner", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--spec", help="path to an ExperimentSpec JSON file")
    src.add_argument("--preset", choices=sorted(PRESETS), default="smoke",
                     help="named built-in spec (default: smoke)")
    src.add_argument("--sweep", help="path to a SweepSpec JSON file: run "
                                     "the whole grid with a resumable "
                                     "manifest and an aggregated report")
    ap.add_argument("--executor", choices=EXECUTORS,
                    help="[--sweep] run the grid in process (default), "
                         "over spawn-context worker processes (one on a "
                         "CUDA device), or as one Kubernetes Job a grid "
                         "point over shared storage")
    ap.add_argument("--max-workers", type=int,
                    help="[--sweep --executor process|k8s] pool size / "
                         "max in-flight Jobs")
    ap.add_argument("--k8s-fake", action="store_true",
                    help="[--sweep --executor k8s] drive the executor "
                         "against the in-memory FakeCluster (no cluster, "
                         "no kubernetes package)")
    ap.add_argument("--image", default="repro:latest",
                    help="[--sweep --executor k8s] container image for "
                         "worker Jobs (default: repro:latest)")
    ap.add_argument("--namespace", default=None,
                    help="[--sweep --executor k8s] Kubernetes namespace "
                         "(default: default)")
    ap.add_argument("--max-runs", type=int,
                    help="[--sweep] stop after this many run attempts "
                         "in this invocation (failures count); the "
                         "manifest stays resumable")
    ap.add_argument("--group-by",
                    help="[--sweep] comma-separated axes for the "
                         "aggregated report (default: the sweep's "
                         "group_by, else its non-seed axes)")
    ap.add_argument("--timeout-s", type=float,
                    help="[--sweep --executor process|k8s] wall-clock "
                         "budget per run attempt; a run exceeding it is "
                         "killed and retried or quarantined")
    ap.add_argument("--max-retries", type=int,
                    help="[--sweep] retry a crashed or hung run this many "
                         "times (exponential backoff, resuming from its "
                         "checkpoint) before quarantining it as failed "
                         "(default 0)")
    ap.add_argument("--method", help="override spec.method (registry key)")
    ap.add_argument("--engine", choices=ENGINES, help="override spec.engine")
    ap.add_argument("--precision", choices=PRECISIONS,
                    help="override spec.precision")
    add_obs_flags(ap)
    ap.add_argument("--metrics", default=None,
                    help="write the JSON metrics file here (flat keys + "
                         "{schema, kind})")
    ap.add_argument("--seed", type=int, help="override spec.seed")
    ap.add_argument("--eval-every", type=int,
                    help="override spec.eval_every (the hook DDIM-samples "
                         "64 images in 10 steps and records the proxy "
                         "inception score in RoundRecord.eval)")
    ap.add_argument("--rounds", type=int,
                    help="absolute target round (default spec.fl.rounds); "
                         "with --resume, rounds already in the checkpoint "
                         "are not run again")
    ap.add_argument("--out", default="runs/experiment",
                    help="output directory (spec, checkpoint, history)")
    ap.add_argument("--save-every", type=int, default=1,
                    help="checkpoint every this many rounds while running "
                         "(0: only at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <out>/ckpt.npz (the checkpointed "
                         "spec wins over spec overrides)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions); with --sweep, every run's")
    return ap


def _apply_overrides(spec: ExperimentSpec,
                     args: argparse.Namespace) -> ExperimentSpec:
    over = {k: getattr(args, a) for k, a in
            (("method", "method"), ("engine", "engine"), ("seed", "seed"),
             ("eval_every", "eval_every"), ("precision", "precision"))
            if getattr(args, a) is not None}
    if args.trace is not None:
        # --trace [PATH]: an explicitly enabled ObsSpec that keeps the
        # spec's other obs knobs (flush_every from a spec file)
        over["obs"] = spec.obs.replace(enabled=True,
                                       trace=args.trace or spec.obs.trace)
    return spec.replace(**over) if over else spec


def _default_eval(params, cfg, r):
    """The CLI's eval hook: DDIM-sample 64 images in 10 steps from seed 0
    and score them with the proxy inception score."""
    from repro_torch.diffusion import sample_images
    from repro_torch.metrics import inception_score_proxy
    fake = sample_images(params, cfg, n=64, steps=10, seed=0)
    return {"is_proxy": float(inception_score_proxy(fake))}


def _main_sweep(args: argparse.Namespace) -> SweepResult:
    # single-run flags have no meaning on a grid: refuse them rather than
    # run something other than what the command line asked for
    bad = [flag for flag, val in (("--method", args.method),
                                  ("--engine", args.engine),
                                  ("--seed", args.seed),
                                  ("--eval-every", args.eval_every),
                                  ("--precision", args.precision),
                                  ("--trace", args.trace),
                                  ("--metrics", args.metrics))
           if val is not None]
    if args.resume:
        bad.append("--resume")
    if bad:
        raise SystemExit(
            f"--sweep is incompatible with {', '.join(bad)}: declare "
            "per-run fields in the sweep JSON (base/axes — obs.* axes "
            "cover tracing); sweep resume is automatic from the "
            "manifest and the aggregated metrics land in report.json")
    with open(args.sweep) as f:
        sweep = SweepSpec.from_json(f.read())
    if args.rounds is not None:
        sweep = sweep.replace(rounds=args.rounds)
    executor = args.executor or "sequential"
    if args.max_workers is not None and executor not in ("process", "k8s"):
        raise SystemExit("--max-workers requires --executor process "
                         "or k8s (the sequential executor runs one grid "
                         "point at a time)")
    if (args.k8s_fake or args.namespace is not None) and executor != "k8s":
        raise SystemExit("--k8s-fake/--namespace require --executor k8s")
    if executor == "k8s":
        # built here so that --k8s-fake can inject the in-memory cluster
        from repro_torch.experiment.cluster import FakeCluster, K8sExecutor
        executor = K8sExecutor(
            cluster=FakeCluster() if args.k8s_fake else None,
            image=args.image, namespace=args.namespace or "default",
            max_workers=args.max_workers,
            poll_s=0.0 if args.k8s_fake else 2.0)
    # the eval hook is live only on the sequential executor (a Python
    # callable cannot cross the spawn boundary), where a spec's
    # eval_every says so
    eval_fn = _default_eval if executor == "sequential" else None
    res = run_sweep(sweep, args.out, executor=executor,
                    max_workers=args.max_workers, limit=args.max_runs,
                    eval_fn=eval_fn, save_every=args.save_every,
                    timeout_s=args.timeout_s,
                    max_retries=args.max_retries or 0, device=args.device)
    group_by = [g.strip() for g in (args.group_by or "").split(",")
                if g.strip()] or None
    report = write_report(res.manifest, args.out, group_by=group_by)
    counts = manifest_status(res.manifest)
    print(report_markdown(report))
    print(f"[{sweep.name}] {counts['done']}/{len(res.manifest['runs'])} "
          f"runs done ({counts['pending']} pending, "
          f"{counts['failed']} failed) -> {args.out}")
    if counts["failed"]:
        raise SystemExit(f"--sweep: {counts['failed']} run(s) failed "
                         f"(see {args.out}/sweep.json)")
    return res


def main(argv: Optional[Sequence[str]] = None
         ) -> Union[Experiment, SweepResult]:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.sweep:
        return _main_sweep(args)
    # the mirror of _main_sweep's guard: sweep-only flags mean nothing
    # on a single run, so refuse them rather than ignore them
    bad = [flag for flag, val in (("--executor", args.executor),
                                  ("--max-workers", args.max_workers),
                                  ("--max-runs", args.max_runs),
                                  ("--group-by", args.group_by),
                                  ("--timeout-s", args.timeout_s),
                                  ("--max-retries", args.max_retries),
                                  ("--namespace", args.namespace))
           if val is not None]
    if args.k8s_fake:
        bad.append("--k8s-fake")
    if args.image != "repro:latest":
        bad.append("--image")
    if bad:
        raise SystemExit(f"{', '.join(bad)} require --sweep")
    ckpt = os.path.join(args.out, "ckpt.npz")
    if args.resume:
        if not checkpoint_exists(ckpt):
            raise SystemExit(f"--resume: no checkpoint at {ckpt}")
        if args.trace:
            raise SystemExit("--trace PATH is incompatible with --resume "
                             "(the resumed trace appends to "
                             "<out>/ckpt.npz.trace.jsonl); use bare "
                             "--trace")
        # a resumed run replays the checkpointed spec, so --trace goes
        # through the environment leg of the resolution (an explicit
        # enabled=False in that spec still wins), for this run only
        env = os.environ.get("FEDPHD_OBS")
        if args.trace is not None:
            os.environ["FEDPHD_OBS"] = "on"
        try:
            exp = run_spec(None, rounds=args.rounds, ckpt=ckpt, resume=True,
                           save_every=args.save_every,
                           eval_fn=_default_eval, device=args.device)
        finally:
            if env is None:
                os.environ.pop("FEDPHD_OBS", None)
            else:
                os.environ["FEDPHD_OBS"] = env
    else:
        if args.spec:
            with open(args.spec) as f:
                spec = ExperimentSpec.from_json(f.read())
        else:
            spec = PRESETS[args.preset]
        spec = _apply_overrides(spec, args)
        exp = run_spec(spec, rounds=args.rounds, ckpt=ckpt,
                       save_every=args.save_every, eval_fn=_default_eval,
                       device=args.device)

    if not is_writer():         # rank 0 alone writes and reports
        return exp
    with open(os.path.join(args.out, "spec.json"), "w") as f:
        f.write(exp.spec.to_json() + "\n")
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump({"spec": exp.spec.to_dict(),
                   "history": [r.to_dict() for r in exp.history]},
                  f, indent=2)
        f.write("\n")

    last = exp.history[-1]
    total_comm = sum(r.comm_gb for r in exp.history)
    print(f"[{exp.spec.name}/{exp.spec.method}] round {last.round}: "
          f"loss={last.loss:.4f} params={last.params_m:.2f}M "
          f"total_comm={total_comm:.4f}GB eval={last.eval} -> {args.out}")
    metrics = {"name": exp.spec.name, "method": exp.spec.method,
               "rounds": last.round, "loss": last.loss,
               "params_m": last.params_m, "total_comm_gb": total_comm}
    if exp.tracer.enabled:
        exp.tracer.flush()
        ts = summarize_trace(exp.tracer.path)
        metrics.update(trace=exp.tracer.path,
                       overlap_ratio=ts["overlap_ratio"],
                       compiles=ts["compiles"],
                       recompiles=ts["recompiles"])
        print(f"trace -> {exp.tracer.path} "
              f"(overlap={ts['overlap_ratio']} compiles={ts['compiles']} "
              f"recompiles={ts['recompiles']})")
    if args.metrics:
        write_metrics(args.metrics, "experiment", metrics)
        print(f"wrote metrics to {args.metrics}")
    return exp


if __name__ == "__main__":
    main()
