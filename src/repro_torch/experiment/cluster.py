"""Cluster execution (``repro/experiment/cluster.py``): the ``k8s``
sweep executor of the port.

One containerized Job per grid point over shared storage.  The executor
(:class:`K8sExecutor`) renders each pending manifest entry into a
``batch/v1`` Job (:func:`render_job`), submits it, polls pod phases,
streams failure logs into ``entry["error"]``, and reconciles the sweep
manifest from completed artifacts — reusing the retry/backoff/timeout/
quarantine semantics of the process executor and the kill-and-resume
idempotency of per-run checkpoints, so a **preempted** worker's next
attempt resumes from ``runs/<rid>/ckpt.npz`` instead of restarting.

The shared-storage contract per run-id (all under the sweep dir, which
a real cluster mounts into every pod):

    runs/<rid>/spec.json     written by the executor before submit
    runs/<rid>/ckpt.npz      written by the worker every ``save_every``
                             rounds (run_spec's checkpoint)
    runs/<rid>/result.json   written atomically by the worker ON
                             COMPLETION ONLY: {format, run_id, spec,
                             history, wall_s, rounds_done}

``result.json`` is the completion token: the executor trusts it only
when its embedded spec matches the manifest entry AND ``rounds_done``
reached the target — so a stale artifact from an edited sweep reruns,
and a sweep whose manifest was lost rebuilds purely from artifacts.

The cluster client is **injectable**: tier-1 tests drive the whole
executor against :class:`FakeCluster`, an in-memory double that runs
the worker entrypoint in-process (with deterministic preemption /
failure injection) — zero network, no kubernetes package.  The real
:class:`K8sCluster` imports ``kubernetes`` lazily and is only needed
against a live API server.

Worker entrypoint::

    python -m repro_torch.experiment.cluster --spec ... --ckpt ... \\
        --result ... --run-id ... [--rounds N] [--save-every K] \\
        [--device cuda]

What differs from the reference: the Job runs this module and passes
``--device`` (default ``cuda``) to the worker; its environment comes
from :func:`repro_torch.launch.env.host_env`; and a Job whose worker
trains on a CUDA device requests one GPU
(``resources.limits["nvidia.com/gpu"]``), where the reference's
``devices`` sets XLA's host-device count.  One run trains on one card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import time
import traceback
from typing import Any, Dict, List, Mapping, Optional, Tuple

# worker exit code for "stopped before the target round without a
# result" — what a SIGTERM'd/preempted pod looks like from the outside
PREEMPTED_EXIT = 143
RESULT_FORMAT = 1


# ---------------------------------------------------------------------------
# Shared-storage layout + artifacts.
# ---------------------------------------------------------------------------

def run_dir(out: str, rid: str) -> str:
    return os.path.join(out, "runs", rid)


def run_spec_path(out: str, rid: str) -> str:
    return os.path.join(run_dir(out, rid), "spec.json")


def run_result_path(out: str, rid: str) -> str:
    return os.path.join(run_dir(out, rid), "result.json")


def _write_json(path: str, obj: Any) -> None:
    """Atomic (tmp + rename): a pod killed mid-write must not leave a
    half result that a reconcile pass would half-trust."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_result(out: str, rid: str) -> Optional[dict]:
    """The run's completion artifact, or None (missing/corrupt)."""
    try:
        with open(run_result_path(out, rid)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def result_completes(res: Optional[dict], entry: Mapping[str, Any],
                     target: int) -> bool:
    """Does this artifact finish this manifest entry?  Spec must match
    (an edited sweep's stale artifact must rerun, not reconcile) and the
    recorded history must reach the target round."""
    return (res is not None and res.get("spec") == entry["spec"]
            and int(res.get("rounds_done") or 0) >= target)


# ---------------------------------------------------------------------------
# Worker entrypoint (runs inside the Job's container).
# ---------------------------------------------------------------------------

def worker_main(argv: Optional[List[str]] = None, *,
                _stop_after: Optional[int] = None) -> int:
    """Run ONE grid point from shared storage on ``--device`` and write
    its result.

    Resumes from the checkpoint when one exists for the SAME spec (the
    ``_attempt`` resume-or-fresh core), so the retry of a preempted Job
    continues instead of restarting.  ``_stop_after`` is the fault hook
    used by :class:`FakeCluster`: train only that many rounds, then
    exit ``PREEMPTED_EXIT`` *without* writing ``result.json`` — exactly
    what a node preemption after ``save_every`` checkpoints looks like.
    """
    p = argparse.ArgumentParser(prog="repro_torch.experiment.cluster")
    p.add_argument("--spec", required=True, help="spec.json path")
    p.add_argument("--ckpt", required=True, help="checkpoint path")
    p.add_argument("--result", required=True, help="result.json path")
    p.add_argument("--run-id", required=True)
    p.add_argument("--rounds", type=int, default=None,
                   help="absolute target round (default: spec fl.rounds)")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    # lazy: the sweep imports the trainer stack
    from repro_torch.experiment.sweep import _attempt
    with open(args.spec) as f:
        spec_dict = json.load(f)
    target = args.rounds or spec_dict["fl"]["rounds"]
    cap = min(target, _stop_after) if _stop_after is not None else target
    history, wall_s = _attempt(spec_dict, args.ckpt, cap, None,
                               args.save_every, args.device)
    print(f"[worker {args.run_id}] rounds {len(history)}/{target} "
          f"wall {wall_s:.2f}s")
    if len(history) < target:       # preempted before the target round:
        return PREEMPTED_EXIT       # no completion token on purpose
    _write_json(args.result, {
        "format": RESULT_FORMAT,
        "run_id": args.run_id,
        "spec": spec_dict,
        "history": history,
        "wall_s": wall_s,
        "rounds_done": len(history),
    })
    return 0


# ---------------------------------------------------------------------------
# Job spec rendering.
# ---------------------------------------------------------------------------

_NAME_BAD = re.compile(r"[^a-z0-9-]+")


def job_name(run_id: str, attempt: int) -> str:
    """DNS-1123-safe Job name: lowercased run-id with every illegal
    char collapsed to ``-``, an attempt suffix (retries must not
    collide with the dead Job's name), and a hash tiebreaker when
    truncation to 63 chars would alias distinct run-ids."""
    base = _NAME_BAD.sub("-", run_id.lower()).strip("-") or "run"
    name = f"sweep-{base}-a{attempt}"
    if len(name) > 63:
        h = hashlib.sha1(run_id.encode()).hexdigest()[:8]
        keep = 63 - len(f"sweep---{h}-a{attempt}")
        name = f"sweep-{base[:keep].strip('-')}-{h}-a{attempt}"
    return name


def render_job(*, run_id: str, attempt: int, image: str,
               spec_path: str, ckpt_path: str, result_path: str,
               rounds: Optional[int] = None, save_every: int = 1,
               namespace: str = "default",
               mount_path: Optional[str] = None,
               pvc: Optional[str] = None,
               env: Optional[Mapping[str, str]] = None,
               device: str = "cuda") -> dict:
    """One manifest entry -> a ``batch/v1`` Job dict.

    ``backoffLimit=0`` / ``restartPolicy=Never``: retries belong to the
    EXECUTOR (manifest-recorded, backoff-scheduled, checkpoint-resumed),
    not to kubelet — a silently restarted pod would double-count
    attempts.  The raw run-id rides in an annotation (labels cannot
    round-trip ``=``/``.``/``,``); the container env comes from
    :func:`repro_torch.launch.env.host_env`.  The worker trains on
    ``device`` and, when that is a CUDA device, requests one GPU
    (``resources.limits["nvidia.com/gpu"]``); a CPU worker requests
    none.
    """
    from repro_torch.launch import env as launch_env
    cmd = ["python", "-m", "repro_torch.experiment.cluster",
           "--spec", spec_path, "--ckpt", ckpt_path,
           "--result", result_path, "--run-id", run_id,
           "--save-every", str(save_every), "--device", str(device)]
    if rounds:
        cmd += ["--rounds", str(rounds)]
    env_map = launch_env.host_env()
    env_map.update(env or {})
    resources = ({"limits": {"nvidia.com/gpu": 1}}
                 if str(device).startswith("cuda") else {})
    volumes, mounts = [], []
    if mount_path:
        src = {"persistentVolumeClaim": {"claimName": pvc}} if pvc \
            else {"hostPath": {"path": mount_path,
                               "type": "DirectoryOrCreate"}}
        volumes.append({"name": "sweep", **src})
        mounts.append({"name": "sweep", "mountPath": mount_path})
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": job_name(run_id, attempt),
            "namespace": namespace,
            "labels": {"app": "repro-sweep"},
            "annotations": {"repro.run-id": run_id,
                            "repro.attempt": str(attempt)},
        },
        "spec": {
            "backoffLimit": 0,
            "template": {
                "metadata": {"labels": {"app": "repro-sweep"}},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": "run",
                        "image": image,
                        "command": cmd,
                        "env": [{"name": k, "value": str(v)}
                                for k, v in sorted(env_map.items())],
                        "volumeMounts": mounts,
                        "resources": resources,
                    }],
                    "volumes": volumes,
                },
            },
        },
    }


# ---------------------------------------------------------------------------
# Cluster clients.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JobStatus:
    """Pod-phase summary of one Job: ``Pending`` | ``Running`` |
    ``Succeeded`` | ``Failed`` (+ a human reason for failures)."""
    phase: str
    reason: str = ""


class ClusterClient:
    """What :class:`K8sExecutor` needs from a cluster — four calls.
    Implemented by :class:`K8sCluster` (real) and :class:`FakeCluster`
    (in-memory test double); anything with these methods injects."""

    def submit(self, job: dict) -> str:
        raise NotImplementedError

    def status(self, name: str) -> JobStatus:
        raise NotImplementedError

    def logs(self, name: str, tail: Optional[int] = None) -> str:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError


class FakeCluster(ClusterClient):
    """In-memory cluster: Jobs "run" by invoking :func:`worker_main`
    in-process at the first non-pending ``status()`` poll, against the
    same filesystem the executor writes — the full submit/poll/resume
    loop with zero network and no kubernetes dependency.

    Fault injection (all deterministic, consumed per submission):

    preempt_once:  {run_id: stop_after_rounds} — the run's NEXT Job
                   trains that many rounds then dies ``PREEMPTED_EXIT``
                   without a result (checkpoint intact), like a node
                   preemption.
    fail_reasons:  {run_id: reason} — the run's next Job fails without
                   executing at all (image pull errors, evictions).
    fail_submits:  reject every ``submit`` — used to prove reconcile
                   completes a sweep purely from on-disk artifacts.
    pending_polls: Jobs report ``Pending`` this many polls before
                   executing (scheduler latency).
    """

    def __init__(self, *, preempt_once: Optional[Mapping[str, int]] = None,
                 fail_reasons: Optional[Mapping[str, str]] = None,
                 fail_submits: bool = False, pending_polls: int = 0):
        self.preempt_once = dict(preempt_once or {})
        self.fail_reasons = dict(fail_reasons or {})
        self.fail_submits = fail_submits
        self.pending_polls = pending_polls
        self.jobs: Dict[str, dict] = {}
        self.submitted: List[str] = []
        self.preempted: List[str] = []
        self.deleted: List[str] = []

    def submit(self, job: dict) -> str:
        if self.fail_submits:
            raise RuntimeError("FakeCluster: submit rejected "
                               "(fail_submits=True)")
        name = job["metadata"]["name"]
        if name in self.jobs:
            raise ValueError(f"duplicate Job name {name!r}")
        for key in ("apiVersion", "kind", "metadata", "spec"):
            if key not in job:
                raise ValueError(f"malformed Job: missing {key!r}")
        self.jobs[name] = {
            "job": job,
            "run_id": job["metadata"]["annotations"]["repro.run-id"],
            "status": JobStatus("Pending"),
            "polls": 0, "log": "", "done": False,
        }
        self.submitted.append(name)
        return name

    def status(self, name: str) -> JobStatus:
        st = self.jobs[name]
        if st["done"]:
            return st["status"]
        st["polls"] += 1
        if st["polls"] <= self.pending_polls:
            return JobStatus("Pending")
        rid = st["run_id"]
        if rid in self.fail_reasons:
            st["status"] = JobStatus("Failed", self.fail_reasons.pop(rid))
            st["log"] = f"injected failure: {st['status'].reason}\n"
        else:
            st["status"] = self._execute(st)
        st["done"] = True
        return st["status"]

    def _execute(self, st: dict) -> JobStatus:
        cmd = st["job"]["spec"]["template"]["spec"]["containers"][0][
            "command"]
        argv = cmd[cmd.index("repro_torch.experiment.cluster") + 1:]
        stop = self.preempt_once.pop(st["run_id"], None)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(buf):
                rc = worker_main(argv, _stop_after=stop)
        except SystemExit as e:
            rc = int(e.code or 0)
        except Exception:   # noqa: BLE001 — the "pod" crashed; its
            st["log"] = buf.getvalue() + traceback.format_exc()
            return JobStatus("Failed", "Error")      # log tells why
        st["log"] = buf.getvalue()
        if rc == 0:
            return JobStatus("Succeeded")
        if rc == PREEMPTED_EXIT and stop is not None:
            self.preempted.append(st["run_id"])
            return JobStatus("Failed", "Preempted")
        return JobStatus("Failed", f"Exit({rc})")

    def logs(self, name: str, tail: Optional[int] = None) -> str:
        log = self.jobs[name]["log"]
        if tail:
            log = "\n".join(log.splitlines()[-tail:])
        return log

    def delete(self, name: str) -> None:
        self.jobs.pop(name, None)
        self.deleted.append(name)


class K8sCluster(ClusterClient):
    """Real cluster client over the ``kubernetes`` package (optional
    dependency — imported here, not at module import, so the executor
    and FakeCluster work without it)."""

    def __init__(self, namespace: str = "default"):
        try:
            from kubernetes import client, config   # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "executor='k8s' against a real cluster needs the "
                "'kubernetes' package (pip install kubernetes), or "
                "inject K8sExecutor(cluster=FakeCluster()) for the "
                "in-memory double") from e
        try:
            config.load_incluster_config()
        except Exception:   # noqa: BLE001 — not in a pod: use kubeconfig
            config.load_kube_config()
        self.namespace = namespace
        self._batch = client.BatchV1Api()
        self._core = client.CoreV1Api()

    def submit(self, job: dict) -> str:
        self._batch.create_namespaced_job(
            namespace=job["metadata"].get("namespace", self.namespace),
            body=job)
        return job["metadata"]["name"]

    def status(self, name: str) -> JobStatus:
        st = self._batch.read_namespaced_job_status(
            name=name, namespace=self.namespace).status
        if st.succeeded:
            return JobStatus("Succeeded")
        if st.failed:
            reason = ""
            for cond in st.conditions or []:
                if cond.type == "Failed":
                    reason = cond.reason or ""
            return JobStatus("Failed", reason)
        return JobStatus("Running" if st.active else "Pending")

    def logs(self, name: str, tail: Optional[int] = None) -> str:
        pods = self._core.list_namespaced_pod(
            namespace=self.namespace,
            label_selector=f"job-name={name}").items
        if not pods:
            return ""
        try:
            return self._core.read_namespaced_pod_log(
                name=pods[-1].metadata.name, namespace=self.namespace,
                tail_lines=tail)
        except Exception:   # noqa: BLE001 — logs are best-effort
            return ""

    def delete(self, name: str) -> None:
        self._batch.delete_namespaced_job(
            name=name, namespace=self.namespace,
            propagation_policy="Foreground")


# ---------------------------------------------------------------------------
# The executor.
# ---------------------------------------------------------------------------

def _sweep():
    """Late import: sweep imports the trainer stack; cluster stays cheap
    to import (the worker parses its flags first)."""
    from repro_torch.experiment import sweep
    return sweep


class K8sExecutor:
    """``run_sweep`` executor: one Job per pending grid point.

    Scheduling mirrors ``_run_procs`` (bounded in-flight set, backoff-
    delayed retries, wall-clock deadlines, quarantine on exhausted
    retries) with Jobs in place of processes and ``result.json`` in
    place of a Pipe.  Before submitting anything it reconciles: a run
    whose completion artifact already exists on shared storage (from a
    previous executor invocation that lost its manifest, or another
    submitter) is finished in place — submit-free resume.

    ``mount_path`` translates executor-side paths to container-side
    ones for a real cluster; with the default None the container sees
    the sweep dir at its host path (what FakeCluster, running
    in-process, needs).  Each Job trains on the sweep's device
    (``ExecContext.device``) and requests one GPU when that is a CUDA
    device (:func:`render_job`).
    """
    name = "k8s"
    supports_eval_fn = False
    supports_timeout = True

    def __init__(self, *, cluster: Optional[ClusterClient] = None,
                 image: str = "repro:latest", namespace: str = "default",
                 mount_path: Optional[str] = None,
                 pvc: Optional[str] = None,
                 env: Optional[Mapping[str, str]] = None,
                 max_workers: Optional[int] = None,
                 poll_s: float = 2.0):
        self.cluster = cluster
        self.image = image
        self.namespace = namespace
        self.mount_path = mount_path
        self.pvc = pvc
        self.env = dict(env or {})
        self.max_workers = max_workers
        self.poll_s = poll_s

    def _cpath(self, out: str, rel: str) -> str:
        """Executor-relative path -> container path."""
        return os.path.join(self.mount_path or out, rel)

    def run(self, man: dict, out: str, order: List[str], ctx) -> None:
        sweep = _sweep()
        cluster = self.cluster
        if cluster is None:
            cluster = K8sCluster(namespace=self.namespace)

        # --- reconcile: completed artifacts finish entries submit-free
        pending: List[str] = []
        for rid in order:
            entry = man["runs"][rid]
            res = load_result(out, rid)
            if result_completes(res, entry, ctx.target_rounds(entry)):
                sweep._finish_entry(entry, res["history"],
                                    float(res.get("wall_s") or 0.0))
                sweep.write_manifest(out, man)
            else:
                pending.append(rid)

        workers = max(self.max_workers or min(len(pending), 4), 1)
        # (rid, attempt, not_before): retries wait out their backoff
        ready: List[Tuple[str, int, float]] = [(rid, 1, 0.0)
                                               for rid in pending]
        running: Dict[str, dict] = {}
        # epoch stamp of when each rid became submittable (executor
        # start / backoff expiry) — the t0 of its sweep/queue span
        ready_since: Dict[str, float] = {rid: time.time()
                                         for rid in pending}

        def _submit(rid: str, attempt: int) -> None:
            entry = man["runs"][rid]
            entry["status"] = "running"
            entry["attempts"] = int(entry.get("attempts") or 0) + 1
            now = time.time()
            sweep._trace_span(entry, "sweep/queue",
                              ready_since.pop(rid, now), now,
                              attempt=int(entry["attempts"]))
            os.makedirs(run_dir(out, rid), exist_ok=True)
            _write_json(run_spec_path(out, rid), entry["spec"])
            # a stale completion token must not satisfy the poll below
            with contextlib.suppress(OSError):
                os.remove(run_result_path(out, rid))
            job = render_job(
                run_id=rid, attempt=int(entry["attempts"]),
                image=self.image,
                spec_path=self._cpath(out, f"runs/{rid}/spec.json"),
                ckpt_path=self._cpath(out, entry["ckpt"]),
                result_path=self._cpath(out, f"runs/{rid}/result.json"),
                rounds=ctx.rounds, save_every=ctx.save_every,
                namespace=self.namespace, mount_path=self.mount_path,
                pvc=self.pvc, env=self.env, device=ctx.device)
            t_sub = time.time()
            try:
                name = cluster.submit(job)
            except Exception:   # noqa: BLE001 — a rejected submit is an
                sweep._trace_span(entry, "sweep/attempt", t_sub,
                                  time.time(),
                                  attempt=int(entry["attempts"]),
                                  outcome="submit-error")
                _fail_or_retry(rid, attempt,    # attempt like any other
                               "SubmitError:\n" + traceback.format_exc())
                return
            running[rid] = {
                "name": name, "attempt": attempt, "t0": t_sub,
                "deadline": (time.monotonic() + ctx.timeout_s)
                if ctx.timeout_s else None,
            }
            sweep.write_manifest(out, man)

        failed_rid = None

        def _attempt_span(rid: str, st: dict, outcome: str) -> None:
            sweep._trace_span(man["runs"][rid], "sweep/attempt",
                              st["t0"], time.time(),
                              attempt=int(man["runs"][rid].get("attempts")
                                          or 0),
                              outcome=outcome)

        def _fail_or_retry(rid: str, attempt: int, err: str) -> None:
            nonlocal failed_rid
            entry = man["runs"][rid]
            entry["error"] = err
            if attempt <= ctx.max_retries:
                entry["status"] = "pending"
                delay = ctx.backoff_s * 2 ** (attempt - 1)
                now = time.time()
                sweep._trace_span(entry, "sweep/backoff", now, now + delay,
                                  attempt=attempt)
                ready_since[rid] = now + delay
                ready.append((rid, attempt + 1, time.monotonic() + delay))
            else:
                entry["status"] = "failed"
                if ctx.raise_on_error:
                    failed_rid = rid
            sweep.write_manifest(out, man)

        def _settle(rid: str) -> None:
            """The run's Job finished or timed out — judge by artifact."""
            st = running.pop(rid)
            entry = man["runs"][rid]
            status = cluster.status(st["name"])
            if status.phase == "Succeeded":
                res = load_result(out, rid)
                if result_completes(res, entry, ctx.target_rounds(entry)):
                    _attempt_span(rid, st, "done")
                    sweep._finish_entry(entry, res["history"],
                                        float(res.get("wall_s") or 0.0))
                    sweep.write_manifest(out, man)
                    return
                _attempt_span(rid, st, "incomplete")
                _fail_or_retry(rid, st["attempt"],
                               "IncompleteResult: Job succeeded but "
                               "result.json is missing, stale, or short "
                               "of the target round")
                return
            # a preempted worker (SIGTERM'd mid-run, checkpoint intact)
            # is first-class in the trace: its retry resumes, and the
            # manifest records how often the cluster preempted this run
            _attempt_span(rid, st,
                          "preempted" if status.reason == "Preempted"
                          else "error")
            tail = cluster.logs(st["name"], tail=20)
            _fail_or_retry(rid, st["attempt"],
                           f"JobFailed({status.reason or 'unknown'}):\n"
                           f"{tail}")

        while (ready or running) and failed_rid is None:
            while ready and len(running) < workers and failed_rid is None:
                i = next((j for j, (_, _, nb) in enumerate(ready)
                          if nb <= time.monotonic()), None)
                if i is None:
                    break
                rid, attempt, _ = ready.pop(i)
                _submit(rid, attempt)
            progressed = False
            for rid in list(running):
                if failed_rid is not None:
                    break
                st = running[rid]
                phase = cluster.status(st["name"]).phase
                if phase in ("Succeeded", "Failed"):
                    progressed = True
                    _settle(rid)
                elif st["deadline"] is not None \
                        and time.monotonic() > st["deadline"]:
                    progressed = True
                    cluster.delete(st["name"])
                    running.pop(rid)
                    _attempt_span(rid, st, "timeout")
                    _fail_or_retry(rid, st["attempt"],
                                   f"TimeoutError: Job exceeded "
                                   f"timeout_s={ctx.timeout_s} (deleted)")
            if not progressed and (ready or running):
                time.sleep(self.poll_s if self.poll_s > 0 else 0.01)

        if failed_rid is not None:
            for st in running.values():   # raise_on_error: stop the grid
                with contextlib.suppress(Exception):
                    cluster.delete(st["name"])
            sweep.write_manifest(out, man)
            raise RuntimeError(
                f"sweep run {failed_rid!r} failed after "
                f"{man['runs'][failed_rid].get('attempts')} attempt(s):\n"
                f"{man['runs'][failed_rid]['error']}")


if __name__ == "__main__":
    raise SystemExit(worker_main())
