"""The experiment API (``repro.experiment``): spec -> trainer -> run ->
resume::

    from repro_torch.experiment import ExperimentSpec, run_spec

    spec = ExperimentSpec(method="fedphd", model="ddpm-unet-smoke")
    exp = run_spec(spec, ckpt="runs/smoke/ckpt.npz", device="cpu")
    exp = run_spec(None, resume=True, rounds=6,
                   ckpt="runs/smoke/ckpt.npz", device="cpu")

Sweeps (:mod:`.sweep`), their reports (:mod:`.report`) and the k8s
executor (:mod:`.cluster`) are exported here too.  CLI: ``python -m
repro_torch.experiment.runner --help``.  The names
below resolve lazily: ``resolve`` is a leaf that the trainer imports, so
importing this package must not import the trainer stack.
"""
from importlib import import_module

# public name -> defining submodule ("." = repro_torch.experiment.<mod>)
_EXPORTS = {
    "DATASETS": ".data", "dataset_spec": ".data", "make_clients": ".data",
    "register_dataset": ".data",
    "MethodEntry": ".registry", "make_trainer": ".registry",
    "method_entry": ".registry", "register_method": ".registry",
    "registered_methods": ".registry",
    "build_report": ".report", "report_markdown": ".report",
    "run_scalars": ".report", "write_report": ".report",
    "CKPT_FORMAT": ".run", "Experiment": ".run",
    "checkpoint_exists": ".run", "run_spec": ".run",
    "TOPOLOGIES": ".spec", "CommSpec": ".spec", "DataSpec": ".spec",
    "ExperimentSpec": ".spec", "FaultSpec": ".spec", "ObsSpec": ".spec",
    "ClusterClient": ".cluster", "FakeCluster": ".cluster",
    "JobStatus": ".cluster", "K8sCluster": ".cluster",
    "K8sExecutor": ".cluster", "render_job": ".cluster",
    "worker_main": ".cluster",
    "EXECUTORS": ".sweep", "ExecContext": ".sweep", "Executor": ".sweep",
    "ProcessExecutor": ".sweep", "SequentialExecutor": ".sweep",
    "SweepResult": ".sweep", "SweepRun": ".sweep", "SweepSpec": ".sweep",
    "load_manifest": ".sweep", "manifest_path": ".sweep",
    "manifest_status": ".sweep", "resolve_executor": ".sweep",
    "run_id_of": ".sweep", "run_sweep": ".sweep", "spec_get": ".sweep",
    "spec_with": ".sweep",
    "Trainer": ".trainer",
    "RoundRecord": "repro_torch.fl.record",
    "RunResult": "repro_torch.fl.record",
    "evals_of": "repro_torch.fl.record",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    mod = import_module(target, __name__) if target.startswith(".") \
        else import_module(target)
    value = getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
