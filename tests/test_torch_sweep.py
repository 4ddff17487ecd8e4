"""Sweeps, reports and cluster execution of the port
(``repro_torch.experiment.sweep``, ``report`` and ``cluster``).

Against the reference, with nothing trained or jitted there: grid
expansion (ids, order, concrete specs, JSON both ways, the refusals),
``init_manifest`` with its reconciliation, and ``build_report`` /
``report_markdown`` on one synthetic manifest, JSON and markdown
identical.

Inside the port, on a one-level 8 x 8 U-Net registered here (4 clients
of 8 images, batch 8, 2 rounds; ``sparse_rounds`` 3, so FedPhD's Omega
runs in both rounds and nothing is pruned): a sweep killed mid-grid and
mid-run, then resumed, equals the unbroken sweep bitwise; each run of
the grid equals ``run_spec`` of its spec alone; a larger ``rounds``
extends done runs; a failed run is recorded and the grid goes on; the
k8s executor on ``FakeCluster`` (the grid, a preemption resumed, an
injected failure quarantined, reconcile from artifacts, a stale result
rerun, the Job's schema); one spawned process worker on a built-in
config (a spawned worker sees only those); and the runner's ``--sweep``
with both flag guards.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.experiment import report as jreport
from repro.experiment import sweep as jsweep
from repro_torch.configs import SMOKE_UNET, FLConfig, register_config
from repro_torch.data import DatasetSpec
from repro_torch.experiment import (DataSpec, ExperimentSpec, FakeCluster,
                                    K8sExecutor, SweepResult, SweepSpec,
                                    build_report, load_manifest,
                                    report_markdown, run_spec, run_sweep)
from repro_torch.experiment import cluster, report, runner, sweep
from repro_torch.experiment.data import register_dataset
from repro_torch.launch import env as launch_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_UNET = SMOKE_UNET.replace(name="ddpm-unet-tiny-tsweep", image_size=8,
                               base_channels=8, channel_mults=(1,),
                               num_res_blocks=1, attn_resolutions=(),
                               precision="fp32")
TINY_DATA = DatasetSpec("tiny-tsweep", num_classes=4, image_size=8,
                        samples_per_class=8)
BASE = ExperimentSpec(
    name="tsweep", method="fedphd", model=TINY_UNET.name,
    fl=FLConfig(num_clients=4, num_edges=2, local_epochs=1,
                edge_agg_every=1, cloud_agg_every=1, rounds=2,
                sparse_rounds=3, sh_a=1000.0, lambda0=1e-3),
    data=DataSpec(dataset=TINY_DATA.name, batch_size=8),
    engine="vectorized")
GRID = SweepSpec(name="tgrid", base=BASE,
                 axes={"method": ["fedphd", "fedavg"],
                       "comm.quant": ["none", "int8"]},
                 group_by=("method", "comm.quant"))
NESTED = SweepSpec(
    name="nested", base=BASE,
    axes={"fl.participation": [0.5, 1.0], "seed": [0, 1],
          "data.alpha": [0.1, 0.5], "lr": [1e-4, 2e-4]},
    exclude=[{"fl.participation": 0.5, "seed": 1},
             {"method": "fedprox"}],          # base is fedphd: no hit
    include=[{"data.batch_size": 4}, {"fault.dropout": 0.25},
             # the (1.0, 0, 0.1, 1e-4) grid point's spec again: deduped
             {"fl.participation": 1.0, "seed": 0, "data.alpha": 0.1,
              "lr": 1e-4}])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _tiny_registered():
    register_config(TINY_UNET.name, TINY_UNET, overwrite=True)
    register_dataset(TINY_DATA.name, TINY_DATA, overwrite=True)


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """GRID by the sequential executor in one go: the manifest every
    other run of the grid is held to."""
    res = run_sweep(GRID, str(tmp_path_factory.mktemp("unbroken")),
                    raise_on_error=True, device="cpu")
    assert res.complete
    return res.manifest


def _histories(man):
    return {rid: e["history"] for rid, e in man["runs"].items()}


def _sweep_file(name):
    with open(os.path.join(ROOT, "examples", name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# against the reference: expansion, manifest, report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", ["sweep_smoke.json", "fault_smoke.json",
                                  "nested"])
def test_expand_matches_reference(grid):
    """The same run ids in the same order with the same concrete specs,
    and the sweep JSON of either package loads in the other."""
    text = NESTED.to_json() if grid == "nested" else _sweep_file(grid)
    ours, theirs = SweepSpec.from_json(text), jsweep.SweepSpec.from_json(text)
    a, b = ours.expand(), theirs.expand()
    assert [r.run_id for r in a] == [r.run_id for r in b]
    assert [r.overrides for r in a] == [r.overrides for r in b]
    assert [r.spec.to_dict() for r in a] == [r.spec.to_dict() for r in b]
    assert ours.default_group_by() == theirs.default_group_by()
    assert ours.to_dict() == theirs.to_dict()
    assert SweepSpec.from_json(theirs.to_json()) == ours
    assert jsweep.SweepSpec.from_json(ours.to_json()) == theirs
    if grid == "nested":
        ids = [r.run_id for r in a]
        assert "data.batch_size=4" in ids and "fault.dropout=0.25" in ids
        assert len(ids) == 16 - 4 + 2        # 4 excluded, 1 include deduped
        assert "data.alpha=0.1,fl.participation=0.5,lr=0.0001,seed=1" \
            not in ids


def test_unknown_axes_and_fields_raise_in_both():
    for pkg in (sweep, jsweep):
        for axes in ({"nope": [1]}, {"fl.nope": [1]}, {"fl.rounds.x": [1]},
                     {"comm.nope": [1]}):
            with pytest.raises(ValueError, match="axis"):
                pkg.SweepSpec(base=pkg.ExperimentSpec(), axes=axes).expand()
        good = pkg.SweepSpec(name="s").to_dict()
        for typo in ("axis", "excludes"):
            with pytest.raises(ValueError, match="unknown SweepSpec"):
                pkg.SweepSpec.from_dict({**good, typo: []})
    assert sweep.run_id_of({"seed": 0, "method": "fedavg"}) \
        == jsweep.run_id_of({"method": "fedavg", "seed": 0})
    assert sweep.run_id_of({"model": "a/b c"}) \
        == jsweep.run_id_of({"model": "a/b c"})
    assert sweep.spec_with(BASE, {"comm.quant": "int8"}).comm.quant == "int8"


def test_init_manifest_matches_reference(tmp_path):
    """A fresh manifest, then one reconciled with a grown sweep (a run
    left done, one left running, one stale id), entry for entry."""
    out = {p: str(tmp_path / p) for p in ("port", "ref")}
    for pkg, d in ((sweep, out["port"]), (jsweep, out["ref"])):
        pkg.init_manifest(pkg.SweepSpec.from_json(GRID.to_json()), d)
    a, b = (json.load(open(os.path.join(d, "sweep.json")))
            for d in out.values())
    assert a == b
    # the same edits in both: one run done, one running, one stale id
    for d in out.values():
        man = json.load(open(os.path.join(d, "sweep.json")))
        runs = man["runs"]
        first, second = sorted(runs)[:2]
        runs[first].update(status="done", rounds_done=2,
                           history=[{"round": 1}, {"round": 2}])
        runs[second]["status"] = "running"
        runs["stale"] = dict(runs[first])
        with open(os.path.join(d, "sweep.json"), "w") as f:
            json.dump(man, f)
    edited = GRID.replace(axes={**GRID.axes,
                                "comm.quant": ["none", "int8", "fp8"]})
    for pkg, d in ((sweep, out["port"]), (jsweep, out["ref"])):
        pkg.init_manifest(pkg.SweepSpec.from_json(edited.to_json()), d)
    a, b = (json.load(open(os.path.join(d, "sweep.json")))
            for d in out.values())
    assert a == b and "stale" not in a["runs"] and len(a["runs"]) == 6
    assert a["runs"][first]["status"] == "done"
    assert a["runs"][second]["status"] == "pending"
    assert sweep.manifest_status(a) == jsweep.manifest_status(b)


def _synthetic_manifest():
    """Three seeds a group, a failed and a pending run, eval dicts with
    a numeric, a bool and a string key, and executor spans."""
    grid = SweepSpec(name="agg", base=BASE,
                     axes={"method": ["fedphd", "fedavg"],
                           "seed": [0, 1, 2]})
    rng = np.random.default_rng(0)
    runs = {}
    for i, run in enumerate(grid.expand()):
        hist = [{"round": r, "loss": float(rng.random()),
                 "comm_gb": float(rng.random()), "params_m": 0.125,
                 "selected": [0, 1], "eval": None if r == 1 else
                 {"is_proxy": float(rng.random()), "ok": True, "tag": "x"},
                 "edge_sh": None, "pruned": False} for r in (1, 2)]
        status = "failed" if i == 4 else "pending" if i == 5 else "done"
        runs[run.run_id] = {
            "status": status, "overrides": run.overrides,
            "spec": run.spec.to_dict(), "ckpt": "x", "attempts": 1 + i % 2,
            "rounds_done": 2 if status == "done" else 0,
            "wall_s": 1.5 + i if status == "done" else 0.0,
            "history": hist if status == "done" else [],
            "error": "boom" if status == "failed" else None,
            "trace": [{"ev": "span", "name": n, "t0": 0.0, "t1": d,
                       "dur_s": d, "attrs": {"outcome": o}}
                      for n, d, o in (("sweep/queue", 0.5, None),
                                      ("sweep/attempt", 2.0, "error"),
                                      ("sweep/backoff", 1.0, None),
                                      ("sweep/attempt", 3.0, "done"))]}
    return {"format": 1, "sweep": grid.to_dict(), "runs": runs}


@pytest.mark.parametrize("group_by", [None, ("model",)])
def test_report_matches_reference(tmp_path, group_by):
    man = _synthetic_manifest()
    ours = report.write_report(man, str(tmp_path / "port"), group_by)
    theirs = jreport.write_report(man, str(tmp_path / "ref"), group_by)
    assert ours == theirs
    assert report_markdown(ours) == jreport.report_markdown(theirs)
    for name in ("report.json", "report.md"):
        with open(tmp_path / "port" / name) as f, \
                open(tmp_path / "ref" / name) as g:
            assert f.read() == g.read()
    assert ours["failed"] == 1 and not ours["complete"]
    if group_by is None:
        assert [g["n"] for g in ours["groups"]] == [3, 1]
        assert "eval.is_proxy" in ours["groups"][0]["metrics"]


# ---------------------------------------------------------------------------
# sweep runs inside the port
# ---------------------------------------------------------------------------

def test_kill_and_resume_equals_unbroken(tmp_path, unbroken):
    """Killed after one run (``limit``) and in the middle of another
    (its spec run to round 1 at the sweep's checkpoint path), then
    resumed: every history bitwise the unbroken sweep's, the report's
    metrics too, and the resumed run continued from its checkpoint."""
    out = str(tmp_path / "broken")
    res = run_sweep(GRID, out, limit=1, raise_on_error=True, device="cpu")
    assert sweep.manifest_status(res.manifest)["done"] == 1
    victim = GRID.expand()[2]
    ckpt = os.path.join(out, "runs", victim.run_id, "ckpt.npz")
    os.makedirs(os.path.dirname(ckpt))
    run_spec(victim.spec, rounds=1, ckpt=ckpt, device="cpu")
    res = run_sweep(GRID, out, raise_on_error=True, device="cpu")
    assert res.complete
    assert _histories(res.manifest) == _histories(unbroken)
    assert [e["attempts"] for e in res.manifest["runs"].values()] \
        == [1, 1, 1, 1]
    a, b = build_report(unbroken), build_report(res.manifest)
    for ga, gb in zip(a["groups"], b["groups"], strict=True):
        assert ga["key"] == gb["key"]
        for m in ("loss", "comm_gb", "params_m"):
            assert ga["metrics"][m] == gb["metrics"][m]
    # nothing left to run: an unchanged re-invocation is a no-op
    before = json.dumps(res.manifest["runs"], sort_keys=True)
    res = run_sweep(GRID, out, device="cpu")
    assert json.dumps(res.manifest["runs"], sort_keys=True) == before


def test_each_run_equals_run_spec_alone(unbroken):
    """The grid's runs share one process (the matmul plans and group-L2
    tables stay cached between them); each history must still be its
    spec's run on its own.  Run here in reverse order."""
    hist = _histories(unbroken)
    runs = GRID.expand()
    assert [r.run_id for r in runs] == list(unbroken["runs"])
    for run in reversed(runs):
        exp = run_spec(run.spec, device="cpu")
        assert [r.to_dict() for r in exp.history] == hist[run.run_id]
    fedphd = [r for r in runs if r.spec.method == "fedphd"]
    # Omega in both rounds, no prune: the params stay
    assert all(not h["pruned"] for r in fedphd for h in hist[r.run_id])


def test_rounds_extension_reruns_done_runs(tmp_path, unbroken):
    out = str(tmp_path / "ext")
    short = GRID.replace(rounds=1, axes={"method": ["fedphd"],
                                         "comm.quant": ["none"]})
    res = run_sweep(short, out, raise_on_error=True, device="cpu")
    (entry,) = res.manifest["runs"].values()
    assert entry["rounds_done"] == 1
    res = run_sweep(short.replace(rounds=2), out, raise_on_error=True,
                    device="cpu")
    (rid, entry), = res.manifest["runs"].items()
    assert entry["rounds_done"] == 2 and entry["attempts"] == 2
    assert entry["history"] == unbroken["runs"][rid]["history"]


def test_failed_run_recorded_and_sweep_continues(tmp_path):
    grid = SweepSpec(name="f", base=BASE.replace(fl=dataclasses.replace(
        BASE.fl, rounds=1)), axes={"model": [TINY_UNET.name, "nope"]})
    res = run_sweep(grid, str(tmp_path / "f"), device="cpu")
    runs = res.manifest["runs"]
    assert runs["model=nope"]["status"] == "failed"
    assert "nope" in runs["model=nope"]["error"]
    assert runs[f"model={TINY_UNET.name}"]["status"] == "done"
    rep = build_report(res.manifest)
    assert rep["failed"] == 1 and rep["done"] == 1 and not rep["complete"]


# ---------------------------------------------------------------------------
# the k8s executor on FakeCluster
# ---------------------------------------------------------------------------

def _fake(**kw):
    fake = FakeCluster(**kw)
    return K8sExecutor(cluster=fake, poll_s=0.0), fake


def test_k8s_grid_and_preemption_match_sequential(tmp_path, unbroken,
                                                  monkeypatch):
    """One Job a run, the grid bitwise the sequential executor's; a run
    preempted after round 1 retries from its checkpoint."""
    rid = GRID.expand()[0].run_id
    resumed = []
    real = sweep.run_spec
    monkeypatch.setattr(sweep, "run_spec", lambda spec, **kw: (
        resumed.append(kw.get("resume", False)), real(spec, **kw))[1])
    exe, fake = _fake(preempt_once={rid: 1})
    res = run_sweep(GRID, str(tmp_path), executor=exe, max_retries=1,
                    backoff_s=0.0, device="cpu")
    assert res.complete and fake.preempted == [rid]
    assert len(fake.submitted) == 5
    assert len(resumed) == 5 and resumed.count(True) == 1
    assert _histories(res.manifest) == _histories(unbroken)
    entry = res.manifest["runs"][rid]
    assert entry["attempts"] == 2
    outcomes = [s["attrs"]["outcome"] for s in entry["trace"]
                if s["name"] == "sweep/attempt"]
    assert outcomes == ["preempted", "done"]
    job = fake.jobs[fake.submitted[0]]["job"]
    cmd = job["spec"]["template"]["spec"]["containers"][0]["command"]
    assert cmd[cmd.index("--device") + 1] == "cpu"


def test_k8s_failure_quarantine_reconcile_and_stale(tmp_path):
    grid = GRID.replace(rounds=1, axes={"method": ["fedphd", "fedavg"]})
    rid = grid.expand()[1].run_id
    exe, _ = _fake(fail_reasons={rid: "ImagePullBackOff"})
    out = str(tmp_path / "a")
    res = run_sweep(grid, out, executor=exe, device="cpu")
    entry = res.manifest["runs"][rid]
    assert entry["status"] == "failed"
    assert "JobFailed(ImagePullBackOff)" in entry["error"]
    exe, fake = _fake(fail_reasons={rid: "ImagePullBackOff"})
    with pytest.raises(RuntimeError, match="failed after 1 attempt"):
        run_sweep(grid, str(tmp_path / "b"), executor=exe,
                  raise_on_error=True, device="cpu")
    # the failed run reruns and completes
    exe, fake = _fake()
    assert run_sweep(grid, out, executor=exe, device="cpu").complete
    assert len(fake.submitted) == 1
    # the manifest lost and submits refused: completion from artifacts
    os.remove(os.path.join(out, "sweep.json"))
    exe, fake = _fake(fail_submits=True)
    assert run_sweep(grid, out, executor=exe, device="cpu").complete
    assert fake.submitted == []
    # an edited sweep's artifacts are stale: every run reruns
    exe, fake = _fake()
    res = run_sweep(grid.replace(name="tgrid-v2"), out, executor=exe,
                    device="cpu")
    assert res.complete and len(fake.submitted) == 2
    assert all(e["spec"]["name"] == f"tgrid-v2/{r}"
               for r, e in res.manifest["runs"].items())


def test_render_job_runs_the_port_on_a_card():
    job = cluster.render_job(
        run_id="lr=0.1,seed=0", attempt=2, image="repro:test",
        spec_path="/sweep/runs/r/spec.json", ckpt_path="/sweep/runs/r/c",
        result_path="/sweep/runs/r/result.json", rounds=7, save_every=2,
        namespace="fl", mount_path="/sweep", pvc="sweep-pvc",
        env={"FEDPHD_ENGINE": "vectorized"})
    assert job["apiVersion"] == "batch/v1" and job["kind"] == "Job"
    assert job["spec"]["backoffLimit"] == 0
    assert job["metadata"]["annotations"]["repro.run-id"] == "lr=0.1,seed=0"
    pod = job["spec"]["template"]["spec"]
    [ctr] = pod["containers"]
    cmd = ctr["command"]
    assert cmd[:3] == ["python", "-m", "repro_torch.experiment.cluster"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[cmd.index("--rounds") + 1] == "7"
    assert ctr["resources"] == {"limits": {"nvidia.com/gpu": 1}}
    env = {e["name"]: e["value"] for e in ctr["env"]}
    assert env["FEDPHD_ENGINE"] == "vectorized"
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] \
        == launch_env.TCMALLOC_REPORT_THRESHOLD
    assert "LD_PRELOAD" not in env and "XLA_FLAGS" not in env
    assert pod["volumes"][0]["persistentVolumeClaim"]["claimName"] \
        == "sweep-pvc"
    kw = dict(run_id="r", attempt=1, image="i", spec_path="s",
              ckpt_path="c", result_path="o")
    cpu = cluster.render_job(**kw, device="cpu")["spec"]["template"][
        "spec"]["containers"][0]
    assert cpu["resources"] == {} and "cpu" in cpu["command"]
    indexed = cluster.render_job(**kw, device="cuda:0")["spec"][
        "template"]["spec"]
    assert indexed["containers"][0]["resources"]["limits"] == {
        "nvidia.com/gpu": 1}
    assert indexed["volumes"] == []
    try:
        import kubernetes  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="kubernetes"):
            cluster.K8sCluster()


# ---------------------------------------------------------------------------
# the process executor and the runner CLI
# ---------------------------------------------------------------------------

def test_process_executor_one_spawned_worker(tmp_path, monkeypatch):
    """One run through a spawned worker on a BUILT-IN config and dataset
    (the worker imports the port afresh and never sees this module's
    registrations), and the one-worker rule of a CUDA device."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the worker's torch
    base = ExperimentSpec(
        name="pool", method="fedavg", model="ddpm-unet-smoke",
        # one client of 8 images: one step at batch 8
        fl=FLConfig(num_clients=32, num_edges=1, participation=1 / 32,
                    local_epochs=1, rounds=1, sh_a=1000.0),
        data=DataSpec(dataset="smoke", batch_size=8),
        engine="sequential", prune=False)
    grid = SweepSpec(name="pool", base=base, axes={"seed": [0]})
    res = run_sweep(grid, str(tmp_path / "pool"), executor="process",
                    raise_on_error=True, device="cpu")
    assert res.complete
    (entry,) = res.manifest["runs"].values()
    assert entry["rounds_done"] == 1 and entry["attempts"] == 1
    assert np.isfinite(entry["history"][0]["loss"])
    assert os.path.exists(os.path.join(tmp_path, "pool", entry["ckpt"]))
    assert sweep.process_workers(None, 8, "cpu") == 4
    assert sweep.process_workers(3, 8, "cpu") == 3
    assert sweep.process_workers(None, 8, "cuda") == 1
    assert sweep.process_workers(1, 8, "cuda:0") == 1
    with pytest.raises(ValueError, match="one worker a card"):
        run_sweep(grid, str(tmp_path / "two"), executor="process",
                  max_workers=2, device="cuda")
    with pytest.raises(ValueError, match="eval_fn cannot cross"):
        run_sweep(grid, str(tmp_path / "two"), executor="process",
                  eval_fn=lambda *a: {}, device="cpu")
    assert not os.path.exists(tmp_path / "two")


def test_runner_cli_sweep_round_trip_and_guards(tmp_path, unbroken):
    """``--sweep`` killed by ``--max-runs`` and re-invoked: the unbroken
    histories, the report files; ``--k8s-fake`` the same grid; and the
    refusals both ways."""
    path = tmp_path / "grid.json"
    path.write_text(GRID.to_json())
    out = str(tmp_path / "out")
    argv = ["--sweep", str(path), "--out", out, "--device", "cpu"]
    res = runner.main(argv + ["--max-runs", "2"])
    assert isinstance(res, SweepResult)
    assert sweep.manifest_status(res.manifest)["done"] == 2
    res = runner.main(argv)
    assert res.complete
    assert _histories(load_manifest(out)) == _histories(unbroken)
    with open(os.path.join(out, "report.json")) as f:
        rep = json.load(f)
    assert rep["group_by"] == ["method", "comm.quant"]
    assert [g["n"] for g in rep["groups"]] == [1, 1, 1, 1]
    with open(os.path.join(out, "report.md")) as f:
        assert "| method | comm.quant | n |" in f.read()
    res = runner.main(["--sweep", str(path), "--out", str(tmp_path / "k8s"),
                       "--device", "cpu", "--executor", "k8s", "--k8s-fake"])
    assert _histories(res.manifest) == _histories(unbroken)
    for flags in (["--method", "fedavg"], ["--seed", "3"],
                  ["--eval-every", "1"], ["--resume"], ["--trace"],
                  ["--precision", "bf16"]):
        with pytest.raises(SystemExit, match="incompatible"):
            runner.main(argv + flags)
    for flags in (["--max-runs", "1"], ["--executor", "process"],
                  ["--group-by", "method"], ["--k8s-fake"],
                  ["--image", "x"], ["--timeout-s", "5"],
                  ["--max-retries", "1"], ["--namespace", "n"],
                  ["--max-workers", "2"]):
        with pytest.raises(SystemExit, match="require --sweep"):
            runner.main(["--preset", "smoke", "--out", out, *flags])
    with pytest.raises(SystemExit, match="--executor process"):
        runner.main(argv + ["--max-workers", "2"])
    with pytest.raises(SystemExit, match="--executor k8s"):
        runner.main(argv + ["--k8s-fake"])
    bad = tmp_path / "bad.json"
    one_round = BASE.replace(fl=dataclasses.replace(BASE.fl, rounds=1))
    bad.write_text(SweepSpec(name="bad", base=one_round,
                             axes={"model": ["nope"]}).to_json())
    with pytest.raises(SystemExit, match="1 run"):
        runner.main(["--sweep", str(bad), "--out", str(tmp_path / "bad"),
                     "--device", "cpu"])
