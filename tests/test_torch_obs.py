"""The port's obs layer (``repro_torch.obs``) and the pipelined rounds it
measures: the trace schema and ``summarize_trace`` against the
reference's, ``make_tracer`` and ``ObsSpec`` resolution against the
reference's, tracing as a bitwise no-op and the double-buffered
``run()`` bitwise equal to a ``run_round`` loop on the port's trainers,
the host-cache compile tracker, and ``--trace`` on the runner and the
serving CLI.

No reference trainer runs here and nothing is jitted: the reference is
called only for its framework-free obs functions.  The trainers run a
one-level 8 x 8 U-Net (the reference's ``tests/test_obs.py`` MICRO_UNET)
on 4 clients for 3 rounds: round 1 sparse, the prune at round 2's
cloud aggregation, round 3 on the compacted model.
"""
import functools
import json
import os

import pytest
import torch

from repro.experiment import cli as jcli
from repro.obs import metrics as jmetrics
from repro.obs import spec as jspec
from repro.obs import trace as jtrace
from repro_torch import data as tdata
from repro_torch.configs import SMOKE_UNET, FLConfig
from repro_torch.core.hfl import FedPhD
from repro_torch.experiment import cli as tcli
from repro_torch.experiment import runner
from repro_torch.fl.baselines import FlatTrainer
from repro_torch.fl.client import Client
from repro_torch.obs import compile_tracker as tracker
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import spec as tspec
from repro_torch.obs import trace as ttrace
from repro_torch.serve import __main__ as serve_cli
from repro_torch.tree import tree_leaves

MICRO_UNET = SMOKE_UNET.replace(name="ddpm-unet-tiny-obs", image_size=8,
                                base_channels=8, channel_mults=(1,),
                                num_res_blocks=1, attn_resolutions=(),
                                precision="fp32")
MICRO_DATA = tdata.DatasetSpec("tiny-obs", num_classes=4, image_size=8,
                               samples_per_class=16)
FL = FLConfig(num_clients=4, num_edges=2, local_epochs=1, edge_agg_every=1,
              cloud_agg_every=1, rounds=3, sparse_rounds=2, prune_ratio=0.44,
              sh_a=1000.0, lambda0=1e-3)
PHASES = ("round/host_prep", "round/h2d", "round/dispatch", "round/loss_sync")
# (trainer, engine) -> the runs the module compares
CASES = (("fedphd", "vectorized"), ("fedphd", "sequential"),
         ("fedavg", "vectorized"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clients():
    images, labels = tdata.make_dataset(MICRO_DATA, seed=0)
    parts = tdata.shards_per_client(labels, 4, 1, seed=0)
    return [Client(i, tdata.ClientData(images[p], labels[p], batch_size=8,
                                       seed=i), MICRO_DATA.num_classes)
            for i, p in enumerate(parts)]


def _checksum(params, cfg, r):
    """The eval hook: a float64 checksum of the params it is given."""
    return {"sum": float(sum(p.double().sum() for p in tree_leaves(params)))}


def _trainer(method, engine, tracer=None):
    kw = dict(rng_seed=0, engine=engine, eval_fn=_checksum, eval_every=1,
              tracer=tracer, device="cpu")
    if method == "fedphd":
        return FedPhD(MICRO_UNET, FL, _clients(), **kw)
    return FlatTrainer(method, MICRO_UNET, FL, _clients(), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case 3 rounds three ways: a ``run_round`` loop, a pipelined
    ``run(3)``, and a pipelined ``run(3)`` with a tracer (its path)."""
    out = {}
    for method, engine in CASES:
        stepped = _trainer(method, engine)
        for r in (1, 2, 3):
            stepped.run_round(r)
        piped = _trainer(method, engine)
        piped.run(3)
        path = str(tmp_path_factory.mktemp("obs") / "trace.jsonl")
        traced = _trainer(method, engine, ttrace.Tracer(path))
        traced.run(3)
        traced._obs.close()
        out[method, engine] = {"stepped": stepped, "pipelined": piped,
                               "traced": traced, "path": path}
    return out


def _assert_same(a, b):
    """Bitwise the same params and histories, evals included."""
    assert [h.to_dict() for h in a.history] == \
        [h.to_dict() for h in b.history]
    la, lb = tree_leaves(a.params), tree_leaves(b.params)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- (a) the schema ------------------------------------------------------------

def test_trace_schema_matches_reference(tmp_path):
    """The golden key tuples and the schema version are the reference's,
    and a port Tracer's meta, span, event and counter lines carry
    exactly those keys."""
    for name in ("SPAN_KEYS", "EVENT_KEYS", "COUNTER_KEYS", "META_KEYS",
                 "SCHEMA_VERSION"):
        assert getattr(ttrace, name) == getattr(jtrace, name), name
    path = str(tmp_path / "t.jsonl")
    with ttrace.Tracer(path) as tr:
        with tr.span("round/h2d", round=1):
            pass
        tr.record_span("serve/tick", 1.0, 2.0, active=3)
        tr.event("fault/draw", round=1, dropped=0)
        tr.counter("compile/matmul_plan", 2, total=2, unexpected=0)
    lines = [json.loads(ln) for ln in open(path)]
    want = {"meta": ttrace.META_KEYS, "span": ttrace.SPAN_KEYS,
            "event": ttrace.EVENT_KEYS, "counter": ttrace.COUNTER_KEYS}
    assert [ln["ev"] for ln in lines] == ["meta", "span", "span", "event",
                                          "counter"]
    for ln in lines:
        assert set(ln) == set(want[ln["ev"]])
    assert lines[0]["schema"] == jtrace.SCHEMA_VERSION
    assert ttrace.NULL_TRACER.span("x") is ttrace.NULL_TRACER.span("y")


# -- (b) summarize_trace -------------------------------------------------------

SESSIONS = [
    {"ev": "meta", "schema": 1, "wall_time": 0.0, "attrs": {}},
    {"ev": "span", "name": "round/dispatch", "t0": 0.0, "t1": 1.0,
     "dur_s": 1.0, "attrs": {"round": 1}},
    {"ev": "span", "name": "round/h2d", "t0": 1.2, "t1": 1.8,
     "dur_s": 0.6, "attrs": {"round": 2}},
    {"ev": "span", "name": "round/loss_sync", "t0": 2.0, "t1": 2.1,
     "dur_s": 0.1, "attrs": {"round": 1}},
    {"ev": "meta", "schema": 1, "wall_time": 9.0, "attrs": {}},
    {"ev": "span", "name": "round/dispatch", "t0": 0.0, "t1": 0.5,
     "dur_s": 0.5, "attrs": {"round": 3}},
]
# a round whose sync starts before its dispatch ends (no window), a host
# span past the window's end, compile counters, and a second session
PARTIAL = [
    {"ev": "meta", "schema": 1, "wall_time": 0.0, "attrs": {}},
    {"ev": "span", "name": "round/dispatch", "t0": 0.0, "t1": 2.0,
     "dur_s": 2.0, "attrs": {"round": 1}},
    {"ev": "span", "name": "round/loss_sync", "t0": 1.5, "t1": 2.5,
     "dur_s": 1.0, "attrs": {"round": 1}},
    {"ev": "span", "name": "round/dispatch", "t0": 3.0, "t1": 4.0,
     "dur_s": 1.0, "attrs": {"round": 2}},
    {"ev": "span", "name": "round/host_prep", "t0": 4.5, "t1": 7.0,
     "dur_s": 2.5, "attrs": {"round": 3}},
    {"ev": "span", "name": "round/loss_sync", "t0": 6.0, "t1": 6.1,
     "dur_s": 0.1, "attrs": {"round": 2}},
    {"ev": "counter", "name": "compile/matmul_plan", "t": 6.2, "value": 5,
     "attrs": {"total": 5, "unexpected": 0}},
    {"ev": "counter", "name": "compile/group_l2_table", "t": 6.3,
     "value": 2, "attrs": {"total": 7, "unexpected": 2}},
    {"ev": "event", "name": "fault/draw", "t": 6.4, "attrs": {"round": 3}},
    {"ev": "meta", "schema": 1, "wall_time": 9.0, "attrs": {}},
    {"ev": "span", "name": "serve/tick", "t0": 0.0, "t1": 0.25,
     "dur_s": 0.25, "attrs": {"active": 2}},
]


@pytest.mark.parametrize("events", [SESSIONS, PARTIAL],
                         ids=["sessions", "partial"])
def test_summarize_trace_matches_reference(events):
    """The port's summary of a synthetic multi-session trace is the
    reference's, key for key."""
    got = tmetrics.summarize_trace(events)
    assert got == jmetrics.summarize_trace(events)
    assert got["sessions"] == 2


def test_summarize_own_trace_matches_reference(runs):
    """The port's traced FedPhD run's file reads the same through both
    packages' ``read_trace`` and ``summarize_trace``."""
    path = runs["fedphd", "vectorized"]["path"]
    assert tmetrics.read_trace(path) == jmetrics.read_trace(path)
    assert tmetrics.summarize_trace(path) == jmetrics.summarize_trace(path)


# -- (c) resolution ------------------------------------------------------------

@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("enabled", [None, True, False])
def test_make_tracer_and_obs_spec_match_reference(enabled, env, tmp_path,
                                                  monkeypatch):
    """``ObsSpec.resolved_enabled`` and ``make_tracer`` give the
    reference's answers for every ``enabled`` and ``$FEDPHD_OBS``."""
    if env is None:
        monkeypatch.delenv("FEDPHD_OBS", raising=False)
    else:
        monkeypatch.setenv("FEDPHD_OBS", env)
    got = tspec.ObsSpec(enabled=enabled, trace=str(tmp_path / "t.jsonl"))
    want = jspec.ObsSpec(**got.to_dict())
    assert got.resolved_enabled == want.resolved_enabled
    assert got.resolved_enabled == (enabled if enabled is not None
                                    else env == "1")
    t, j = ttrace.make_tracer(got), jtrace.make_tracer(want)
    assert t.enabled == j.enabled
    assert (t is ttrace.NULL_TRACER) == (j is jtrace.NULL_TRACER)
    for tr in (t, j):
        tr.close()
    cli = tcli.cli_obs_spec(None if enabled is None else "")
    assert cli.to_dict() == jcli.cli_obs_spec(
        None if enabled is None else "").to_dict()


# -- (d) and (e): a bitwise no-op, and the pipeline --------------------------

@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_tracing_is_a_bitwise_noop(runs, case):
    """A bound tracer changes neither params nor histories."""
    _assert_same(runs[case]["traced"], runs[case]["pipelined"])


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_pipelined_run_equals_round_loop(runs, case):
    """``run(3)`` (round r+1 dispatched before round r is finished)
    equals three ``run_round`` calls bitwise, evals included: the eval
    of round r, taken after round r+1 was dispatched, still sees round
    r's params, so nothing of round r+1 wrote into them in place."""
    got, want = runs[case]["pipelined"], runs[case]["stepped"]
    _assert_same(got, want)
    sums = [h.eval["sum"] for h in got.history]
    assert len(set(sums)) == 3
    if case[0] == "fedphd":
        assert [h.pruned for h in got.history] == [False, True, False]
    if case[1] == "vectorized":
        assert len(got.round_seconds) == 3 and not got.step_seconds


# -- (f) the compile tracker --------------------------------------------------

def test_compile_tracker_on_an_lru_cache(tmp_path):
    """A watch grants one check with growth, whatever its size; growth in
    a later check is unexpected until a re-watch; ``rebase`` absorbs
    growth off the watched path; a plain function is not watched."""
    @functools.lru_cache(maxsize=2)
    def plan(n):
        return n

    path = str(tmp_path / "c.jsonl")
    tr = ttrace.Tracer(path)
    ct = tracker.CompileTracker(tr)
    plan(0)                                # before the watch: not counted
    assert ct.watch("plan", plan)
    assert not ct.watch("plain", lambda n: n)
    assert tracker.cache_size(lambda n: n) is None
    plan(1), plan(2), plan(1)
    assert ct.check(round=1) == 0          # the granted check: 2 entries
    plan(2)
    assert ct.check(round=2) == 0          # a hit: no growth
    plan(3)
    assert ct.check(round=3) == 1          # a new key: unexpected
    assert ct.watch("plan", plan)          # a declared boundary
    plan(4), plan(5)
    assert ct.check(round=4) == 0
    plan(1)                                # evicted at maxsize 2: rebuilt
    assert ct.check(round=5) == 1
    plan(6)                                # off the watched path (eval)
    ct.rebase()
    assert ct.check(round=6) == 0          # absorbed, no counter
    assert (ct.compiles(), ct.recompiles()) == (6, 2)
    tr.close()
    counters = [ln for ln in tmetrics.read_trace(path)
                if ln["ev"] == "counter"]
    assert [(c["value"], c["attrs"]["unexpected"], c["attrs"]["round"])
            for c in counters] == [(2, 0, 1), (1, 1, 3), (2, 0, 4),
                                   (1, 1, 5)]
    s = tmetrics.summarize_trace(path)
    assert (s["compiles"], s["recompiles"]) == (6, 2)
    # the port's own caches are what the trainers watch
    caches = tracker.host_caches()
    assert set(caches) == {"matmul_plan", "group_l2_table", "nvcc_build"}
    assert all(tracker.cache_size(fn) is not None for fn in caches.values())


# -- (g) a traced run's summary -----------------------------------------------

def test_traced_run_summary(runs):
    """The traced vectorized FedPhD run: every round phase at least once
    a round, the prune once, 3 rounds, an overlap ratio in [0, 1] and no
    unexpected host-cache growth; the sequential run has one dispatch
    span a round and no loss sync."""
    s = tmetrics.summarize_trace(runs["fedphd", "vectorized"]["path"])
    for phase in PHASES:
        assert s["phases"][phase]["n"] >= 3, phase
    assert s["phases"]["round/prune"]["n"] == 1
    assert s["phases"]["round/cloud_agg"]["n"] == 3
    assert s["rounds"] == 3 and s["sessions"] == 1
    assert s["overlap_ratio"] is not None
    assert 0.0 <= s["overlap_ratio"] <= 1.0
    assert s["recompiles"] == 0
    seq = tmetrics.summarize_trace(runs["fedphd", "sequential"]["path"])
    assert seq["phases"]["round/dispatch"]["n"] == 3
    assert "round/loss_sync" not in seq["phases"]
    assert seq["overlap_ratio"] is None
    flat = tmetrics.summarize_trace(runs["fedavg", "vectorized"]["path"])
    for phase in PHASES:
        assert flat["phases"][phase]["n"] == 3, phase


# -- (h) and (i): the CLIs ---------------------------------------------------

@pytest.fixture(scope="module")
def traced_cli(tmp_path_factory):
    """``runner --preset smoke --rounds 1 --trace`` and its metrics."""
    out = str(tmp_path_factory.mktemp("runner"))
    metrics = os.path.join(out, "m.json")
    runner.main(["--preset", "smoke", "--rounds", "1", "--trace",
                 "--metrics", metrics, "--out", out, "--device", "cpu"])
    return out, metrics


def test_runner_trace_and_resume(traced_cli):
    """The trace lands next to the checkpoint with the metrics' four
    keys; a bare ``--resume --trace`` appends a second session, and
    ``--resume --trace PATH`` exits with the reference's message."""
    out, metrics = traced_cli
    path = os.path.join(out, "ckpt.npz.trace.jsonl")
    m = json.load(open(metrics))
    assert m["trace"] == path and os.path.exists(path)
    assert {"trace", "overlap_ratio", "compiles", "recompiles"} <= set(m)
    assert m["recompiles"] == 0
    assert tmetrics.summarize_trace(path)["rounds"] == 1
    runner.main(["--resume", "--trace", "--rounds", "1", "--out", out,
                 "--device", "cpu"])
    assert "FEDPHD_OBS" not in os.environ
    assert [ev["ev"] for ev in tmetrics.read_trace(path)].count("meta") == 2
    with pytest.raises(SystemExit, match="incompatible with --resume"):
        runner.main(["--resume", "--trace", os.path.join(out, "x.jsonl"),
                     "--out", out, "--device", "cpu"])


def test_serve_trace(traced_cli):
    """``serve --trace`` writes one ``serve/tick`` span a tick, at the
    CLI's default path, and its summary into the metrics."""
    out, _ = traced_cli
    ckpt = os.path.join(out, "ckpt.npz")
    m = serve_cli.main(["--ckpt", ckpt, "--requests", "3", "--slots", "2",
                        "--steps", "2", "--trace", "--device", "cpu"])
    path = ckpt + ".serve.trace.jsonl"
    assert m["trace"] == path and m["images"] == 3
    ticks = [ev for ev in tmetrics.read_trace(path)
             if ev["ev"] == "span" and ev["name"] == "serve/tick"]
    # 3 requests of 2 steps in 2 slots: 2 ticks, then the third alone
    assert len(ticks) == m["ticks"] == 4
    assert [t["attrs"]["active"] for t in ticks] == [2, 2, 1, 1]
    assert m["recompiles"] == 0 and m["compiles"] == 0
