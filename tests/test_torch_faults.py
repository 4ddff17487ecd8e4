"""Fault injection, the staleness aggregation and the quantized uplink with
error feedback in the port (``repro_torch.fl.faults``,
``repro_torch.fl.compress`` and their branches in ``FedPhD`` and
``FlatTrainer``).

Against the reference, where it is cheap: the fault stream and its
``availability`` records (host numpy, bitwise); the quantizer, the
error-feedback round trips and the byte counts in eager ``jnp`` on small
arrays (bitwise, int8's half-to-even ties and fp8's clip and ties
included); ``apply_late`` and ``late_delta`` (fp32, 1e-6 relative); and
the trainers' rounds under faults on the sequential engine, with local
training replaced in both packages by the same host update
(``monkeypatch``, test-only) and everything after it live: the
reporter-only aggregation, the late weights and merge, the round trip's
``start + deq``, which clients update which rows, the records and the
bytes, each round from the same state.  Within the port: the sequential
engine against the vectorized one under faults, staleness and int8; a
disabled fault spec bitwise equal to ``fault=None``; and a kill and
resume through ``run_spec`` bitwise, with the error-feedback rows, the
late buffer and the fault stream, for the registry's two staleness
methods.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_UNET as JAX_SMOKE
from repro.configs.base import FLConfig as JFLConfig
from repro.core import hfl as jhfl
from repro.data.pipeline import ClientData as JClientData
from repro.fl import baselines as jbaselines
from repro.fl import compress as jcompress
from repro.fl import faults as jfaults
from repro.fl.client import Client as JClient
from repro.models import model as jmodel
from repro.models.unet import init_unet as jinit_unet
from repro_torch import data as tdata
from repro_torch.configs import ALL_CONFIGS, SMOKE_UNET, FLConfig
from repro_torch.convert import params_from_jax, state_dict
from repro_torch.core import hfl as thfl
from repro_torch.core.hfl import FedPhD
from repro_torch.experiment import data as exp_data
from repro_torch.experiment.run import run_spec
from repro_torch.experiment.spec import (CommSpec, DataSpec, ExperimentSpec,
                                         FaultSpec)
from repro_torch.fl import baselines, compress, faults
from repro_torch.fl.client import Client
from repro_torch.models import model as tmodel
from repro_torch.tree import tree_leaves, tree_map

CPU = torch.device("cpu")
# a one-level SMOKE U-Net at half its width: the file's runs stay cheap
ONE_LEVEL = dict(channel_mults=(1,), attn_resolutions=(16,),
                 base_channels=16)
JCFG = JAX_SMOKE.replace(backend="xla", precision="fp32", **ONE_LEVEL)
CFG = SMOKE_UNET.replace(precision="fp32", **ONE_LEVEL)
# every kind of fault at once: over 3 rounds of 4 clients this seed has
# rounds with dropped and truncated clients (a deadline of 0.75 caps
# every client, so under staleness every completed client is late)
FAULT = FaultSpec(arrival=0.9, dropout=0.25, straggler_frac=0.5,
                  slowdown=2.0, deadline=0.75, churn=0.1, seed=1)
# the staleness runs': the fast half is on time, the slow half late, so
# an aggregate can take reporters and buffer late deltas in one round
# (with this seed FedPhD's edges do so in each of its 3 rounds and
# FedAvg in both of its 2; a client drops in round 2, one does not
# arrive in rounds 1 and 3)
STALE = FAULT.replace(deadline=1.0, seed=37)
FL_KW = dict(num_clients=4, num_edges=2, rounds=3, cloud_agg_every=1,
             sparse_rounds=2)
# the port's two engines: params within the reference's bar for its
# own engines (tests/test_baseline_engines.py:47), losses relative
PARAMS_ATOL = 1e-5
LOSS_RTOL = 1e-4
TINY = dict(name="tiny", num_classes=4, image_size=16, samples_per_class=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clients(pkg_data, pkg_client, n_images=6, batch=2):
    """4 clients of 2 SMOKE classes, 3 steps a round each: a deadline of
    0.75 leaves 2 steps to a fast client and 1 to a slow one, a deadline
    of 1.0 all 3 to a fast one and 1 to a slow one."""
    ds = dataclasses.replace(tdata.SMOKE_DATA, samples_per_class=8)
    images, labels = tdata.make_dataset(ds, seed=0)
    parts = tdata.shards_per_client(labels, 4, 2, seed=0)
    return [pkg_client(i, pkg_data(images[p][:n_images],
                                   labels[p][:n_images], batch_size=batch,
                                   seed=i), ds.num_classes)
            for i, p in enumerate(parts)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# (a) the fault stream, bitwise
# ---------------------------------------------------------------------------

SPECS = (FAULT, STALE, FaultSpec(arrival=0.5, seed=3),
         FaultSpec(churn=0.6, dropout=0.5, seed=2),
         FaultSpec(straggler_frac=0.3, slowdown=3.0, deadline=0.5))


def _draws(model, pkg_rng, rounds, staleness):
    """``rounds`` rounds of churn, a selection from the online pool and
    the schedule, as the trainers draw them."""
    out = []
    for r in range(rounds):
        pool = np.flatnonzero(model.begin_round())
        C = min(5, len(pool))
        sel = pool[pkg_rng.choice(len(pool), size=C, replace=False)]
        f = model.draw_round(sel, [4 + (c % 3) for c in sel], staleness)
        out.append((model.online.tolist(), f.availability(), f.summary(),
                    f.completed.tolist(), f.reporting.tolist(),
                    [f.budget_of(c) for c in sel]))
    return out


@pytest.mark.parametrize("staleness", [False, True])
def test_fault_stream_matches_reference(staleness):
    """``FaultSpec``'s fields, validation and ``enabled``; the stream of
    ``FaultModel`` (speeds, churn, schedules, availability and summary
    records) over 8 rounds of 12 clients for four specs; and its state
    after a save and restore: all equal to the reference's."""
    assert FaultSpec().to_dict() == jfaults.FaultSpec().to_dict()
    for spec in SPECS + (FaultSpec(),):
        j = jfaults.FaultSpec.from_dict(spec.to_dict())
        assert spec.enabled == j.enabled
        assert FaultSpec.from_dict({**spec.to_dict(), "x": 1}) == spec
    for bad in (dict(arrival=1.5), dict(slowdown=0.5), dict(deadline=0.0)):
        with pytest.raises(ValueError):
            FaultSpec(**bad)
    assert faults.make_fault_model(FaultSpec(), 4, 0) is None
    assert faults.make_fault_model(None, 4, 0) is None
    for i, spec in enumerate(SPECS):
        got = faults.FaultModel(spec, 12, base_seed=i)
        want = jfaults.FaultModel(jfaults.FaultSpec.from_dict(
            spec.to_dict()), 12, base_seed=i)
        assert np.array_equal(got.speed, want.speed)
        assert _draws(got, np.random.default_rng(i), 4, staleness) == \
            _draws(want, np.random.default_rng(i), 4, staleness)
        st = got.state()
        back = faults.FaultModel(spec, 12, base_seed=i)
        back.set_state(st)
        assert st == want.state()
        assert _draws(back, np.random.default_rng(9), 4, staleness) == \
            _draws(want, np.random.default_rng(9), 4, staleness)


# ---------------------------------------------------------------------------
# (b) the quantizer, the round trips, the late helpers and the bytes
# ---------------------------------------------------------------------------

def _leaves(quant, r):
    """Leaves of 10 elements that test the rounding: with maxabs = qmax
    the scale is 1, so int8 sees exact .5 ties (half to even) and fp8
    exact ties between its neighbours (normal and subnormal); deltas far
    beyond +-448; small ones; and an all-zero leaf."""
    if quant == "int8":
        ties = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0, 3.25]
    else:
        ties = [448.0, 1.0625, 1.1875, 17.0, 432.0, -432.0, 3 * 2.0 ** -10,
                1e-4, -300.0, 0.0]
    return [np.asarray(ties, np.float32),
            (r.standard_normal(10) * 5e5).astype(np.float32),
            (r.standard_normal(10) * 1e-3).astype(np.float32),
            np.zeros(10, np.float32)]


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantizer_matches_reference(quant):
    """The payload bits and scale of ``_quantize_leaf``, and the
    dequantized deltas and residuals of ``ef_roundtrip`` and
    ``ef_roundtrip_stacked`` (3 clients, one of them all zeros; 400
    clients of one leaf each, some of whose largest values land past
    448 after the division), bitwise."""
    r = np.random.default_rng(7)
    leaves = _leaves(quant, r)
    for v in leaves:
        q, s = compress._quantize_leaf(torch.from_numpy(v), quant, False)
        jq, js = jcompress._quantize_leaf(jnp.asarray(v), quant, None)
        assert np.array_equal(_np(q.view(torch.uint8)),
                              np.asarray(jq).view(np.uint8))
        assert np.array_equal(_np(s).reshape(-1), np.asarray(js).reshape(-1))
    errs = [(r.standard_normal(10) * 0.3).astype(np.float32)
            for _ in leaves]
    # keys in sorted order: jax.tree visits them sorted
    tree = {"a": leaves[:2], "b": {"s": leaves[2], "z": leaves[3]}}
    etree = {"a": errs[:2], "b": {"s": errs[2], "z": errs[3]}}
    got = compress.ef_roundtrip(tree_map(torch.from_numpy, tree),
                                tree_map(torch.from_numpy, etree), quant)
    want = jcompress.ef_roundtrip(tree, etree, quant)
    for g, w in zip(got, want):
        gl = [_np(x) for x in tree_leaves(g)]
        wl = [np.asarray(x) for x in tree_leaves(w)]
        assert all(np.array_equal(x, y) for x, y in zip(gl, wl, strict=True))
    # 3 clients [x, 0, -x] and 400 more of magnitudes 1e-3 to 1e5; a
    # stacked scalar leaf
    big = (r.standard_normal((403, 10)) * 10.0 ** r.integers(
        -3, 6, (403, 1))).astype(np.float32)
    big[:3] = [leaves[1], np.zeros(10), -leaves[1]]
    stacked = {"big": big, "s": np.asarray([1.5, 0.0, -3.0], np.float32)}
    err = tree_map(lambda x: np.zeros_like(x), stacked)
    err["big"][0] += 0.25
    got = compress.ef_roundtrip_stacked(tree_map(torch.from_numpy, stacked),
                                        tree_map(torch.from_numpy, err),
                                        quant)
    want = jcompress.ef_roundtrip_stacked(stacked, err, quant)
    for g, w in zip(got, want):
        for k in stacked:
            assert np.array_equal(_np(g[k]), np.asarray(w[k])), k
    # a stacked row is the round trip of that client alone
    one = compress.ef_roundtrip({"big": torch.from_numpy(big[2])},
                                {"big": torch.zeros(10)}, quant)
    assert torch.equal(one[0]["big"], got[0]["big"][2])
    if quant == "fp8":          # some largest values pass 448 divided
        amax = np.abs(big).max(axis=1, keepdims=True)
        scaled = big[3:] / (amax[3:] / np.float32(448.0))
        assert (np.abs(scaled) > 448.0).any()


def test_late_helpers_bytes_and_comm_spec_match_reference():
    """``apply_late`` and ``late_delta`` within 1e-6 relative (fp32);
    ``uplink_bytes`` and ``downlink_bytes`` of the SMOKE U-Net for each
    uplink dtype and precision, and ``CommSpec``, exactly."""
    r = np.random.default_rng(3)
    # keys in sorted order: jax.tree visits them sorted
    mk = lambda: {"b": [r.standard_normal(3).astype(np.float32)],
                  "w": r.standard_normal((4, 5)).astype(np.float32)}
    base, d, m1, m2 = mk(), mk(), mk(), mk()
    t = lambda tree: tree_map(torch.from_numpy, tree)
    pairs = ((faults.apply_late(t(base), t(d), 0.5),
              jfaults.apply_late(base, d, 0.5)),
             (faults.late_delta([t(m1), t(m2)], t(base), [0.25, 0.125]),
              jfaults.late_delta([m1, m2], base, [0.25, 0.125])))
    for got, want in pairs:
        for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-6,
                                       atol=1e-7)
    shapes = jax.eval_shape(lambda k: jinit_unet(k, JAX_SMOKE),
                            jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tp = params_from_jax(jp, CPU)
    for quant in compress.QUANTS:
        assert compress.uplink_bytes(tp, quant) == \
            jcompress.uplink_bytes(jp, quant)
    for prec in ("fp32", "bf16"):
        assert compress.downlink_bytes(tp, prec) == \
            jcompress.downlink_bytes(jp, prec)
    assert CommSpec(quant="fp8").to_dict() == \
        jcompress.CommSpec(quant="fp8").to_dict()
    with pytest.raises(ValueError, match="comm.quant"):
        CommSpec(quant="int4")


# ---------------------------------------------------------------------------
# (c) the trainers' host records against the reference's
# ---------------------------------------------------------------------------

def _pattern(shape):
    """A fixed fp32 direction in [-1, 1] for a leaf of ``shape``."""
    n = int(np.prod(shape))
    return np.sin(np.arange(n) * 0.61 + 0.37 * n).astype(
        np.float32).reshape(shape)


def _host_training(tmap, to_np, from_np):
    """A ``run_local`` for either package: the client's shuffles drain as
    in a real round, and its params move by ``1e-3 (cid + 1) steps``
    along :func:`_pattern` in numpy fp32, ``steps`` its budget; the loss
    is a function of the client, 0 for a client that ran no step."""
    def run_local(step_fn, params, client, *, epochs, opt_state=None,
                  max_steps=None, **_):
        steps = sum(1 for _ in range(epochs) for _ in client.data.epoch())
        if max_steps is not None:
            steps = min(steps, max_steps)
        c = np.float32(1e-3 * (client.cid + 1) * steps)
        new = tmap(lambda p: from_np(to_np(p) + c * _pattern(p.shape)),
                   params)
        return new, opt_state, (1.0 + 0.125 * client.cid) if steps else 0.0
    return run_local


@functools.lru_cache(maxsize=1)
def _init_np():
    """The one-level SMOKE U-Net's params, numpy normal(0, 0.05)."""
    shapes = jax.eval_shape(lambda k: jinit_unet(k, JCFG),
                            jax.random.PRNGKey(0))
    r = np.random.default_rng(5)
    return jax.tree.map(lambda s: (0.05 * r.standard_normal(s.shape))
                        .astype(np.float32), shapes)


# XLA's optimisation passes off (as tests/test_torch_engine.py compiles
# the reference's round program): the same graph, a quarter of the
# compile time on the CPU
O0 = {"xla_backend_optimization_level": 0,
      "xla_llvm_disable_expensive_passes": True}


_EF_PROGRAMS = {}


def _ef_o0(delta, err, quant):
    """The reference's ``ef_roundtrip`` under jit, as its trainers run it
    (``ef_roundtrip_jit``), compiled with O0 once per tree and dtype."""
    key = (jax.tree.structure(delta), quant,
           tuple(np.shape(x) for x in jax.tree.leaves(delta)))
    if key not in _EF_PROGRAMS:
        _EF_PROGRAMS[key] = jax.jit(
            lambda d, e: jcompress.ef_roundtrip(d, e, quant)).lower(
                delta, err).compile(compiler_options=O0)
    return _EF_PROGRAMS[key](delta, err)


@pytest.fixture
def host_training(monkeypatch):
    """Both packages start from :func:`_init_np` and train with
    :func:`_host_training`; the prune scores are ``size..1`` in both (the
    reference's group-L2 would compile).  The reference's aggregation,
    late merge and late sums stay live (eager), its round trip too
    (:func:`_ef_o0`); its state rows live on the host store."""
    monkeypatch.setattr(jmodel, "init", lambda key, cfg: jax.tree.map(
        np.copy, _init_np()))
    monkeypatch.setattr(tmodel, "init", lambda cfg, gen, device="cuda":
                        params_from_jax(_init_np(), device))
    jrun = _host_training(jax.tree.map, np.asarray, lambda x: x)
    trun = _host_training(tree_map, lambda t: t.detach().numpy(),
                          torch.from_numpy)
    for mod in (jhfl, jbaselines):
        monkeypatch.setattr(mod, "run_local", jrun)
        monkeypatch.setattr(mod, "_ef_jit", _ef_o0)
    monkeypatch.setattr(thfl, "run_local", trun)
    monkeypatch.setattr(baselines, "run_local", trun)
    monkeypatch.setattr(jhfl, "l2_scores", lambda params, groups, **_: {
        g.name: np.arange(g.size, 0, -1, dtype=np.float32) for g in groups})
    monkeypatch.setattr(thfl, "l2_scores", lambda params, groups: {
        g.name: torch.arange(g.size, 0, -1, dtype=torch.float32)
        for g in groups})
    # no Adam zeros: the host update takes no optimizer
    monkeypatch.setattr(jhfl, "adam_init", lambda params: None)


HOST_KEYS = ("selected", "availability", "comm_gb", "comm_up_gb",
             "comm_down_gb", "params_m", "loss")
# the port's state against the reference's after a round from the same
# state: fp32 sums taken in another order (the weights are not powers of
# two); SCAFFOLD's variates are (start - trained) / (K lr), K <= 3 steps
# and lr 2e-4, so they are held at VALUE_ATOL / (3 lr)
VALUE_ATOL = 1e-6
VARIATE_ATOL = VALUE_ATOL / (3 * 2e-4)


def _host(history):
    return [[getattr(h, k) for k in HOST_KEYS] for h in history]


# the port's runs: name -> (trainer, aggregation, quant, rounds, fault);
# FedPhD crosses the prune (sparse, pruned, compacted)
CASES = {
    "fedphd-stale int8": ("fedphd", "staleness", "int8", 3, STALE),
    "fedavg-stale int8": ("fedavg", "staleness", "int8", 2, STALE),
    "scaffold int8": ("scaffold", "fedavg", "int8", 2, FAULT),
    "moon fp8": ("moon", "fedavg", "fp8", 2, FAULT),
}


def _trainer(case, eng, pkg):
    """The case's trainer of the port (``pkg`` "torch") or of the
    reference ("jax", host store), with the edge assignment of each of
    its rounds recorded in ``tr.assignments`` (one edge: the flat
    trainers' selection)."""
    method, agg, quant, rounds, fault = CASES[case]
    port = pkg == "torch"
    clients = _clients(tdata.ClientData, Client) if port else \
        _clients(JClientData, JClient)
    kw = dict(engine=eng, aggregation=agg, quant=quant)
    if port:
        kw.update(device="cpu", fault=fault)
    else:
        kw.update(state_store="host",
                  fault=jfaults.FaultSpec.from_dict(fault.to_dict()))
    if method == "fedphd":
        tr = (FedPhD if port else jhfl.FedPhD)(
            CFG if port else JCFG, (FLConfig if port else JFLConfig)(
                **FL_KW), clients, **kw)
    else:
        tr = (baselines.FlatTrainer if port else jbaselines.FlatTrainer)(
            method, CFG if port else JCFG, (FLConfig if port else JFLConfig)(
                num_clients=4, rounds=rounds), clients, **kw)
    tr.assignments = []
    for name in ("_local_and_edge_sequential", "_local_and_edge_vectorized"):
        if hasattr(tr, name):
            def rec(r, assignment, *a, _inner=getattr(tr, name)):
                tr.assignments.append({e: list(c)
                                       for e, c in assignment.items()})
                return _inner(r, assignment, *a)
            setattr(tr, name, rec)
    return tr


def _port(case, eng):
    tr = _trainer(case, eng, "torch")
    tr.run(CASES[case][3])
    return tr


@pytest.fixture(scope="module")
def port_runs():
    """(case, engine) -> the port's trainer after its rounds, computed
    on first use."""
    class Runs(dict):
        def __missing__(self, key):
            self[key] = _port(*key)
            return self[key]
    return Runs()


def _mixed_rounds(tr):
    """The rounds in which one aggregate took an on-time reporter and
    buffered a late client."""
    out = []
    for h, asg in zip(tr.history, tr.assignments or
                      [{0: h.selected} for h in tr.history]):
        a = h.availability
        late = set(a["late"])
        on_time = set(a["arrived"]) - set(a["dropped"]) - late
        if any(set(c) & on_time and set(c) & late for c in asg.values()):
            out.append(h.round)
    return out


def _flat_state(tr):
    """A trainer's ``state()`` arrays as dotted key -> numpy array, its
    random key and generator left out."""
    arrays, _ = tr.state()
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v)
            for k, v in state_dict(arrays).items()
            if v is not None and not k.endswith("rng")}


def _restore_from(tr, jtr):
    """The port's trainer set to the reference's state (copies, so that
    neither aliases the other's host rows), its own generator kept."""
    arrays, meta = jtr.state()
    arrays = jax.tree.map(np.array, arrays)
    arrays["torch_rng"] = tr.gen.get_state().numpy()
    tr.restore(arrays, meta)


@pytest.mark.parametrize("case", list(CASES))
def test_host_records_match_reference(case, host_training):
    """Each case under its fault spec, round by round on the sequential
    engine from the reference's state at the round's start, against the
    reference's round: the selection, availability record, loss (the
    mean over clients that ran a step), bytes (on-time uploads
    quantized, late and edge uploads fp32, downloads to the arrived
    clients) and params_m equal; the params, edge models, late-delta
    buffers, error-feedback rows and MOON's previous models within
    VALUE_ATOL, SCAFFOLD's variates within VARIATE_ATOL; the edges'
    class counts and MOON's seen flags equal.  The staleness cases have
    a round whose aggregate takes an on-time reporter and buffers a late
    client; every case has a dropped and a truncated client and nonzero
    error-feedback rows.  Two rounds: FedPhD prunes in its second
    (R_s = 2), where the late buffers are dropped and the error rows
    reset; the compacted rounds after it run the same code on smaller
    leaves (held across the port's engines) and would only add the
    reference's eager compiles."""
    rounds = 2
    tr, jtr = _trainer(case, "sequential", "torch"), \
        _trainer(case, "sequential", "jax")
    err_sent = False
    for r in range(1, rounds + 1):
        if r > 1:
            _restore_from(tr, jtr)
        tr.run(r)
        jtr.run(r)
        assert _host(tr.history[-1:]) == _host(jtr.history[-1:]), r
        got, want = _flat_state(tr), _flat_state(jtr)
        assert got.keys() == want.keys()
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape, (r, k)
            if w.dtype.kind in "biu":
                assert np.array_equal(g, w), (r, k)
                continue
            tol = VARIATE_ATOL if k.startswith("c_") else VALUE_ATOL
            assert np.abs(g.astype(np.float64) - w).max() <= tol, (r, k)
        err_sent |= any(x.abs().max() > 0 for x in tree_leaves(tr._err_stack))
    hist = jtr.history
    avail = [h.availability for h in hist]
    assert any(a["dropped"] for a in avail)
    assert any(b < 3 for a in avail for b in a["budgets"])
    assert err_sent
    if CASES[case][1] == "staleness":
        assert _mixed_rounds(tr)


# ---------------------------------------------------------------------------
# (d) the port's engines against each other, the disabled spec, resume
# ---------------------------------------------------------------------------

def _max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


@pytest.mark.parametrize("case", list(CASES))
def test_engines_agree_under_faults(case, port_runs):
    """Under the case's fault spec the sequential and vectorized engines
    give the same selections, availability and bytes, each round's loss
    within
    LOSS_RTOL, the params, error-feedback rows and late buffers within
    PARAMS_ATOL (SCAFFOLD's variates in parameter units: x K lr, K <= 3
    steps), and the same MOON rows within PARAMS_ATOL."""
    seq, vec = port_runs[case, "sequential"], port_runs[case, "vectorized"]
    assert _host(seq.history) == _host(vec.history)
    for a, b in zip(seq.history, vec.history, strict=True):
        assert abs(a.loss - b.loss) <= LOSS_RTOL * max(abs(a.loss), 1e-12)
    assert _max_diff(seq.params, vec.params) <= PARAMS_ATOL
    assert _max_diff(seq._err_stack, vec._err_stack) <= PARAMS_ATOL
    if CASES[case][0] == "scaffold":
        assert _max_diff(seq._c_local_stack, vec._c_local_stack) \
            * 3 * 2e-4 <= PARAMS_ATOL
    if CASES[case][0] == "moon":
        assert _max_diff(seq._prev_stack, vec._prev_stack) <= PARAMS_ATOL
        assert np.array_equal(seq._seen, vec._seen)
    seq_late, vec_late = seq.late_buffers(), vec.late_buffers()
    assert seq_late.keys() == vec_late.keys()
    for e in seq_late:
        assert _max_diff(seq_late[e], vec_late[e]) <= PARAMS_ATOL
    if CASES[case][0] == "fedphd":
        assert [h.pruned for h in seq.history] == [False, True, False]
        assert seq_late                     # a late delta is buffered


def test_disabled_fault_spec_is_the_fault_free_path():
    """``FaultSpec()`` and ``quant="none"`` against ``fault=None`` on the
    vectorized engine: the history and the params bit for bit."""
    fl = FLConfig(**(FL_KW | dict(participation=0.5)))
    a, b = (FedPhD(CFG, fl, _clients(tdata.ClientData, Client),
                   device="cpu", **kw)
            for kw in (dict(fault=FaultSpec(), quant="none"), {}))
    a.run(1)
    b.run(1)
    assert a._faults is None and a._err_stack is None
    assert [h.to_dict() for h in a.history] == \
        [h.to_dict() for h in b.history]
    assert a.history[0].availability is None
    assert _max_diff(a.params, b.params) == 0.0


@pytest.fixture
def tiny_experiment(monkeypatch):
    """A 16-image dataset and the one-level SMOKE U-Net, registered for
    the experiment API."""
    exp_data.register_dataset("tiny", tdata.DatasetSpec(**TINY),
                              overwrite=True)
    monkeypatch.setitem(ALL_CONFIGS, "tiny-unet",
                        CFG.replace(name="tiny-unet"))
    yield
    del exp_data.DATASETS["tiny"]


@pytest.mark.parametrize("method,rounds", [("fedphd-stale", 3),
                                           ("fedavg-stale", 2)])
def test_resume_is_bitwise_under_faults(method, rounds, tmp_path,
                                        tiny_experiment):
    """The registry's staleness methods through ``run_spec`` with STALE
    and the int8 uplink (FedPhD through the prune), on the vectorized
    engine: the run unbroken against one killed after each round and
    resumed from its checkpoint: the history (availability included),
    params, error-feedback rows (nonzero: on-time clients sent int8),
    late buffers and the fault stream bit for bit; a round of the run
    has both an on-time reporter and a late client."""
    spec = ExperimentSpec(
        name="tiny", method=method, model="tiny-unet", seed=0,
        engine="vectorized", fault=STALE, comm=CommSpec(quant="int8"),
        fl=FLConfig(**(FL_KW | dict(rounds=rounds))),
        data=DataSpec(dataset="tiny", classes_per_client=2, batch_size=2))
    whole = run_spec(spec, device="cpu")
    ck = str(tmp_path / "ckpt.npz")
    run_spec(spec, rounds=1, ckpt=ck, device="cpu")
    for r in range(2, rounds + 1):
        back = run_spec(None, resume=True, rounds=r, ckpt=ck, device="cpu")
    a, b = whole.trainer, back.trainer
    assert [h.to_dict() for h in b.history] == \
        [h.to_dict() for h in a.history]
    assert any(set(av["late"]) and set(av["arrived"]) - set(av["dropped"])
               - set(av["late"]) for av in (h.availability
                                            for h in a.history))
    assert any(x.abs().max() > 0 for x in tree_leaves(a._err_stack))
    assert _max_diff(a.params, b.params) == 0.0
    assert _max_diff(a._err_stack, b._err_stack) == 0.0
    a_late, b_late = a.late_buffers(), b.late_buffers()
    assert a_late.keys() == b_late.keys()
    for e in a_late:
        assert _max_diff(a_late[e], b_late[e]) == 0.0
    assert a._faults.state() == b._faults.state()
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
