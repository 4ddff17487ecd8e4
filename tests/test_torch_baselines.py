"""The flat baselines of the port (``repro_torch.fl.baselines``): FedAvg,
FedProx, MOON, SCAFFOLD and FedDiffuse on both round engines, and
centralized training with an EMA.

The method terms against the reference's on numpy inputs (no U-Net);
MOON's loss and gradient against the reference's on a one-level SMOKE
U-Net (the file's one reference ``jit``); each method's host records
(selections, bytes, params_m) against the reference's trainer, whose
local training is replaced (``monkeypatch``, test-only) by one that
drains the clients' shuffles, so that it never compiles; the port's
sequential engine against its vectorized one per method; MOON's draws;
the registry and the refusals; a resume through ``run_spec``; and
``run_centralized``.

The reference draws the DDPM t and eps and MOON's feature noise from
``jax.random``, which the port cannot reproduce: in the loss test both
packages read them from the batch (the reference through a monkeypatch
of ``model.loss_fn`` and ``fl.client.model_features``, the port through
the loss's ``t``, ``eps`` and ``feat_eps`` arguments).  Between the
port's own engines nothing is injected: the vectorized engine draws the
sequential engine's numbers by construction.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_UNET as JAX_SMOKE
from repro.configs.base import FLConfig as JFLConfig
from repro.core import aggregation as jagg
from repro.data.pipeline import ClientData as JClientData
from repro.diffusion import ddpm as jddpm
from repro.diffusion.schedule import linear_schedule as jlinear_schedule
from repro.fl import baselines as jbaselines
from repro.fl import client as jclient
from repro.fl.client import Client as JClient
from repro.models import model as jmodel
from repro.models.unet import apply_unet as japply_unet
from repro.models.unet import init_unet as jinit_unet
from repro.optim import ema_init as jema_init
from repro.optim import ema_update as jema_update
from repro_torch import data as tdata
from repro_torch.configs import ALL_CONFIGS, SMOKE_UNET, FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import uniform_weights, weighted_average
from repro_torch.experiment import data as exp_data
from repro_torch.experiment.registry import method_entry, registered_methods
from repro_torch.experiment.run import run_spec
from repro_torch.experiment.spec import DataSpec, ExperimentSpec, FaultSpec
from repro_torch.fl import baselines, engine
from repro_torch.fl import client as tclient
from repro_torch.obs.trace import Tracer
from repro_torch.optim import adam_init, ema_init, ema_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

JCFG = JAX_SMOKE.replace(backend="xla", precision="fp32")
CFG = SMOKE_UNET.replace(precision="fp32")
ONE_LEVEL = dict(channel_mults=(1,), attn_resolutions=(16,))
T = SMOKE_UNET.diffusion_steps
CPU = torch.device("cpu")
LR = 2e-4
METHODS = ("fedavg", "fedprox", "moon", "scaffold", "feddiffuse")
# the port's two engines: params within the reference's own bar for its
# engines (tests/test_baseline_engines.py:47), losses relative
PARAMS_ATOL = 1e-5
LOSS_RTOL = 1e-4
TINY = dict(name="tiny", num_classes=4, image_size=16, samples_per_class=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, r):
    """Weights at 1/sqrt(fan_in), norm scales near 1, small biases: the
    reference init's 1e-6 conv2/proj/conv_out would make parity trivial."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = _randomize(v, r)
                continue
            z = r.standard_normal(v.shape).astype(np.float32)
            if k == "w":
                z = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "scale":
                z = 1.0 + 0.1 * z
            else:
                z = 0.1 * z
            out[k] = z.astype(np.float32)
        return out
    return [_randomize(v, r) for v in tree]


def _np_params(jcfg, seed):
    shapes = jax.eval_shape(lambda k: jinit_unet(k, jcfg),
                            jax.random.PRNGKey(0))
    return _randomize(shapes, np.random.default_rng(seed))


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close_trees(got, want, rtol=1e-6):
    """Leaf by leaf in the reference's key order (``jax.tree`` sorts)."""
    g = jax.tree.leaves(tree_map(_np, got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-7)


def _t(tree):
    return tree_map(torch.from_numpy, tree)


# ---------------------------------------------------------------------------
# (a) the method terms against the reference, on numpy inputs
# ---------------------------------------------------------------------------

def test_method_terms_match_reference():
    """``tree_sq_dist`` (one model and stacked rows), the cosine and
    MOON's contrastive term, SCAFFOLD's correction, its c_i+ and c
    update, ``uniform_weights`` and the EMA, within 1e-6 relative."""
    r = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": [(3,), (2, 2, 4)]}
    mk = lambda: jax.tree.map(lambda s: r.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
    a, b, c, d = mk(), mk(), mk(), mk()
    want = float(jclient.tree_sq_dist(a, b))
    assert abs(float(tclient.tree_sq_dist(_t(a), _t(b))) - want) \
        <= 1e-6 * want
    rows = engine.stack_trees([_t(a), _t(c)])
    got = tclient.tree_sq_dist(rows, _t(b), clients=2).numpy()
    np.testing.assert_allclose(
        got, [want, float(jclient.tree_sq_dist(c, b))], rtol=1e-6)
    # cosine and the contrastive term of 2 clients x 3 rows
    z, zg, zp = (r.standard_normal((6, 40)).astype(np.float32)
                 for _ in range(3))
    zg[0] = 0.0                                  # the +1e-8 on a zero norm
    np.testing.assert_allclose(
        tclient._cosine(torch.from_numpy(z), torch.from_numpy(zg)).numpy(),
        np.asarray(jclient._cosine(z, zg)), rtol=1e-6, atol=1e-7)
    tau = 0.5
    sim_g, sim_p = jclient._cosine(z, zg) / tau, jclient._cosine(z, zp) / tau
    con = -jnp.mean((sim_g - jnp.logaddexp(sim_g, sim_p)).reshape(2, 3),
                    axis=1)
    feats = {"trained": z, "global_params": zg, "prev_params": zp}
    orig = tclient.model_features
    try:
        tclient.model_features = lambda p, *a, **k: torch.from_numpy(
            feats[p])
        got = tclient.moon_term("trained", {"global_params": "global_params",
                                            "prev_params": "prev_params"},
                                CFG, None, None, tau, clients=2)
    finally:
        tclient.model_features = orig
    np.testing.assert_allclose(got.numpy(), np.asarray(con), rtol=1e-6)
    # SCAFFOLD: the correction, c_i+ = c_i - c + s (x - y), the c update
    ctx = {"c_local": c, "c_global": d}
    _close_trees(tclient.scaffold_correction(
        _t(a), {"c_local": _t(c), "c_global": _t(d)}),
        jclient.scaffold_correction(a, ctx))
    scale = 1.0 / (3 * LR)
    ci_new = jax.tree.map(lambda ci, cg, x, y: ci - cg + scale * (x - y),
                          c, d, a, b)
    got = tclient.scaffold_update(_t(c), _t(d), _t(a), _t(b), scale)
    _close_trees(got, ci_new)
    # stacked rows of 2 clients from one start model, per-client scales
    stacked = tclient.scaffold_update(
        engine.stack_trees([_t(c), _t(c)]), _t(d),
        tree_map(lambda x: x[None], _t(a)),
        engine.stack_trees([_t(b), _t(b)]),
        torch.tensor([scale, 2 * scale], dtype=torch.float32))
    _close_trees(tree_map(lambda x: x[0], stacked), ci_new)
    deltas = [jax.tree.map(lambda x, y: x - y, ci_new, c),
              jax.tree.map(lambda x, y: 0.5 * (x - y), ci_new, c)]
    want = jagg.weighted_average(deltas, jagg.uniform_weights(2))
    assert np.array_equal(uniform_weights(5), jagg.uniform_weights(5))
    _close_trees(weighted_average([_t(jax.tree.map(np.asarray, t_))
                                   for t_ in deltas], uniform_weights(2)),
                 want)
    # the EMA, fp32 whatever the params' dtype
    e_j, e_t = jema_init(a), ema_init(_t(a))
    for p in (b, c):
        e_j, e_t = jema_update(e_j, p, 0.999), ema_update(e_t, _t(p), 0.999)
    _close_trees(e_t, e_j)
    assert all(x.dtype == torch.float32 for x in tree_leaves(
        ema_init(tree_map(lambda x: x.to(torch.bfloat16), _t(a)))))


def test_split_shared_and_shared_fraction_match_reference():
    """FedDiffuse's halves of a SMOKE U-Net: the same key sets and shared
    fraction; ``_merge`` rebuilds the model's own key order."""
    tp = params_from_jax(_np_params(JCFG, 1), CPU)
    jp = _np_params(JCFG, 1)
    for got, want in zip(baselines._split_shared(tp, CFG),
                         jbaselines._split_shared(jp, JCFG)):
        assert set(got) == set(want)
    assert baselines.shared_fraction(tp, CFG) == \
        jbaselines.shared_fraction(jp, JCFG)
    shared, local = baselines._split_shared(tp, CFG)
    assert list(baselines._merge(shared, local, tp)) == list(tp)
    assert list({**shared, **local}) != list(tp)


# ---------------------------------------------------------------------------
# (b) MOON's loss and gradient against the reference (the one jit)
# ---------------------------------------------------------------------------

def _jax_injected_loss(params, cfg, batch, rng, opts=None, *, masks=None):
    sched = jlinear_schedule(cfg.diffusion_steps)
    x_t = jddpm.q_sample(sched, batch["images"], batch["t"], batch["eps"])
    pred = japply_unet(params, cfg, x_t, batch["t"], masks=masks)
    return jnp.mean(jnp.square(batch["eps"] - pred))


def _jax_injected_features(params, cfg, batch, rng):
    """The reference's ``model_features`` with the batch's feature noise
    in place of its ``jax.random.normal(rng, ...)``."""
    sched = jlinear_schedule(cfg.diffusion_steps)
    B = batch["images"].shape[0]
    t = jnp.full((B,), cfg.diffusion_steps // 2, jnp.int32)
    x_t = jddpm.q_sample(sched, batch["images"], t, batch["feat_eps"])
    return japply_unet(params, cfg, x_t, t).reshape(B, -1)


def test_moon_loss_and_grad_match_reference(monkeypatch):
    """``make_loss_fn(method="moon")`` on a one-level SMOKE U-Net with
    trained, global and previous models all different: the loss within
    1e-5 relative, every gradient within 1e-4 of the largest."""
    # attention in the middle block only: a shorter compile
    one = dict(channel_mults=(1,), attn_resolutions=())
    jcfg, cfg = JCFG.replace(**one), CFG.replace(**one)
    fl = FLConfig(moon_mu=1.0, moon_tau=0.5)
    p, g, q = (_np_params(jcfg, s) for s in (31, 32, 33))
    r = np.random.default_rng(9)
    B = 3
    batch = {"images": r.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
             "t": r.integers(0, T, B).astype(np.int32),
             "eps": r.standard_normal((B, 16, 16, 3)).astype(np.float32),
             "feat_eps": r.standard_normal((B, 16, 16, 3))
             .astype(np.float32)}
    monkeypatch.setattr(jmodel, "loss_fn", _jax_injected_loss)
    monkeypatch.setattr(jclient, "model_features", _jax_injected_features)
    jloss = jclient.make_loss_fn(jcfg, JFLConfig(moon_mu=1.0, moon_tau=0.5),
                                 method="moon")
    put = lambda tree: jax.tree.map(jnp.asarray, tree)
    args = (put(p), put(batch), jax.random.PRNGKey(0),
            {"global_params": put(g), "prev_params": put(q)})
    fn = jax.jit(jax.value_and_grad(jloss))
    # LLVM's optimisation passes off: the same graph compiles faster
    want_loss, want_grad = fn.lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)
    tloss = tclient.make_loss_fn(cfg, fl, method="moon")
    tp = tree_map(lambda x: x.requires_grad_(), params_from_jax(p, CPU))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ctx = {"global_params": params_from_jax(g, CPU),
           "prev_params": params_from_jax(q, CPU)}
    loss = tloss(tp, {"images": tb["images"]}, None, t=tb["t"].long(),
                 eps=tb["eps"], ctx=ctx, feat_eps=tb["feat_eps"])
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    ddpm_only = tclient.make_loss_fn(cfg, fl)(
        tp, {"images": tb["images"]}, None, t=tb["t"].long(), eps=tb["eps"])
    assert loss > 1.1 * float(ddpm_only.detach())   # a term that counts
    got = jax.tree.leaves(tree_map(lambda x: x.numpy(),
                                   tree_unflatten(tp, grads)))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_grad))
    scale = max(float(np.abs(w).max()) for w in want)
    assert max(float(np.abs(a - b).max()) for a, b in zip(got, want)) \
        <= 1e-4 * scale
    for leaf in tree_leaves(ctx):               # the anchors get nothing
        assert leaf.grad is None and not leaf.requires_grad


# ---------------------------------------------------------------------------
# (c) host records against the reference trainer
# ---------------------------------------------------------------------------

def _tiny_clients(pkg_data, pkg_client, sizes=(4, 4, 4, 2), batch=2):
    """4 clients of 2 SMOKE classes each; the last holds 2 images, so it
    takes 1 step a round where the others take 2."""
    ds = dataclasses.replace(tdata.SMOKE_DATA, samples_per_class=8)
    images, labels = tdata.make_dataset(ds, seed=0)
    parts = tdata.shards_per_client(labels, 4, 2, seed=0)
    return [pkg_client(i, pkg_data(images[p][:n], labels[p][:n],
                                   batch_size=batch, seed=i),
                       ds.num_classes)
            for i, (p, n) in enumerate(zip(parts, sizes))]


@pytest.fixture
def reference_without_training(monkeypatch):
    """The reference's init as numpy draws of its shapes, its local
    training as a drain of the client's shuffles, its aggregation as the
    first model: its host streams advance as in a real round and nothing
    compiles but a few eager ops."""
    def init(key, cfg):
        shapes = jax.eval_shape(lambda k: jinit_unet(k, cfg), key)
        return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)

    def drain(step_fn, params, client, *, epochs, opt_state=None, **_):
        for _ in range(epochs):
            for _ in client.data.epoch():
                pass
        return params, opt_state, 0.0

    monkeypatch.setattr(jmodel, "init", init)
    monkeypatch.setattr(jbaselines, "run_local", drain)
    monkeypatch.setattr(jbaselines, "aggregate_fedavg",
                        lambda models, counts: models[0])
    monkeypatch.setattr(jbaselines, "tree_scatter",
                        lambda stack, idx, rows: stack)
    monkeypatch.setattr(jbaselines, "tree_gather", lambda stack, idx: stack)
    monkeypatch.setattr(jbaselines, "weighted_average",
                        lambda trees, w: trees[0])


@pytest.mark.parametrize("method", METHODS)
def test_host_records_match_reference(method, reference_without_training,
                                      port_runs):
    """The port's sequential run of FL_KW against the reference's: the
    same selections, bytes and params_m exactly (each depends only on
    the host streams and the parameter counts)."""
    jtr = jbaselines.FlatTrainer(method, JCFG.replace(**ONE_LEVEL),
                                 JFLConfig(**FL_KW),
                                 _tiny_clients(JClientData, JClient),
                                 engine="sequential", state_store="host")
    if method == "scaffold":                     # host arithmetic only
        jtr.c_global = jax.tree.map(np.asarray, jtr.c_global)
    jtr.run()
    tr = port_runs[method]["sequential"][0]
    keys = ("selected", "comm_gb", "comm_up_gb", "comm_down_gb",
            "params_m")
    assert [[getattr(h, k) for k in keys] for h in tr.history] == \
        [[getattr(h, k) for k in keys] for h in jtr.history]


# ---------------------------------------------------------------------------
# (d) the port's engines: sequential against vectorized
# ---------------------------------------------------------------------------

# 4 clients, 3 a round: round 2 may take a client round 1 did not
FL_KW = dict(num_clients=4, participation=0.75, rounds=2)


def _port(method, engine_name, sizes=(4, 4, 4, 2), **kw):
    tr = baselines.FlatTrainer(
        method, CFG.replace(**ONE_LEVEL), FLConfig(**FL_KW),
        _tiny_clients(tdata.ClientData, tclient.Client, sizes),
        device="cpu", engine=engine_name, lr=LR, **kw)
    used = []
    for name in ("_round_sequential", "_round_vectorized"):
        inner = getattr(tr, name)

        def rec(*a, _inner=inner, _name=name):
            used.append(_name)
            return _inner(*a)
        setattr(tr, name, rec)
    tr.run()
    return tr, used


def _state(tr):
    out = {"params": tr.params}
    for k in ("c_global", "_c_local_stack", "_prev_stack", "_local_stack",
              "_opt_stack"):
        if getattr(tr, k) is not None:
            out[k] = getattr(tr, k)
    return {k: [torch.as_tensor(x).float() for x in tree_leaves(v)]
            for k, v in out.items()}


def _assert_engines_agree(seq, vec, atol=PARAMS_ATOL):
    for a, b in zip(seq.history, vec.history, strict=True):
        assert (a.selected, a.comm_gb, a.comm_up_gb, a.comm_down_gb,
                a.params_m) == (b.selected, b.comm_gb, b.comm_up_gb,
                                b.comm_down_gb, b.params_m)
        assert abs(a.loss - b.loss) <= LOSS_RTOL * abs(a.loss)
    sa, sb = _state(seq), _state(vec)
    assert sa.keys() == sb.keys()
    for k in sa:
        # SCAFFOLD's variates in parameter units: their change is
        # (x - y) / (K lr), K = 2 steps
        scale = 2 * LR if "c_" in k else 1.0
        d = max(float((x - y).abs().max()) for x, y in zip(sa[k], sb[k]))
        assert d * scale <= atol, (k, d)
    assert np.array_equal(seq._seen, vec._seen)


@pytest.fixture(scope="module")
def port_runs():
    """method -> engine -> (trainer, the round functions it ran), on
    FL_KW, computed on first use."""
    class Runs(dict):
        def __missing__(self, method):
            self[method] = {e: _port(method, e)
                            for e in ("sequential", "vectorized")}
            return self[method]
    return Runs()


@pytest.mark.parametrize("method", METHODS)
def test_engines_agree(method, port_runs):
    """4 clients, 3 a round for 2 rounds, one client padded (1 real step
    of 2): the same selections and bytes, losses within LOSS_RTOL,
    params and the method's state (c_global and the c_i rows, the
    previous-model and decoder rows) within PARAMS_ATOL; a client's MOON
    and FedDiffuse rows are read from the global model until it takes
    part, and from its own row after."""
    (seq, us), (vec, uv) = (port_runs[method][e]
                            for e in ("sequential", "vectorized"))
    assert us == ["_round_sequential"] * 2
    assert uv == ["_round_vectorized"] * 2
    _assert_engines_agree(seq, vec)
    sel = [set(h.selected) for h in vec.history]
    assert sel[1] - sel[0] and sel[0] & sel[1]   # new and seen clients
    assert vec._seen.tolist() == [c in sel[0] | sel[1] for c in range(4)] \
        if method in ("moon", "feddiffuse") else not vec._seen.any()


def test_persistent_opt_fedprox_engines_agree():
    """FedProx with per-client Adam carried across rounds, on both
    engines, and the host store bitwise equal to the device store."""
    seq, _ = _port("fedprox", "sequential", persistent_opt=True)
    vec, _ = _port("fedprox", "vectorized", persistent_opt=True)
    host, _ = _port("fedprox", "vectorized", persistent_opt=True,
                    state_store="host")
    _assert_engines_agree(seq, vec)
    sel = [h.selected for h in vec.history]
    steps = [sum((c in s) * (1 if c == 3 else 2) for s in sel)
             for c in range(4)]
    assert vec._opt_stack.step.tolist() == steps
    assert isinstance(host._opt_stack.step, np.ndarray)
    for a, b in zip(tree_leaves(host._opt_stack), tree_leaves(vec._opt_stack)):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(tree_leaves(host.params), tree_leaves(vec.params)):
        assert torch.equal(a, b)


def test_ragged_clients_route_sequential():
    """A client smaller than the batch: "auto" warns once, naming the
    trainer and method, and trains it sequentially; an explicit
    "vectorized" raises."""
    sizes = (4, 4, 4, 1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _, used = _port("scaffold", "auto", sizes=sizes)
    msgs = [str(w.message) for w in seen if "ragged" in str(w.message)]
    assert used == ["_round_sequential"] * 2
    assert msgs == ["ragged client batch shapes: FlatTrainer "
                    "(method=scaffold, engine=auto) falling back to the "
                    "sequential round engine"]
    with pytest.raises(ValueError, match="uniform"):
        _port("scaffold", "vectorized", sizes=sizes)


def test_draw_round_moon_matches_sequential_calls():
    """``draw_round(features=True)``: per real step, t, the DDPM eps and
    the feature noise, in the sequential MOON step's order; padded steps
    draw nothing."""
    valid = np.asarray([[True, True], [True, False]])
    shape = (2, 4, 4, 3)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    t, eps, feat = engine.draw_round(g1, valid, shape, T, CPU,
                                     features=True)
    for c, s in ((0, 0), (0, 1), (1, 0)):
        assert torch.equal(t[c, s], torch.randint(0, T, (2,), generator=g2))
        assert torch.equal(eps[c, s], torch.randn(shape, generator=g2))
        assert torch.equal(feat[c, s], torch.randn(shape, generator=g2))
    assert torch.equal(g1.get_state(), g2.get_state())
    assert not feat[1, 1].any()
    assert len(engine.draw_round(g1, valid, shape, T, CPU)) == 2


# ---------------------------------------------------------------------------
# (e) the registry, the refusals and resume
# ---------------------------------------------------------------------------

def test_registry_and_refusals(tmp_path):
    """The five flat methods and ``fedavg-stale`` are registered as
    "flat", ``fedphd-stale`` as "hierarchical"; faults, the quantized
    uplink, the staleness aggregation (FedAvg only) and a tracer are
    accepted; every unported FlatTrainer option raises naming its item;
    without a card the default device raises."""
    assert set(METHODS) <= set(registered_methods())
    assert all(method_entry(m).topology == "flat" for m in METHODS)
    assert method_entry("fedavg-stale").topology == "flat"
    assert method_entry("fedphd-stale").topology == "hierarchical"
    clients = _tiny_clients(tdata.ClientData, tclient.Client)
    fl = FLConfig(num_clients=4)
    for kw in (dict(fault=FaultSpec(dropout=0.5)), dict(quant="int8"),
               dict(aggregation="staleness")):
        baselines.FlatTrainer("fedavg", CFG, fl, clients, device="cpu", **kw)
    tracer = Tracer(str(tmp_path / "t.jsonl"))
    tr = baselines.FlatTrainer("fedavg", CFG, fl, clients, device="cpu",
                               tracer=tracer)
    assert tr._obs is tracer and tr._obs_compile is not None
    tracer.close()
    for kw, item in ((dict(mesh={"data": 2}), "A.13"),):
        with pytest.raises(NotImplementedError, match=item):
            baselines.FlatTrainer("fedavg", CFG, fl, clients, device="cpu",
                                  **kw)
    with pytest.raises(ValueError, match="FedAvg variant"):
        baselines.FlatTrainer("moon", CFG, fl, clients, device="cpu",
                              aggregation="staleness")
    with pytest.raises(ValueError, match="method"):
        baselines.FlatTrainer("fedphd", CFG, fl, clients, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            baselines.FlatTrainer("fedavg", CFG, fl, clients)
        with pytest.raises(RuntimeError, match="CUDA"):
            baselines.run_centralized(CFG, np.zeros((4, 16, 16, 3),
                                                    np.float32),
                                      steps=1, batch_size=2)
    with pytest.warns(DeprecationWarning, match="run_flat_fl"):
        res = baselines.run_flat_fl("fedavg", CFG.replace(**ONE_LEVEL),
                                    FLConfig(num_clients=4, rounds=1),
                                    clients, device="cpu")
    assert len(res.history) == 1 and np.isfinite(res.history[0].loss)


@pytest.fixture
def tiny_experiment(monkeypatch):
    """An 8-image dataset and the one-level SMOKE U-Net, registered for
    the experiment API."""
    exp_data.register_dataset("tiny", tdata.DatasetSpec(**TINY),
                              overwrite=True)
    monkeypatch.setitem(ALL_CONFIGS, "tiny-unet",
                        CFG.replace(name="tiny-unet", **ONE_LEVEL))
    yield
    del exp_data.DATASETS["tiny"]


@pytest.mark.parametrize("method", ["scaffold", "moon"])
def test_resume_is_bitwise(method, tmp_path, tiny_experiment):
    """Two rounds unbroken against one, a checkpoint and a resume: the
    history, the params and the method's stacks bit for bit."""
    spec = ExperimentSpec(
        name="tiny", method=method, model="tiny-unet", seed=3,
        engine="vectorized",
        fl=FLConfig(num_clients=4, rounds=2),
        data=DataSpec(dataset="tiny", classes_per_client=2, batch_size=2))
    whole = run_spec(spec, device="cpu")
    ck = str(tmp_path / "ckpt.npz")
    run_spec(spec, rounds=1, ckpt=ck, device="cpu")
    back = run_spec(None, resume=True, rounds=2, ckpt=ck, device="cpu")
    assert [h.to_dict() for h in back.history] == \
        [h.to_dict() for h in whole.history]
    sa, sb = _state(whole.trainer), _state(back.trainer)
    assert sa.keys() == sb.keys() and len(sa) == 3 - (method == "moon")
    for k in sa:
        assert all(torch.equal(x, y) for x, y in zip(sa[k], sb[k]))
    assert torch.equal(whole.trainer.gen.get_state(),
                       back.trainer.gen.get_state())


# ---------------------------------------------------------------------------
# (f) centralized training
# ---------------------------------------------------------------------------

def test_run_centralized_with_and_without_ema():
    """Three steps from one seed: the same losses either way; without the
    EMA the last step's params, with it the EMA of every step's params
    recomputed here (decay 0.999, fp32), bit for bit."""
    cfg = CFG.replace(**ONE_LEVEL)
    images = np.random.default_rng(2).uniform(
        -1, 1, (10, 16, 16, 3)).astype(np.float32)
    kw = dict(steps=3, batch_size=4, lr=LR, rng_seed=7, device="cpu")
    plain, l0 = baselines.run_centralized(cfg, images, use_ema=False, **kw)
    ema, l1 = baselines.run_centralized(cfg, images, **kw)
    assert l0 == l1 and len(l0) == 3 and np.all(np.isfinite(l0))
    gen = torch.Generator()
    gen.manual_seed(7)
    from repro_torch.models import model as tmodel
    params = tmodel.init(cfg, gen, device="cpu")
    step = tclient.make_local_step(cfg, FLConfig(), lr=LR)
    opt, np_rng = adam_init(params), np.random.default_rng(7)
    mine = [p.clone() for p in tree_leaves(params)]
    for _ in range(3):
        sel = np_rng.integers(0, len(images), size=4)
        params, opt, _ = step(params, opt,
                              {"images": torch.from_numpy(images[sel])}, gen)
        mine = [0.999 * e + (1.0 - 0.999) * p
                for e, p in zip(mine, tree_leaves(params))]
    for a, b in zip(tree_leaves(plain), tree_leaves(params), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ema), mine, strict=True):
        assert torch.equal(a, b)
