"""The experiment API of the port (``repro_torch.experiment``), its
checkpoint state, the eval hook and the client-chunked vectorized engine.

The spec and its presets against the reference's, key for key; the
registry and every refusal of what is not ported yet; a run killed and
resumed inside the port, bitwise on both engines through sparse ->
prune -> plain; trainer checkpoints crossing between the packages both
ways; the vectorized engine trained in client chunks against one chunk,
and the memory arithmetic that picks the chunk; the proxy metrics, their
feature weights and ``sample_images`` against the reference; and the
runner CLI run, resumed and served.

The runs train the SMOKE U-Net on an 8-image dataset registered in both
packages as "tiny" (4 clients of 2 images, batch 2).  The reference
trains nowhere here: where its trainer must advance a round, its local
training is replaced (``monkeypatch``, test-only) by one that drains the
clients' shuffles as training does, and its aggregation by the first
model, so its host streams (selection, shuffles, bytes) advance as in a
real round without compiling anything;
and where it builds a trainer, its initializer is replaced by numpy
draws of the same shapes, which ``restore`` overwrites or the test
reads, so that no initializer compiles either.
"""
import dataclasses
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_UNET as JAX_SMOKE
from repro.core import hfl as jhfl
from repro.core.pruning import apply_masks as japply_masks
from repro.core.pruning import build_groups as jbuild_groups
from repro.core.pruning import sparsity_report as jsparsity_report
from repro.data.synthetic import DatasetSpec as JDatasetSpec
from repro.diffusion import ddim_sample as jddim_sample
from repro.diffusion.schedule import cosine_schedule as jcosine_schedule
from repro.diffusion.schedule import linear_schedule as jlinear_schedule
from repro.experiment import data as jexp_data
from repro.experiment import registry as jregistry
from repro.experiment import run as jrun
from repro.experiment import runner as jrunner
from repro.experiment.spec import ExperimentSpec as JSpec
from repro.metrics import fid as jfid
from repro.models import model as jmodel
from repro.models.unet import apply_unet as japply_unet
from repro.models.unet import init_unet as jinit_unet
from repro_torch import checkpoint
from repro_torch.configs import CIFAR10_UNET, SMOKE_UNET, FLConfig
from repro_torch.configs.base import config_to_dict
from repro_torch.convert import params_from_jax
from repro_torch.core import hfl
from repro_torch.core.hfl import FedPhD, prng_key
from repro_torch.core.pruning import (apply_masks, l2_scores, make_masks,
                                      sparsity_report, unet_groups)
from repro_torch.data import DatasetSpec
from repro_torch.diffusion import sample_images
from repro_torch.diffusion.schedule import cosine_schedule
from repro_torch.experiment import data as exp_data
from repro_torch.experiment import runner
from repro_torch.experiment.registry import (make_trainer, method_entry,
                                             registered_methods)
from repro_torch.experiment.run import Experiment, run_spec
from repro_torch.experiment.spec import (DataSpec, ExperimentSpec, FaultSpec,
                                         ObsSpec)
from repro_torch.experiment.sweep import SweepSpec
from repro_torch.fl import engine
from repro_torch.metrics import fid
from repro_torch.obs.trace import Tracer
from repro_torch.serve.artifact import load_serving_artifact
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
# the reference's programs compile at XLA's O0 with LLVM's expensive
# passes off: the same graphs, compiled in less CPU time
O0 = {"xla_backend_optimization_level": 0,
      "xla_llvm_disable_expensive_passes": True}
ONE_LEVEL = dict(channel_mults=(1,), attn_resolutions=(16,))
TINY = dict(name="tiny", num_classes=4, image_size=16, samples_per_class=2)
SPEC = ExperimentSpec(
    name="tiny", model="ddpm-unet-smoke", seed=3,
    fl=FLConfig(num_clients=4, num_edges=2, cloud_agg_every=2, rounds=3,
                sparse_rounds=2, sh_a=1000.0, lambda0=1e-3),
    data=DataSpec(dataset="tiny", classes_per_client=2, batch_size=2))
# the vectorized engine's peak for one sparse step of full-width
# CIFAR10_UNET in fp32 at batch 32 by client count, measured on an H100
# 80GB HBM3 at 700 W (chip_smoke.py's engine_memory line)
MEASURED_PEAK = {4: 26.61e9, 8: 52.85e9, 10: 66.00e9, 12: 79.18e9}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_numpy_init(monkeypatch):
    """The reference's ``model.init`` as numpy draws of its shapes."""
    def init(key, cfg):
        shapes = jax.eval_shape(lambda k: jinit_unet(k, cfg), key)
        r = np.random.default_rng(8)
        return jax.tree.map(lambda s: jnp.asarray(
            r.standard_normal(s.shape).astype(np.float32)), shapes)
    monkeypatch.setattr(jmodel, "init", init)


@pytest.fixture(autouse=True, scope="module")
def _tiny_dataset():
    """The 16-image dataset, registered in both packages."""
    exp_data.register_dataset("tiny", DatasetSpec(**TINY), overwrite=True)
    jexp_data.register_dataset("tiny", JDatasetSpec(**TINY), overwrite=True)
    yield
    del exp_data.DATASETS["tiny"], jexp_data.DATASETS["tiny"]


def _eval(params, cfg, r):
    """A cheap eval hook that reads every parameter."""
    return {"sq": float(sum(float(torch.sum(p.double() ** 2))
                            for p in tree_leaves(params))), "round": r}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(_np_tree(a)), tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(x, y.detach().cpu().numpy()) for x, y in zip(la, lb))


def _history(records):
    """Round dicts, the fault field (``availability``) included."""
    return [r.to_dict() for r in records]


# ---------------------------------------------------------------------------
# (a) the spec, the registry and the refusals
# ---------------------------------------------------------------------------

def test_spec_and_presets_match_reference():
    """Defaults and both presets key for key; a reference spec.json with
    every nested spec set loads in the port and is written back
    identical."""
    assert ExperimentSpec().to_dict() == JSpec().to_dict()
    assert runner.PRESETS.keys() == jrunner.PRESETS.keys()
    for name, spec in runner.PRESETS.items():
        assert spec.to_dict() == jrunner.PRESETS[name].to_dict()
    jdict = JSpec().to_dict()
    jdict.update(name="x", method="fedphd-os", engine="sequential",
                 precision="bf16", mesh={"data": 2}, eval_every=3, seed=9,
                 fault={**jdict["fault"], "dropout": 0.25},
                 comm={"quant": "int8"}, obs={**jdict["obs"],
                                               "enabled": True})
    jdict["fl"] = {**jdict["fl"], "moon_tau": 0.25, "seed": 4}
    jjson = JSpec.from_dict(jdict).to_json()
    assert ExperimentSpec.from_json(jjson).to_json() == jjson


def test_registry_and_refusals(monkeypatch, tmp_path):
    """The reference's methods are all registered (fedphd, fedphd-os, the
    five flat baselines and the two staleness variants); faults, the
    quantized uplink and obs tracing are accepted, and a mesh that is
    not a DeviceMesh raises, naming the function that builds one."""
    assert registered_methods() == ["fedavg", "fedavg-stale", "feddiffuse",
                                    "fedphd", "fedphd-os", "fedphd-stale",
                                    "fedprox", "moon", "scaffold"]
    # other tests may register more methods in the reference
    assert set(registered_methods()) <= set(jregistry.registered_methods())
    assert method_entry("fedphd-os").topology == "hierarchical"
    assert method_entry("scaffold").topology == "flat"
    with pytest.raises(KeyError, match="unknown method"):
        method_entry("nope")
    clients, _, _ = exp_data.make_clients(SPEC)
    for kw in (dict(fault=FaultSpec(dropout=0.5)), dict(quant="int8")):
        FedPhD(SMOKE_UNET, SPEC.fl, clients, device="cpu", **kw)
    # a mesh is a DeviceMesh: the spec's {axis: size} goes through
    # make_spec_mesh (tests/test_torch_mesh.py)
    with pytest.raises(TypeError, match="make_spec_mesh"):
        FedPhD(SMOKE_UNET, SPEC.fl, clients, device="cpu", mesh={"data": 2})
    # a disabled fault spec is the fault-free path
    assert FedPhD(SMOKE_UNET, SPEC.fl, clients, device="cpu",
                  fault=FaultSpec())._faults is None
    # obs tracing: an enabled ObsSpec binds the tracer, and so does
    # $FEDPHD_OBS through the experiment API
    tracer = Tracer(str(tmp_path / "t.jsonl"))
    tr = make_trainer(SPEC.replace(obs=ObsSpec(enabled=True)), SMOKE_UNET,
                      clients, tracer=tracer, device="cpu")
    assert tr._obs is tracer and tr._obs_compile is not None
    tracer.close()
    monkeypatch.setenv("FEDPHD_OBS", "1")
    exp = Experiment(SPEC, clients=clients, device="cpu",
                     trace_path=str(tmp_path / "env.jsonl"))
    assert exp.tracer.enabled and exp.trainer._obs is exp.tracer
    exp.tracer.close()
    monkeypatch.delenv("FEDPHD_OBS")
    # --sweep and --k8s-fake parse and run a grid (none of its runs
    # here: --max-runs 0), and refuse as the reference's runner does
    grid = tmp_path / "grid.json"
    grid.write_text(SweepSpec(name="tiny", base=SPEC).to_json())
    for argv, refusal in (
            (["--sweep", str(grid), "--max-runs", "0"], None),
            (["--sweep", str(grid), "--executor", "k8s", "--k8s-fake",
              "--max-runs", "0"], None),
            (["--sweep", str(grid), "--k8s-fake"], "--executor k8s"),
            (["--k8s-fake"], "require --sweep")):
        argv = argv + ["--out", str(tmp_path / "sweep"), "--device", "cpu"]
        if refusal is None:
            res = runner.main(argv)
            assert list(res.manifest["runs"]) == ["base"]
            assert not res.complete
        else:
            with pytest.raises(SystemExit, match=refusal):
                runner.main(argv)
    # --trace is parsed and turns on the spec's obs (the traced run
    # itself is tests/test_torch_obs.py's)
    args = runner.build_parser().parse_args(["--trace"])
    assert runner._apply_overrides(SPEC, args).obs == ObsSpec(enabled=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Experiment(SPEC)


# ---------------------------------------------------------------------------
# (b) kill and resume inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Rounds 1 (sparse), 2 (plain, pruned at its cloud aggregation) and,
    on the vectorized engine, 3 (compacted) unbroken, and the same run
    killed after every round but the last and resumed from its
    checkpoint each time.  The vectorized run keeps persistent
    per-client Adam rows.  Engine -> (unbroken, resumed, the round-1
    checkpoint)."""
    out = {}
    for eng in ("vectorized", "sequential"):
        tmp = tmp_path_factory.mktemp(eng)
        spec = SPEC.replace(engine=eng, persistent_opt=eng == "vectorized",
                            eval_every=1)
        rounds = 3 if eng == "vectorized" else 2
        whole = run_spec(spec, rounds=rounds, eval_fn=_eval, device="cpu")
        ck = str(tmp / "ckpt.npz")
        run_spec(spec, rounds=1, ckpt=ck, eval_fn=_eval, device="cpu")
        ck1 = str(tmp / "round1.npz")
        for suffix in ("", ".manifest.json"):
            shutil.copy(ck + suffix, ck1 + suffix)
        for r in range(2, rounds + 1):
            back = run_spec(None, resume=True, rounds=r, ckpt=ck,
                            eval_fn=_eval, device="cpu")
        out[eng] = whole, back, ck1
    return out


@pytest.mark.parametrize("eng", ["vectorized", "sequential"])
def test_resume_is_bitwise(resumed, eng):
    """The resumed run's history (losses, bytes, selections, evals) and
    params equal the unbroken run's, bit for bit."""
    whole, back, _ = resumed[eng]
    assert [h.pruned for h in whole.history] == [False, True, False][
        :len(whole.history)]
    assert [h.to_dict() for h in back.history] == \
        [h.to_dict() for h in whole.history]
    assert [r for r, _ in whole.trainer.run(len(whole.history)).evals] \
        == [h.round for h in whole.history]
    for a, b in zip(tree_leaves(whole.params), tree_leaves(back.params),
                    strict=True):
        assert torch.equal(a, b)
    assert torch.equal(whole.trainer.gen.get_state(),
                       back.trainer.gen.get_state())
    if eng == "vectorized":
        for a, b in zip(tree_leaves(whole.trainer._opt_stack),
                        tree_leaves(back.trainer._opt_stack)):
            assert torch.equal(a, b)


def test_port_checkpoint_loads_in_reference(resumed, jax_numpy_init):
    """The reference's ``Experiment.load`` restores the port's round-1
    checkpoint (the sequential run's): its key is ``PRNGKey(seed)``, and
    the params, history, host streams and edge statistics are the
    port's."""
    arrays, meta = checkpoint.load(resumed["sequential"][2])
    jexp = jrun.Experiment.load(resumed["sequential"][2])
    tr = jexp.trainer
    assert np.array_equal(np.asarray(tr.rng),
                          np.asarray(jax.random.PRNGKey(SPEC.seed)))
    for seed in (2 ** 31 + 3, 2 ** 40 + 5):
        assert np.array_equal(prng_key(seed),
                              np.asarray(jax.random.PRNGKey(seed)))
    la = jax.tree.leaves(_np_tree(tr.params))
    lb = jax.tree.leaves(arrays["params"])
    assert all(np.array_equal(x, y) for x, y in zip(la, lb, strict=True))
    assert _history(tr.history) == meta["history"]
    assert tr.np_rng.bit_generator.state == meta["np_rng"]
    assert [c.data.rng_state() for c in tr.clients] == meta["client_rngs"]
    assert np.array_equal(np.stack([e.counts for e in tr.edges]),
                          arrays["edge_counts"])
    assert [e.n for e in tr.edges] == arrays["edge_n"].tolist()
    assert set(tr._edge_models) == {0, 1}


def test_reference_checkpoint_loads_in_port(monkeypatch, tmp_path,
                                            jax_numpy_init):
    """A reference trainer state after one round loads in the port: the
    params bitwise after convert, the config, history, selection and
    shuffle streams and edge statistics; the port's next round then
    selects the reference's clients and moves its bytes, which depend
    only on those host streams."""
    def drain(step_fn, params, client, *, epochs, opt_state=None, **_):
        for _ in range(epochs):
            for _ in client.data.epoch():
                pass
        return params, opt_state, 0.0

    monkeypatch.setattr(jhfl, "run_local", drain)
    monkeypatch.setattr(jhfl, "aggregate_sh", lambda models, *_: models[0])
    jspec = JSpec.from_dict(SPEC.replace(
        engine="sequential", fl=dataclasses.replace(
            SPEC.fl, sparse_rounds=5)).to_dict())
    jexp = jrun.Experiment(jspec)
    jexp.run(1)
    path = str(tmp_path / "ckpt.npz")
    jexp.save(path)
    jparams = _np_tree(jexp.params)
    jexp.run(2)
    with pytest.warns(RuntimeWarning, match="generator"):
        exp = Experiment.load(path, device="cpu")
    tr, jtr = exp.trainer, jexp.trainer
    assert _leaves_equal(jparams, tr.params)
    arrays, meta = checkpoint.load(path)
    assert json.loads(json.dumps(config_to_dict(tr.cfg))) == meta["cfg"]
    assert _history(tr.history) == _history(jtr.history[:1])
    assert tr.np_rng.bit_generator.state == meta["np_rng"]
    assert [c.data.rng_state() for c in tr.clients] == meta["client_rngs"]
    assert [e.n for e in tr.edges] == arrays["edge_n"].tolist()
    assert np.array_equal(np.stack([e.counts for e in tr.edges]),
                          arrays["edge_counts"])
    exp.run(2)
    got, want = tr.history[1], jtr.history[1]
    assert (got.selected, got.comm_gb, got.comm_up_gb, got.comm_down_gb,
            got.params_m) == (want.selected, want.comm_gb, want.comm_up_gb,
                              want.comm_down_gb, want.params_m)
    assert np.isfinite(got.loss)


def test_restore_refuses_another_generator_device(resumed):
    arrays, meta = checkpoint.load(resumed["sequential"][2])
    exp = Experiment(ExperimentSpec.from_dict(meta["spec"]), device="cpu")
    with pytest.raises(RuntimeError, match="'cuda'.*'cpu'"):
        exp.trainer.restore(arrays, {**meta, "torch_rng_device": "cuda"})


# ---------------------------------------------------------------------------
# (c) the engine in client chunks
# ---------------------------------------------------------------------------

def _one_round(max_clients, eval_fn=None):
    """One sparse round of SPEC's 4 clients on the vectorized engine,
    aggregated to the cloud, chunked at ``max_clients`` (None: all 4);
    returns the trainer and the chunks each engine call cut."""
    spec = SPEC.replace(engine="vectorized", eval_every=1,
                        fl=dataclasses.replace(SPEC.fl, cloud_agg_every=1))
    chunks, real = [], engine.chunk_bounds

    def bounds(C, k):
        chunks.append(real(C, k))
        return chunks[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hfl, "make_round_engine", functools.partial(
            engine.make_round_engine, max_clients=max_clients))
        mp.setattr(engine, "chunk_bounds", bounds)
        exp = Experiment(spec, eval_fn=eval_fn, device="cpu")
        exp.run(1)
    return exp.trainer, chunks


def test_chunked_round_matches_one_chunk():
    """Chunks of 1, 2 and 3 clients against all 4 at once: the aggregated
    model and the loss within 1e-6 relative, the generator's state after
    the round identical (the draws come before training), and chunks as
    even as they go.  The unchunked run also samples for its eval; the
    sampler's own generator leaves the trainer's untouched."""
    def sample_eval(params, cfg, r):
        return {"is_proxy": fid.inception_score_proxy(
            sample_images(params, cfg, n=4, steps=1, seed=0))}

    base, chunks = _one_round(None, sample_eval)
    assert chunks == [[(0, 4)]]
    assert base.history[0].eval["is_proxy"] > 0
    for k, want in ((1, [(0, 1), (1, 2), (2, 3), (3, 4)]),
                    (2, [(0, 2), (2, 4)]), (3, [(0, 2), (2, 4)])):
        tr, chunks = _one_round(k)
        assert chunks == [want]
        assert torch.equal(tr.gen.get_state(), base.gen.get_state())
        a, b = tr.history[0], base.history[0]
        assert a.selected == b.selected and a.comm_gb == b.comm_gb
        assert abs(a.loss - b.loss) <= 1e-6 * abs(b.loss)
        for x, y in zip(tree_leaves(tr.params), tree_leaves(base.params),
                        strict=True):
            assert float((x - y).abs().max()) \
                <= 1e-6 * float(y.abs().max())


def test_client_chunk_arithmetic():
    """Deterministic, balanced, at most 12 of the paper's 20 clients on
    an 80 GB H100 (85.0e9 bytes), never below the measured peaks, and a
    refusal with the numbers when one client does not fit."""
    shape = (20, 8, 32, 32, 32, 3)                # the paper preset's round
    k = engine.client_chunk(CIFAR10_UNET, shape, 85.0e9, edges=2)
    assert k == engine.client_chunk(CIFAR10_UNET, shape, 85.0e9, edges=2)
    assert 1 <= k <= 12 and 20 % k == 0
    assert engine.round_bytes(CIFAR10_UNET, shape, k, edges=2) \
        <= engine.USABLE_SHARE * 85.0e9
    assert engine.unet_elems(CIFAR10_UNET)[0] == 35_746_307
    for C, peak in MEASURED_PEAK.items():
        assert engine.round_bytes(CIFAR10_UNET, (C, 1, 32, 32, 32, 3), C,
                                  edges=1) >= peak
    for C in (1, 5, 7, 20, 23):
        for kmax in range(1, C + 1):
            sizes = [b - a for a, b in engine.chunk_bounds(C, kmax)]
            assert sum(sizes) == C and max(sizes) - min(sizes) <= 1
            assert max(sizes) <= kmax and len(sizes) == -(-C // kmax)
    assert engine.client_chunk(SMOKE_UNET, (6, 1, 32, 16, 16, 3),
                               85.0e9) == 6
    with pytest.raises(MemoryError, match="1,000,000,000"):
        engine.client_chunk(CIFAR10_UNET, shape, 1e9, edges=2)


# ---------------------------------------------------------------------------
# (d) the eval: proxy metrics and sampling
# ---------------------------------------------------------------------------

def test_proxy_metrics_match_reference(monkeypatch):
    """The committed feature weights are the reference's draw, bit for
    bit; features within 1e-5 of their largest value (32 x 32 images:
    XLA's SAME padding at stride 2 is one pixel, after); IS and FID
    proxies within 1e-5 relative.  The reference's feature CNN runs as
    one jitted program (its weights drawn first, outside the trace)."""
    want = jfid._feature_params(3)
    got = fid._feature_params(3)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], np.asarray(want[k]))
    with pytest.raises(ValueError, match="export_fid_features"):
        fid._feature_params(1)
    monkeypatch.setattr(jfid, "_features", jax.jit(jfid._features,
                                                   compiler_options=O0))
    r = np.random.default_rng(4)
    real = np.tanh(r.standard_normal((24, 32, 32, 3))).astype(np.float32)
    fake = np.tanh(0.6 * r.standard_normal((24, 32, 32, 3)) + 0.3) \
        .astype(np.float32)
    w = jfid.features(real)
    assert np.abs(fid.features(real) - w).max() <= 1e-5 * np.abs(w).max()
    for f, args in ((fid.inception_score_proxy, (fake,)),
                    (fid.fid_proxy, (real, fake))):
        ref = getattr(jfid, f.__name__)(*args)
        assert abs(f(*args) - ref) <= 1e-5 * abs(ref)


def test_sample_images_matches_reference():
    """``sample_images`` against the reference's ``ddim_sample`` on the
    same x_T (the port's seeded prior, injected) and params, within
    1e-4; a second call with the seed gives the same images."""
    jcfg = JAX_SMOKE.replace(backend="xla", precision="fp32", **ONE_LEVEL)
    cfg = SMOKE_UNET.replace(precision="fp32", **ONE_LEVEL)
    shapes = jax.eval_shape(lambda k: jinit_unet(k, jcfg),
                            jax.random.PRNGKey(0))
    r = np.random.default_rng(5)
    nparams = jax.tree.map(
        lambda s: (r.standard_normal(s.shape) / np.sqrt(
            max(1, np.prod(s.shape[:-1])))).astype(np.float32), shapes)
    params = params_from_jax(nparams, CPU)
    n, steps, seed = 2, 2, 7
    got = sample_images(params, cfg, n=n, steps=steps, seed=seed)
    gen = torch.Generator(CPU)
    gen.manual_seed(seed)
    xt = torch.randn((n, 16, 16, 3), generator=gen).numpy()
    jp = jax.tree.map(jnp.asarray, nparams)
    want = jddim_sample(lambda x, t: japply_unet(jp, jcfg, x, t),
                        jlinear_schedule(jcfg.diffusion_steps),
                        jax.random.PRNGKey(0), xt.shape, num_steps=steps,
                        x_init=jnp.asarray(xt))
    assert got.shape == (n, 16, 16, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert np.array_equal(got, sample_images(params, cfg, n=n, steps=steps,
                                             seed=seed))


# ---------------------------------------------------------------------------
# (e) masks and the cosine schedule
# ---------------------------------------------------------------------------

def test_apply_masks_sparsity_report_cosine_match_reference():
    jcfg = JAX_SMOKE.replace(backend="xla", **ONE_LEVEL)
    cfg = SMOKE_UNET.replace(**ONE_LEVEL)
    shapes = jax.eval_shape(lambda k: jinit_unet(k, jcfg),
                            jax.random.PRNGKey(0))
    r = np.random.default_rng(6)
    nparams = jax.tree.map(lambda s: r.standard_normal(s.shape)
                           .astype(np.float32), shapes)
    params = params_from_jax(nparams, CPU)
    groups = unet_groups(cfg, params)
    masks = make_masks(l2_scores(params, groups), groups, 0.44)
    jp = jax.tree.map(jnp.asarray, nparams)
    jmasks = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    jgroups = jbuild_groups(jcfg, jp)
    assert sparsity_report(groups, masks) == jsparsity_report(jgroups,
                                                              jmasks)
    # one program, not an eager compile per member's op
    zeroed = jax.jit(lambda p, m: japply_masks(p, jgroups, m),
                     compiler_options=O0)(jp, jmasks)
    assert _leaves_equal(zeroed, apply_masks(params, groups, masks))
    assert _leaves_equal(nparams, params)       # the input is unchanged
    # fp32 cos differs by an ulp between the packages, and each beta,
    # 1 - the ratio of two neighbouring alpha_bars, keeps that error in
    # absolute terms (up to 3e-7 measured at T = 1000)
    for T in (10, 1000):
        want, got = jcosine_schedule(T), cosine_schedule(T, device=CPU)
        for f in ("betas", "alphas", "alpha_bars"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (f) the runner CLI
# ---------------------------------------------------------------------------

def test_runner_runs_resumes_and_serves(monkeypatch, tmp_path):
    """One round, then ``--resume`` to round 2 with the default eval hook
    (its sampler cut to 4 images in 2 steps): the outputs the reference
    writes, an ``is_proxy`` eval at round 2, the metrics file, and the
    checkpoint loads as a serving artifact."""
    import repro_torch.diffusion as diffusion
    real = diffusion.sample_images
    monkeypatch.setattr(diffusion, "sample_images",
                        functools.partial(lambda *a, _f=real, **kw: _f(
                            *a, **{**kw, "n": 4, "steps": 2})))
    spec_path = tmp_path / "spec.in.json"
    spec_path.write_text(SPEC.replace(eval_every=2).to_json())
    out = str(tmp_path / "run")
    runner.main(["--spec", str(spec_path), "--rounds", "1", "--out", out,
                 "--device", "cpu"])
    exp = runner.main(["--out", out, "--resume", "--rounds", "2",
                       "--device", "cpu", "--metrics",
                       str(tmp_path / "m.json")])
    assert sorted(os.listdir(out)) == ["ckpt.npz", "ckpt.npz.manifest.json",
                                       "history.json", "spec.json"]
    with open(os.path.join(out, "history.json")) as f:
        hist = json.load(f)["history"]
    assert [h["round"] for h in hist] == [1, 2]
    assert hist[0]["eval"] is None and hist[1]["eval"]["is_proxy"] > 0
    with open(os.path.join(out, "spec.json")) as f:
        assert ExperimentSpec.from_json(f.read()) == SPEC.replace(
            eval_every=2)
    with open(tmp_path / "m.json") as f:
        assert json.load(f)["rounds"] == 2
    params, cfg, meta = load_serving_artifact(os.path.join(out, "ckpt.npz"),
                                              device="cpu")
    assert meta["trainer"] == "fedphd" and cfg.name == "ddpm-unet-smoke"
    for a, b in zip(tree_leaves(params), tree_leaves(exp.params),
                    strict=True):
        assert torch.equal(a, b)
