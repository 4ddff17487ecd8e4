"""FedPhD's hierarchy on a device mesh in the port: ``launch/mesh.py``,
``launch/federated.py``, the mesh-sharded round engine behind
``FedPhD(mesh=)``, ``FlatTrainer(mesh=)`` and ``ExperimentSpec.mesh``,
and the layout rules of ``launch/sharding.py``.

The port runs one process a device.  Every multi-rank check runs in one
spawn a module: 4 gloo ranks on the CPU (one intra-op thread each),
started with the module's first test, run while the in-process tests
(first in the file) do; each writes its results to a file, which the
``ranks`` fixture reads once they are done.  The
sharded runs are held against the port's unsharded runs of the same
spec, which the other port tests hold against the reference; those
unsharded runs are spread over the ranks, one a rank, beside the
sharded ones; and the sharded FedPhD run's host record (selections, SH
scores, bytes, sizes, the prune) against the reference's unsharded run
of the same spec, whose training is drained (it cannot draw torch's t
and eps).  ``hierarchical_aggregate`` is held against the
reference's ``sh_weights`` composed per pod and across pods, and the
sharding specs against the reference's rules leaf for leaf on abstract
full-size trees (``jax.eval_shape``; the ``meta`` device).  This module
imports JAX and the reference only inside the tests that read them, so
the spawned ranks import neither.

In-process checks destroy any process group they start: later files can
run in the same worker.
"""
import dataclasses
import datetime
import math
import os
import pickle
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
RANK_TIMEOUT = 300             # seconds: the ranks take ~7
TOL = 1e-5                     # losses and params, sharded vs unsharded
LR = 2e-4
TINY_MODEL = "ddpm-unet-mesh-tiny"
TINY_DATA = "mesh-tiny"
# a one-level U-Net with its attention at 8 x 8
TINY = dict(image_size=8, base_channels=8, channel_mults=(1,),
            num_res_blocks=1, attn_resolutions=(8,))
# hierarchical_aggregate: (pod, data) = (2, 2), one client a rank; with
# b = -40 the third client's weight relu(8 + 1000 * 0.002 - 40) is 0
AGG = dict(a=1000.0, b=-40.0, n=(8.0, 16.0, 8.0, 12.0),
           mu=(0.05, 0.03, 0.002, 0.04))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the ranks: everything that needs a world of several processes
# ---------------------------------------------------------------------------

def _register():
    from repro_torch.configs import SMOKE_UNET, register_config
    from repro_torch.data.synthetic import DatasetSpec
    from repro_torch.experiment.data import register_dataset
    register_config(TINY_MODEL, SMOKE_UNET.replace(name=TINY_MODEL, **TINY),
                    overwrite=True)
    register_dataset(TINY_DATA, DatasetSpec(TINY_DATA, num_classes=4,
                                            image_size=8,
                                            samples_per_class=4),
                     overwrite=True)


def _spec(**kw):
    from repro_torch.configs import FLConfig
    from repro_torch.experiment import DataSpec, ExperimentSpec
    fl = dict(num_clients=4, num_edges=2, participation=1.0, rounds=3,
              sparse_rounds=2, cloud_agg_every=2, edge_agg_every=1,
              sh_a=1000.0, lambda0=1e-3)
    fl.update(kw.pop("fl", {}))
    return ExperimentSpec(
        name="mesh", model=TINY_MODEL, seed=3, engine="vectorized", lr=LR,
        fl=FLConfig(**fl), data=DataSpec(dataset=TINY_DATA,
                                         classes_per_client=2, batch_size=2),
        **kw)


# the stragglers' half of the population runs at half speed: with the
# deadline at 1 they miss it in every round, and under staleness report
# a round late
STRAGGLERS = dict(straggler_frac=0.5, slowdown=2.0, deadline=1.0, seed=1)
# name -> the collectives a round: (all-reduces, all-gathers)
PER_ROUND = {"fedphd": (1, 1), "moon": (1, 2), "int8": (1, 2),
             "scaffold": (2, 2), "persistent": (1, 2), "stale": (2, 1),
             "ragged": (0, 0)}


# name -> (spec, how the mesh is built: "spec" = spec.mesh, "host2" =
# make_host_mesh(2), i.e. (data, model) = (2, 2))
def _cases():
    from repro_torch.fl.compress import CommSpec
    from repro_torch.fl.faults import FaultSpec
    return {
        # through the prune at R_s = 2, the clients over data = 4
        "fedphd": (_spec(mesh={"data": 4, "model": 1}), "spec"),
        # MOON keeps every trained row (gathered), data = 2 of (2, 2)
        "moon": (_spec(method="moon", fl=dict(rounds=2)), "host2"),
        # the int8 uplink's error-feedback rows (gathered)
        "int8": (_spec(prune=False, fl=dict(rounds=2),
                       comm=CommSpec("int8"), mesh={"data": 4}), "spec"),
        # SCAFFOLD's mean control change (reduced) and c_i+ rows
        # (gathered), data = 2 of (2, 2); with this seed a client drops
        # in each round, so the mean is over the completed ones
        "scaffold": (_spec(method="scaffold", fl=dict(rounds=2),
                           fault=FaultSpec(dropout=0.25, seed=8)), "host2"),
        # FedPhD's persistent Adam rows (gathered), data = 2 of (2, 2)
        "persistent": (_spec(persistent_opt=True, prune=False,
                             fl=dict(rounds=2),
                             mesh={"data": 2, "model": 2}), "spec"),
        # the stragglers' late deltas (reduced) under staleness
        "stale": (_spec(method="fedphd-stale", prune=False,
                        fl=dict(rounds=2), fault=FaultSpec(**STRAGGLERS),
                        mesh={"data": 4}), "spec"),
        # 3 participants do not divide data = 4: unsharded, one warning
        "ragged": (_spec(prune=False, fl=dict(rounds=2, participation=0.75),
                         mesh={"data": 4}), "spec"),
    }


def _run(spec, mesh_kind, sharded):
    """One run on the CPU: its history, final params (numpy) and, for a
    sharded run, the trainer's mesh and the UNSHARDED warnings."""
    from repro_torch.experiment import make_clients, run_spec
    from repro_torch.fl.baselines import FlatTrainer
    from repro_torch.launch import federated
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_leaves

    if not sharded:
        spec = spec.replace(mesh=None)
    federated._WARNED_INDIVISIBLE = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if mesh_kind == "host2":
            clients, _, _ = make_clients(spec)
            tr = FlatTrainer(spec.method, get_config(spec.model), spec.fl,
                             clients, lr=spec.lr, rng_seed=spec.seed,
                             engine=spec.engine, device="cpu",
                             fault=spec.fault,
                             mesh=make_host_mesh(2, device="cpu")
                             if sharded else None)
            tr.run()
        else:
            tr = run_spec(spec, device="cpu").trainer
    return {"history": [r.to_dict() for r in tr.history],
            "params": [x.detach().numpy().copy()
                       for x in tree_leaves(tr.params)],
            "mesh": type(tr.mesh).__name__ if tr.mesh is not None else None,
            "mesh_axes": None if tr.mesh is None else
            tuple(tr.mesh.mesh_dim_names),
            "unsharded_warnings": sum("UNSHARDED" in str(w.message)
                                      for w in caught)}


def _aggregate(rank):
    """hierarchical_aggregate on (pod, data) = (2, 2), one client a rank:
    this rank's client model from a numpy seed, an int32 leaf among the
    float ones."""
    from repro_torch.launch.federated import hierarchical_aggregate
    from repro_torch.launch.mesh import make_spec_mesh
    mesh = make_spec_mesh({"pod": 2, "data": 2}, device="cpu")
    r = np.random.default_rng(100 + rank)
    params = {"w": torch.from_numpy(r.standard_normal((3, 5))
                                    .astype(np.float32)),
              "b": [torch.from_numpy(r.standard_normal(7)
                                     .astype(np.float32))],
              "step": torch.tensor(10 * (rank + 1), dtype=torch.int32)}
    kw = dict(mesh=mesh, a=AGG["a"], b=AGG["b"])
    out = {"params": _np_tree(params)}
    for cloud in (False, True):
        agg = hierarchical_aggregate(params, AGG["n"][rank], AGG["mu"][rank],
                                     cloud_round=cloud, **kw)
        out["cloud" if cloud else "edge"] = _np_tree(agg)
        out["step_dtype"] = str(agg["step"].dtype)
    return out


def _np_tree(tree):
    return {"w": tree["w"].numpy().copy(), "b": tree["b"][0].numpy().copy(),
            "step": tree["step"].numpy().copy()}


def _shard_warning():
    """shard_clients on a (6, 3) leaf, an (8, 2) leaf and a scalar over
    data = 4: one UNSHARDED warning, then none on a second call; the
    dividing leaf cut to this rank's rows."""
    from repro_torch.launch import federated
    from repro_torch.launch.mesh import make_spec_mesh
    mesh = make_spec_mesh({"data": 4}, device="cpu")
    federated._WARNED_INDIVISIBLE = False
    tree = {"bad": torch.zeros((6, 3)), "ok": torch.arange(16.).reshape(8, 2),
            "scalar": torch.tensor(1.0), "host": np.arange(8)}
    counts = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = federated.shard_clients(tree, mesh, "data")
        counts.append(sum("UNSHARDED" in str(w.message) for w in caught))
    return {"counts": counts, "ok": out["ok"].numpy().copy(),
            "bad_shape": tuple(out["bad"].shape),
            "host": out["host"].copy(),
            "view": out["ok"].untyped_storage().data_ptr()
            == tree["ok"].untyped_storage().data_ptr()
            and np.shares_memory(out["host"], tree["host"])}


def _no_client_axis():
    """A trainer refuses a mesh without the "data" axis, which would
    leave every rank training every client."""
    from repro_torch.experiment import run_spec
    spec = _cases()["fedphd"][0].replace(mesh={"pod": 2, "model": 2})
    try:
        run_spec(spec, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    # a collective that cannot complete fails after RANK_TIMEOUT
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        from repro_torch.launch import federated
        from repro_torch.launch.mesh import make_spec_mesh
        _register()
        cases = _cases()
        res = {"unsharded": {}, "sharded": {}}
        # the unsharded references, spread over the ranks
        for name in list(cases)[rank::world]:
            res["unsharded"][name] = _run(*cases[name], sharded=False)
        res["shard_warning"] = _shard_warning()
        res["aggregate"] = _aggregate(rank)
        with pytest.raises(ValueError, match="nothing to do"):
            make_spec_mesh({"data": 2}, device="cpu")
        res["no_client_axis"] = _no_client_axis()
        federated.reset_collectives()
        for name, (spec, kind) in cases.items():
            res["sharded"][name] = _run(spec, kind, sharded=True)
            res["sharded"][name]["collectives"] = dict(federated.COLLECTIVES)
            federated.reset_collectives()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True, scope="module")
def _spawned(tmp_path_factory):
    """The ranks, started with the module's first test so that they run
    while the in-process tests (first in this file) do; joined by
    :func:`ranks`, or here at the end."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    ctx = mp.start_processes(_rank_main, args=(WORLD, tmp), nprocs=WORLD,
                             join=False, start_method="spawn")
    yield ctx, tmp
    for p in ctx.processes:
        p.join(timeout=RANK_TIMEOUT)
        if p.is_alive():
            p.terminate()


@pytest.fixture(scope="module")
def ranks(_spawned):
    ctx, tmp = _spawned
    deadline = time.monotonic() + RANK_TIMEOUT
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            pytest.fail(f"the ranks did not end in {RANK_TIMEOUT} s")
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _unsharded(ranks, name):
    return next(r["unsharded"][name] for r in ranks
                if name in r["unsharded"])


# ---------------------------------------------------------------------------
# mesh construction on a world of one, in this process
# ---------------------------------------------------------------------------

def test_mesh_construction_and_validation():
    """The reference's guard rails (``tests/test_mesh_engine.py``) on a
    world of one gloo rank, the ``torchrun`` hint in place of
    ``env.apply``; the production meshes refuse a world of one with both
    counts; a CUDA mesh without a card raises and starts no group."""
    from repro_torch.launch import make_host_mesh, make_production_mesh
    from repro_torch.launch.mesh import (destroy_world, make_spec_mesh,
                                         mesh_axis_sizes)
    assert not dist.is_initialized()
    try:
        assert make_spec_mesh(None) is None and make_spec_mesh({}) is None
        with pytest.raises(ValueError, match="sizes must be >= 1"):
            make_spec_mesh({"data": 0}, device="cpu")
        assert not dist.is_initialized()       # validated before a world
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(0, device="cpu")
        mesh = make_host_mesh(1, device="cpu")
        assert mesh_axis_sizes(mesh) == {"data": 1, "model": 1}
        with pytest.raises(ValueError,
                           match="torchrun --nproc-per-node 1024"):
            make_spec_mesh({"data": 1024}, device="cpu")
        mesh = make_spec_mesh({"data": 1}, device="cpu")
        assert mesh.mesh_dim_names == ("data",)
        mesh = make_spec_mesh({"pod": 1, "data": 1, "model": 1},
                              device="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        for multi, need in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {need} ranks but "
                                                 f"the world has 1"):
                make_production_mesh(multi_pod=multi, device="cpu")
        # a gloo world cannot serve a CUDA mesh, nor a missing card
        with pytest.raises(RuntimeError):
            make_spec_mesh({"data": 1}, device="cuda")
    finally:
        destroy_world()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda"):
            make_host_mesh(device="cuda")
        assert not dist.is_initialized()


def test_round_cost_and_placements():
    """``federated_round_cost`` keeps the reference's bytes and keys, the
    seconds from the H100's rates; ``placements`` maps a spec to DTensor
    placements on a live mesh."""
    from torch.distributed.tensor import Replicate, Shard

    from repro.launch.federated import federated_round_cost as jcost
    from repro_torch.launch.federated import federated_round_cost
    from repro_torch.launch.mesh import (destroy_world, make_host_mesh,
                                         make_spec_mesh)
    from repro_torch.launch.sharding import placements
    from repro_torch.roofline import hw
    for cloud in (False, True):
        got = federated_round_cost(143e6, cloud_round=cloud)
        want = jcost(143e6, cloud_round=cloud)
        assert set(got) == set(want)
        assert (got["ici_bytes"], got["dcn_bytes"]) == \
            (want["ici_bytes"], want["dcn_bytes"])
        assert got["ici_s"] == got["ici_bytes"] / hw.NVLINK_BW
        assert got["dcn_s"] == got["dcn_bytes"] / hw.NET_BW
    try:
        mesh = make_host_mesh(device="cpu")
        assert placements((None, "model"), mesh) == [Replicate(), Shard(1)]
        assert placements((("data", "model"), None), mesh) == \
            [Shard(0), Shard(0)]
        assert placements((), mesh) == [Replicate(), Replicate()]
        # ZeRO-1's ("data", "pod") is data-major; DTensor nests a dim's
        # shards pod-major on a (pod, data, model) mesh: refused
        mesh = make_spec_mesh({"pod": 1, "data": 1, "model": 1},
                              device="cpu")
        assert placements((("pod", "data"), "model"), mesh) == \
            [Shard(0), Shard(0), Shard(1)]
        with pytest.raises(ValueError, match="major in 'data'"):
            placements((("data", "pod"), None), mesh)
        with pytest.raises(ValueError, match="lacks"):
            placements((None, "expert"), mesh)
    finally:
        destroy_world()


# ---------------------------------------------------------------------------
# the sharding rules against the reference's
# ---------------------------------------------------------------------------

AXES = {"prod": {"data": 16, "model": 16},
        "multipod": {"pod": 2, "data": 16, "model": 16},
        "small": {"data": 2, "model": 4}}


class _Mesh:
    """What the reference's rules read of a mesh: its axis names and
    device-array shape."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(tuple(axes.values()), dtype=np.int8)


def _paths(tree, specs, prefix=""):
    """{reference key path: spec}, walking a port tree and its spec tree
    side by side (a spec is a tuple, so the specs cannot lead)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(k, v, specs[k]) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(i, v, s) for i, (v, s) in enumerate(zip(tree, specs))]
    else:
        return {prefix[:-1]: specs}
    out = {}
    for k, v, s in items:
        out.update(_paths(v, s, f"{prefix}{k}/"))
    return out


def _ref_paths(tree):
    import jax
    from jax.sharding import PartitionSpec

    from repro.launch.sharding import _path_str
    return {_path_str(kp): tuple(leaf) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


@pytest.fixture(scope="module")
def trees():
    """Every arch's full-size parameter tree, in both packages, abstract;
    and the decode caches at decode_32k and long_500k."""
    import jax

    from repro.configs import adapt_for_shape as jadapt
    from repro.configs import get_config as jget
    from repro.configs import get_shape as jshape
    from repro.configs import list_archs
    from repro.models import model as jmodel
    from repro_torch.configs import adapt_for_shape, get_config, get_shape
    from repro_torch.models import model
    out = {}
    for arch in list_archs():
        jcfg, cfg = jget(arch), get_config(arch)
        jp = jax.eval_shape(lambda k: jmodel.init(k, jcfg),
                            jax.random.PRNGKey(0))
        tp = model.init(cfg, torch.Generator(), device="meta")
        caches = {}
        for shape in ("decode_32k", "long_500k"):
            js, ts = jshape(shape), get_shape(shape)
            jc, tc = jadapt(jcfg, js), adapt_for_shape(cfg, ts)
            caches[shape] = (
                js.global_batch,
                jax.eval_shape(lambda p: jmodel.init_cache(
                    p, jc, js.global_batch, js.seq_len), jp),
                model.init_cache(tp, tc, ts.global_batch, ts.seq_len))
        out[arch] = (jcfg, cfg, jp, tp, caches)
    return out


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's ``NamedSharding`` replaced by its spec, so its
    sharding trees read as trees of PartitionSpecs."""
    import repro.launch.sharding as jsh
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    return jsh


@pytest.mark.parametrize("axes", list(AXES))
def test_sharding_specs_match_reference(trees, ref_specs, axes):
    """``param_specs``, ``opt_state_specs``, ``batch_specs`` and
    ``cache_specs`` equal the reference's for every leaf of all 10
    archs at full size, on the production axis sizes and a small
    ("data", "model") = (2, 4)."""
    import jax

    from repro.configs import sharding_rules as jrules
    from repro.models import model as jmodel
    from repro.optim.adam import AdamState as JAdam
    from repro_torch.configs import INPUT_SHAPES, sharding_rules
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model
    from repro_torch.optim import AdamState
    sizes, mesh = AXES[axes], _Mesh(AXES[axes])
    for arch, (jcfg, cfg, jp, tp, caches) in trees.items():
        rules = sharding_rules(cfg)
        assert dataclasses.asdict(rules) == dataclasses.asdict(jrules(jcfg))
        want = _ref_paths(ref_specs.param_shardings(jp, mesh, jrules(jcfg)))
        got = sh.param_specs(tp, sizes, rules)
        assert _paths(tp, got) == want, arch
        jopt = JAdam(step=0, mu=jp, nu=jp, master=jp)
        jo = ref_specs.opt_state_shardings(jopt, jp, mesh, jrules(jcfg))
        to = sh.opt_state_specs(AdamState(step=None, mu=tp, nu=tp,
                                          master=tp), tp, sizes, rules)
        assert isinstance(to, AdamState) and to.step == ()
        assert tuple(jo.step) == ()
        for part in ("mu", "nu", "master"):
            assert _paths(tp, getattr(to, part)) == \
                _ref_paths(getattr(jo, part)), (arch, part)
        for shape in INPUT_SHAPES.values():
            jb = ref_specs.batch_shardings(
                jmodel.input_specs(jcfg, shape), mesh, jrules(jcfg))
            tb = sh.batch_specs(model.input_specs(cfg, shape), sizes, rules)
            assert {k: tuple(v) for k, v in jb.items()} == tb, \
                (arch, shape.name)
        for shape, (batch, jc, tc) in caches.items():
            want = _ref_paths(ref_specs.cache_shardings(
                jc, mesh, jrules(jcfg), batch))
            assert _paths(tc, sh.cache_specs(tc, sizes, rules, batch)) \
                == want, (arch, shape)
    assert math.prod(sizes.values()) in (256, 512, 8)


# ---------------------------------------------------------------------------
# the sharded trainers against the unsharded ones, and the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_fedphd():
    """The reference's unsharded FedPhD on the "fedphd" case's spec, its
    host streams advanced as in a real round: the tiny model and dataset
    registered in it, its initializer numpy draws, its local training a
    drain of each client's shuffles and its aggregation the first model
    (it cannot draw torch's t and eps, so its losses and params are not
    compared).  Runs in this process while the ranks do."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import hfl as jhfl
    from repro.data.synthetic import DatasetSpec as JDatasetSpec
    from repro.experiment import data as jdata
    from repro.experiment import run as jrun
    from repro.experiment.spec import ExperimentSpec as JSpec
    from repro.models import model as jmodel
    from repro.models.unet import init_unet

    def init(key, cfg):
        shapes = jax.eval_shape(lambda k: init_unet(k, cfg), key)
        r = np.random.default_rng(8)
        return jax.tree.map(lambda x: jnp.asarray(
            r.standard_normal(x.shape).astype(np.float32)), shapes)

    def drain(step_fn, params, client, *, epochs, opt_state=None, **_):
        for _ in range(epochs):
            for _ in client.data.epoch():
                pass
        return params, opt_state, 0.0

    _register()
    spec = _cases()["fedphd"][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfigs.ALL_CONFIGS, TINY_MODEL,
                   jconfigs.SMOKE_UNET.replace(name=TINY_MODEL, **TINY))
        mp.setitem(jdata.DATASETS, TINY_DATA, JDatasetSpec(
            TINY_DATA, num_classes=4, image_size=8, samples_per_class=4))
        mp.setattr(jmodel, "init", init)
        mp.setattr(jhfl, "run_local", drain)
        mp.setattr(jhfl, "aggregate_sh", lambda models, *_: models[0])
        jspec = JSpec.from_dict(spec.replace(
            mesh=None, engine="sequential").to_dict())
        exp = jrun.Experiment(jspec)
        exp.run(spec.fl.rounds)
        return [r.to_dict() for r in exp.trainer.history]


def test_sharded_fedphd_matches_reference_host_record(reference_fedphd,
                                                      ranks):
    """The sharded FedPhD run (data = 4, through the prune) against the
    reference's unsharded run of the same spec, on every rank: the same
    selections, edge SH scores, bytes, model sizes and prune round,
    which the port's host streams must reproduce whatever the mesh."""
    want = reference_fedphd
    assert [h["pruned"] for h in want] == [False, True, False]
    for r in ranks:
        got = r["sharded"]["fedphd"]["history"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for key in ("round", "selected", "edge_sh", "comm_gb",
                        "comm_up_gb", "comm_down_gb", "params_m",
                        "pruned"):
                assert a[key] == b[key], (key, a["round"])


@pytest.mark.parametrize("name", list(PER_ROUND))
def test_sharded_run_matches_unsharded(ranks, name):
    """Each rank's sharded run against the unsharded run of the same
    spec: losses within TOL a round, params within TOL (sums in another
    order, ROADMAP C.8), comm_gb, selections and fault records equal, on
    every rank.  FedPhD goes through its prune; MOON gathers its trained
    rows; the int8 uplink its error-feedback rows; SCAFFOLD, with
    dropped clients, reduces its mean control change and gathers its
    c_i+ rows; persistent Adam gathers its rows; the stragglers' late
    deltas are reduced in every round; 3 participants on data = 4 run
    unsharded after one warning and no collective."""
    want = _unsharded(ranks, name)
    for got in (r["sharded"][name] for r in ranks):
        assert len(got["history"]) == len(want["history"])
        for a, b in zip(got["history"], want["history"]):
            assert abs(a["loss"] - b["loss"]) <= TOL, (a["round"], a, b)
            for key in ("comm_gb", "comm_up_gb", "comm_down_gb", "selected",
                        "params_m", "pruned", "edge_sh", "availability"):
                assert a.get(key) == b.get(key), key
        assert len(got["params"]) == len(want["params"])
        for x, y in zip(got["params"], want["params"]):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, atol=TOL, rtol=0)
        assert got["mesh"] == "DeviceMesh"
        assert got["unsharded_warnings"] == (name == "ragged")
        # a round: agg reduced, with the late deltas and SCAFFOLD's mean
        # change; the losses gathered, with MOON's trained rows, int8's
        # error-feedback rows, SCAFFOLD's c_i+ rows and the Adam rows
        rounds = len(want["history"])
        coll = got["collectives"]
        assert (coll["all_reduce"], coll["all_gather"]) == \
            tuple(k * rounds for k in PER_ROUND[name]), coll
    assert want["mesh"] is None
    avail = [h["availability"] for h in want["history"]]
    if name == "fedphd":
        assert [h["pruned"] for h in want["history"]] == [False, True, False]
    if name == "stale":
        assert all(len(a["late"]) == 2 for a in avail), avail
    if name == "scaffold":
        assert all(len(a["dropped"]) == 1 for a in avail), avail
    hist = [r["sharded"][name]["history"] for r in ranks]
    assert all(h == hist[0] for h in hist)


def test_spec_mesh_reaches_the_trainer(ranks):
    """``ExperimentSpec.mesh`` round-trips JSON and reaches the trainer
    as a DeviceMesh with the spec's axes; a mesh without the "data"
    axis is refused."""
    from repro_torch.experiment import ExperimentSpec
    _register()
    spec = _cases()["fedphd"][0]
    back = ExperimentSpec.from_json(spec.to_json())
    assert back.mesh == {"data": 4, "model": 1} and back == spec
    assert ranks[0]["sharded"]["fedphd"]["mesh_axes"] == ("data", "model")
    assert ranks[0]["sharded"]["moon"]["mesh_axes"] == ("data", "model")
    for r in ranks:
        assert "needs a 'data' axis" in r["no_client_axis"]


def test_shard_clients_warns_once(ranks):
    """A non-dividing leading dim warns once a process and is returned
    whole; scalars pass quietly; a dividing leaf (torch or numpy) is cut
    to this rank's block, as a view."""
    for rank, r in enumerate(ranks):
        w = r["shard_warning"]
        assert w["counts"] == [1, 0]
        assert w["bad_shape"] == (6, 3)
        np.testing.assert_array_equal(
            w["ok"], np.arange(16.).reshape(8, 2)[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(w["host"],
                                      np.arange(8)[2 * rank:2 * rank + 2])
        assert w["view"]


@pytest.mark.parametrize("cloud", [False, True])
def test_hierarchical_aggregate_matches_sh_weights(ranks, cloud):
    """Eqs. 21-24 on (pod, data) = (2, 2), one client a rank: the edge
    tier within 1e-5 of each pod's clients weighted by the reference's
    ``sh_weights``, the cloud tier of the pods' aggregates weighted by
    ``sh_weights`` of their ReLU weight sums and weighted SH scores.
    One client's weight is clipped to 0 by the ReLU."""
    from repro.core.aggregation import sh_weights
    a, b = AGG["a"], AGG["b"]
    n, mu = np.asarray(AGG["n"]), np.asarray(AGG["mu"])
    raw = np.maximum(n + a * mu + b, 0.0)
    assert (raw == 0).sum() == 1
    leaves = [r["aggregate"]["params"] for r in ranks]
    pods = [[0, 1], [2, 3]]                 # rank = pod * 2 + data
    edge = []
    for p in pods:
        w = sh_weights(n[p], mu[p], a, b)
        edge.append({k: sum(w[i] * leaves[c][k].astype(np.float64)
                            for i, c in enumerate(p)) for k in leaves[0]})
    n_e = [raw[p].sum() for p in pods]
    mu_e = [(raw[p] * mu[p]).sum() / raw[p].sum() for p in pods]
    w_c = sh_weights(n_e, mu_e, a, b)
    cloud_agg = {k: sum(w_c[e] * edge[e][k] for e in range(2))
                 for k in leaves[0]}
    for rank, r in enumerate(ranks):
        got = r["aggregate"]["cloud" if cloud else "edge"]
        want = cloud_agg if cloud else edge[rank // 2]
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
        # an integer leaf is rounded after the sum
        assert got["step"] == np.round(want["step"])
        assert r["aggregate"]["step_dtype"] == "torch.int32"
