"""Structured pruning of every LM config in the port against the JAX
package: the groups of each architecture (head, cycle, tail and encoder
layers; heads, channels, lanes and experts), L2 scores over stacked and
unstacked groups (the unstacked ones through the segmented group-L2
launch, here its plain version), rank masks, compaction of stacked
groups cycle by cycle and ``compact_config``, Omega and its gradient
with per-cycle lambdas, FedPhD-OS's random one-shot prune, and an LM's
MOON feature.

The cases are the reference's smoke variants of ``internlm2-20b``,
``recurrentgemma-9b``, ``rwkv6-7b``, ``whisper-base`` and
``qwen3-moe-235b-a22b`` (the architectures of ``tests/test_pruning.py``),
``moonshot-v1-16b-a3b`` (an unstacked dense head layer before its MoE
cycle), and ``recurrentgemma-9b`` at depth 5 (one stacked cycle and a
two-layer unstacked tail, the route full depth takes).  Weights are
drawn from a numpy seed with non-degenerate scales (nonzero biases and
norm scales, RWKV's decays in their init range) and carried across by
``repro_torch.convert``; the mask scores are numpy draws on a coarse
grid, so that ties occur and the stable argsort decides them.  Every
reference value comes from one program (:func:`ref`), jitted once at
XLA's O0: eagerly, JAX compiles each primitive on its own.  The
reference's ``compact_params`` reads its kept counts off the masks
(``int(jnp.sum(row))``), which a traced program cannot, so
:func:`_ref_compact` runs its loop with the counts read here and the
reference's own ``keep_indices`` and ``_compact_param_axis`` traced.
"""
import dataclasses
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import config_to_dict as jax_cfg_dict
from repro.core import pruning as JP
from repro.core.pruning.compact import _compact_param_axis
from repro.fl import client as jclient
from repro.models import model as jax_model
from repro_torch.configs import get_config, list_archs, smoke_variant
from repro_torch.configs.base import config_to_dict
from repro_torch.convert import params_from_jax, state_dict
from repro_torch.core import pruning as P
from repro_torch.core.pruning import criteria
from repro_torch.fl import client as tclient
from repro_torch.kernels.group_l2_norms import ops as gl2
from repro_torch.metrics.flops import count_params_analytic
from repro_torch.models import model
from repro_torch.models import transformer as tfm

ARCHS = ("internlm2-20b", "recurrentgemma-9b", "rwkv6-7b", "whisper-base",
         "qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b")
TAIL = "recurrentgemma-9b@5"          # one stacked cycle, two tail layers
CASES = ARCHS + (TAIL,)
OMEGA_CASES = ("internlm2-20b", TAIL)
RATIO = 0.44
ONESHOT_RATIO = 0.5                   # the reference's one-shot test
LAMBDA0 = 1e-3
B, S = 2, 32
# fp32 sums of squares on both sides in another order: x the reference
SCORE_RTOL = 1e-6
# Omega's value: a sum over every unit of every group, in another order
OMEGA_RTOL = 1e-6
# each gradient leaf is 2 w lambda (4 w lambda where a lane owns both
# axes): x the leaf's largest reference value
GRAD_RTOL = 1e-6
# masked against compacted loss: the reference's test_mask_equals_compaction
LOSS_RTOL = 1e-5
# an LM's MOON feature (fp32 forwards in another order): x the largest
# reference value, the dense tests' hidden-state tolerance
FEATURE_TOL = 1e-4
FEATURE_SEED = 7
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several worker
    processes at once, and these shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(case):
    arch, _, depth = case.partition("@")
    cfg, jcfg = smoke_variant(arch), jax_smoke_variant(arch)
    if depth:
        cfg, jcfg = (c.replace(num_layers=int(depth)) for c in (cfg, jcfg))
    return cfg, jcfg


def _leaf(name, shape, r):
    fan = shape[-2] if len(shape) > 1 else 1
    if name == "embed":
        return r.standard_normal(shape)
    if name.startswith("mu"):
        return r.uniform(0.0, 1.0, shape)
    if name == "w0":                  # RWKV decays in their init range
        return r.uniform(-7.0, -4.0, shape)
    if name == "u":
        return 0.5 * r.standard_normal(shape)
    if name in ("ln_scale", "scale"):
        return 1.0 + 0.1 * r.standard_normal(shape)
    if name in ("lora_b", "decay_b"):
        return 0.3 * r.standard_normal(shape) / np.sqrt(fan)
    if name in ("lora_a", "decay_a", "lm_head", "router") \
            or name.startswith("w"):
        return r.standard_normal(shape) / np.sqrt(fan)
    return 0.1 * r.standard_normal(shape)     # norms, biases, log_lambda


def _randomize(tree, r, name=""):
    if isinstance(tree, dict):
        return {k: _randomize(v, r, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_randomize(v, r, name) for v in tree]
    if tree is None:
        return None
    return _leaf(name, tree.shape, r).astype(np.float32)


def _np_params(jcfg, seed):
    shapes = jax.eval_shape(lambda k: jax_model.init(k, jcfg),
                            jax.random.PRNGKey(0))
    return _randomize(shapes, np.random.default_rng(seed))


def _np_scores(groups, seed):
    """Uniform scores on a grid of 1/8: ties within every group."""
    r = np.random.default_rng(seed)
    return {g.name: np.round(8 * r.uniform(size=(g.stacked, g.size)
                                           if g.stacked else (g.size,)))
            .astype(np.float32) / 8 for g in groups}


def _batch(cfg, seed):
    """Token ids and labels shifted by one (-1 last); an encdec model's
    frames unit normal."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    out = {"tokens": toks,
           "labels": np.concatenate([toks[:, 1:], -np.ones((B, 1),
                                                           np.int32)], 1)}
    if cfg.arch_type == "encdec":
        out["frames"] = r.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _tbatch(batch, drop=()):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if k not in drop}


def _kept(groups, masks):
    return {g.name: int(np.sum(masks[g.name][0] if g.stacked
                               else masks[g.name])) for g in groups}


def _ref_compact(p, groups, masks, kept):
    """The reference's ``compact_params`` (``repro/core/pruning/
    compact.py:56``) with the kept counts given: each group's members
    by (path, axis + stacked), each parameter rebuilt once by
    ``_compact_param_axis`` from ``keep_indices``."""
    for g in groups:
        keep_idx = JP.keep_indices(masks[g.name], kept[g.name])
        by_pa = defaultdict(list)
        for m in g.members:
            by_pa[(m.path, m.axis + (1 if g.stacked else 0))].append(m)
        for (path, axis), members in by_pa.items():
            p = JP.set_path(p, path, _compact_param_axis(
                JP.get_path(p, path), axis, members, g, keep_idx))
    return p


def _reference(params, scores, masks, kept, feature_batch):
    """Every reference value the tests check, as one program; ``kept``
    (the compaction's shapes) are constants."""
    _, jcfg = _cfgs(ARCHS[0])
    out = {"feature": jclient.model_features(params[ARCHS[0]], jcfg,
                                             feature_batch, None)}
    for case in CASES:
        _, jcfg = _cfgs(case)
        p = params[case]
        groups = JP.build_groups(jcfg, p)
        out[case] = {"scores": JP.l2_scores(p, groups),
                     "masks": JP.make_masks(scores[case], groups,
                                            ONESHOT_RATIO if case.startswith(
                                                "qwen3") else RATIO)}
        if case in ARCHS:
            out[case]["compacted"] = _ref_compact(p, groups, masks[case],
                                                  kept[case])
        if case in OMEGA_CASES:
            lam = JP.depth_lambdas(groups, LAMBDA0)
            out[case]["omega"] = jax.value_and_grad(
                lambda q: JP.omega(q, groups, lam))(p)
    return out


@pytest.fixture(scope="module")
def inputs():
    """Per case: numpy params, the mask scores (qwen3-moe's the
    reference's ``random_scores``), the port's masks of them, and the
    groups."""
    data = {}
    for i, case in enumerate(CASES):
        cfg, jcfg = _cfgs(case)
        params = _np_params(jcfg, seed=i)
        jgroups = JP.build_groups(jcfg, params)
        if case.startswith("qwen3"):
            scores = {k: np.asarray(v) for k, v in JP.random_scores(
                jax.random.PRNGKey(3), jgroups).items()}
            ratio = ONESHOT_RATIO
        else:
            scores, ratio = _np_scores(jgroups, seed=100 + i), RATIO
        tparams = params_from_jax(params, CPU)
        groups = P.build_groups(cfg, tparams)
        masks = P.make_masks({k: torch.tensor(v) for k, v in scores.items()},
                             groups, ratio)
        data[case] = dict(params=params, tparams=tparams, groups=groups,
                          jgroups=jgroups, scores=scores,
                          masks={k: v.numpy() for k, v in masks.items()})
    return data


@pytest.fixture(scope="module")
def ref(inputs):
    """:func:`_reference`, jitted once at O0 with LLVM's expensive passes
    off."""
    params, scores, masks = ({c: inputs[c][k] for c in CASES}
                             for k in ("params", "scores", "masks"))
    kept = {c: _kept(inputs[c]["jgroups"], masks[c]) for c in CASES}
    feature_batch = _batch(_cfgs(ARCHS[0])[0], FEATURE_SEED)
    del feature_batch["labels"]
    program = jax.jit(lambda p, s, m, f: _reference(p, s, m, kept, f),
                      compiler_options={
                          "xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    return jax.tree.map(np.asarray, program(params, scores, masks,
                                            feature_batch))


def _as_tuple(g):
    return (g.name, g.size, tuple((tuple(m.path), m.axis, m.chunk, m.offset)
                                  for m in g.members),
            g.stacked, tuple(g.layer_indices), g.unit)


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_groups_match_reference_at_full_size(arch):
    """``build_groups`` of each full-size config equals the reference's,
    name for name (size, members, ``stacked``, layer indices, unit), on
    abstract trees (``jax.eval_shape``; the ``meta`` device); the
    unstacked members fit one group-L2 launch."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want = JP.build_groups(jcfg, jax.eval_shape(
        lambda k: jax_model.init(k, jcfg), jax.random.PRNGKey(0)))
    got = P.build_groups(cfg, model.init(cfg, torch.Generator(),
                                         device="meta"))
    assert [_as_tuple(g) for g in got] == [_as_tuple(g) for g in want]
    flat, stacked, slots, _ = criteria._layout(tuple(got))
    assert len(slots) <= gl2.MAX_TENSORS
    assert all(g.stacked == tfm.stack_plan(cfg).n_cycles
               or g.name.startswith("enc/") for g in stacked)
    if arch == "recurrentgemma-9b":   # 12 cycles of (rec, rec, attn), 2 tail
        assert [g.name for g in got] == [
            "cyc0/lru", "cyc0/ffn", "cyc1/lru", "cyc1/ffn", "cyc2/heads",
            "cyc2/ffn", "tail0/lru", "tail0/ffn", "tail1/lru", "tail1/ffn"]
        assert {g.stacked for g in stacked} == {12} and len(flat) == 4
        # a lane owns both axes of w_a and w_i: two launch entries each
        assert len(slots) == 30


# ---------------------------------------------------------------------------
# scores, masks and compaction against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_l2_scores_and_masks_match_reference(case, inputs, ref):
    """L2 scores within SCORE_RTOL of the reference's ((stacked, size)
    for a stacked group; the unstacked ones from one group-L2
    evaluation), and the masks of the injected scores bitwise the
    reference's: exactly k units a row, ties to the lower index."""
    d = inputs[case]
    got = P.l2_scores(d["tparams"], d["groups"])
    assert list(got) == [g.name for g in d["jgroups"]]
    for g in d["groups"]:
        want = ref[case]["scores"][g.name]
        assert tuple(got[g.name].shape) == want.shape == (
            (g.stacked, g.size) if g.stacked else (g.size,))
        np.testing.assert_allclose(got[g.name].numpy(), want,
                                   rtol=SCORE_RTOL)
        np.testing.assert_array_equal(d["masks"][g.name],
                                      ref[case]["masks"][g.name])
    if case == TAIL:
        assert sum(not g.stacked for g in d["groups"]) == 4


@pytest.mark.parametrize("case", ARCHS)
def test_compaction_matches_reference(case, inputs, ref):
    """``compact`` of the same masks: every parameter bitwise the
    reference's (stacked groups gathered cycle by cycle), the config
    field for field (``-pruned``), and the pruned model runs:
    ``count_params_analytic`` counts its tree, and its loss and prefill
    are finite."""
    cfg, jcfg = _cfgs(case)
    d = inputs[case]
    masks = {k: torch.from_numpy(v) for k, v in d["masks"].items()}
    new, new_cfg, report = P.compact(d["tparams"], cfg, d["groups"], masks)
    got = state_dict(new)
    want = state_dict(params_from_jax(ref[case]["compacted"], CPU))
    assert got.keys() == want.keys()
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
               for k in got)
    kept = _kept(d["jgroups"], d["masks"])
    assert report == {g.name: (kept[g.name], g.size) for g in d["jgroups"]}
    assert config_to_dict(new_cfg) == jax_cfg_dict(JP.compact_config(
        jcfg, d["jgroups"], kept))
    assert new_cfg.name == cfg.name + "-pruned"
    assert count_params_analytic(new_cfg) == sum(
        v.numel() for v in got.values()) < count_params_analytic(cfg)
    batch = _tbatch(_batch(new_cfg, seed=5))
    loss = model.loss_fn(new, new_cfg, batch, remat=False)
    logits = model.prefill(new, new_cfg, _tbatch(_batch(new_cfg, seed=5),
                                                 drop=("labels",)))
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(logits).all())
    assert tuple(logits.shape) == (B, cfg.vocab_size)


@pytest.mark.parametrize("case", ("rwkv6-7b", TAIL))
def test_compaction_keeps_a_bf16_trees_fp32_leaves(case):
    """A bf16 tree from the port's init: fp32 scores from bf16 members
    (the tail's through the group-L2 function), and every leaf keeps its
    dtype through compaction, the fp32 ones too (RWKV's ``w0`` and
    ``u``, the RG-LRU's ``log_lambda``: ROADMAP C, hazard 14)."""
    cfg = _cfgs(case)[0].replace(dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(cfg, gen, device="cpu")
    groups = P.build_groups(cfg, params)
    scores = P.l2_scores(params, groups)
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in scores.values())
    new, _, _ = P.compact(params, cfg, groups,
                          P.make_masks(scores, groups, RATIO))
    dtypes = {k: v.dtype for k, v in state_dict(params).items()}
    assert {k: v.dtype for k, v in state_dict(new).items()} == dtypes
    assert set(dtypes.values()) == {torch.bfloat16, torch.float32}


@pytest.mark.parametrize("case", ("internlm2-20b", "recurrentgemma-9b",
                                  "rwkv6-7b", "whisper-base", TAIL))
def test_mask_equals_compaction(case, inputs):
    """Zeroing the pruned units and slicing them out give the same loss
    (the reference's central invariant, on the port's own loss), with
    masks from the port's L2 scores."""
    cfg, _ = _cfgs(case)
    d = inputs[case]
    groups = d["groups"]
    masks = P.make_masks(P.l2_scores(d["tparams"], groups), groups, RATIO)
    batch = _tbatch(_batch(cfg, seed=9))
    masked = model.loss_fn(P.apply_masks(d["tparams"], groups, masks), cfg,
                           batch, remat=False)
    new, new_cfg, _ = P.compact(d["tparams"], cfg, groups, masks)
    compacted = model.loss_fn(new, new_cfg, batch, remat=False)
    np.testing.assert_allclose(float(masked), float(compacted),
                               rtol=LOSS_RTOL)


def test_oneshot_random_prune_qwen3(inputs):
    """FedPhD-OS on qwen3-moe: the reference's random scores injected,
    half the experts pruned (``experts_per_token`` clipped to them), and
    the pruned model's loss finite."""
    cfg, _ = _cfgs("qwen3-moe-235b-a22b")
    d = inputs["qwen3-moe-235b-a22b"]
    masks = {k: torch.from_numpy(v) for k, v in d["masks"].items()}
    new, new_cfg, _ = P.compact(d["tparams"], cfg, d["groups"], masks)
    assert new_cfg.moe.num_experts == 2 < cfg.moe.num_experts
    assert new_cfg.moe.experts_per_token == 2
    loss = model.loss_fn(new, new_cfg, _tbatch(_batch(new_cfg, seed=2)),
                         remat=False)
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# Omega, lambdas, random scores, the client axis, MOON
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", OMEGA_CASES)
def test_omega_and_grads_match_reference(case, inputs, ref):
    """Omega with per-cycle lambdas and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``omega``: the unstacked
    groups through the group-L2 function's backward, the stacked ones
    through autograd."""
    d = inputs[case]
    leaves = state_dict(d["tparams"])
    params = params_from_jax(d["params"], CPU)
    flat = state_dict(params)
    for t in flat.values():
        t.requires_grad_(True)
    lam = P.depth_lambdas(d["groups"], LAMBDA0)
    om = P.omega(params, d["groups"], lam)
    grads = torch.autograd.grad(om, list(flat.values()), allow_unused=True)
    want_om, want_g = ref[case]["omega"]
    np.testing.assert_allclose(float(om.detach()), float(want_om),
                               rtol=OMEGA_RTOL)
    want_g = state_dict(params_from_jax(want_g, CPU))
    assert want_g.keys() == leaves.keys()
    for (k, t), g in zip(flat.items(), grads):
        w = want_g[k].numpy()
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max())


def test_depth_lambdas_per_cycle(inputs):
    """A stacked group's lambdas, one per cycle, equal the reference's;
    the tail's are single."""
    d = inputs[TAIL]
    got = P.depth_lambdas(d["groups"], LAMBDA0)
    want = JP.depth_lambdas(d["jgroups"], LAMBDA0)
    assert got.keys() == want.keys()
    for g in d["groups"]:
        np.testing.assert_array_equal(got[g.name], want[g.name])
        assert got[g.name].shape == (g.stacked or 1,)
    cfg = get_config("recurrentgemma-9b")
    groups = P.build_groups(cfg, model.init(cfg, torch.Generator(),
                                            device="meta"))
    lam = P.depth_lambdas(groups, LAMBDA0)
    assert lam["cyc0/lru"].shape == (12,)
    np.testing.assert_array_equal(
        lam["cyc1/ffn"], LAMBDA0 / np.maximum(np.abs(
            np.arange(1, 36, 3, dtype=np.float32) - 37 / 2), 0.5))


def test_random_scores_shapes_and_client_axis(inputs):
    """``random_scores`` draws (stacked, size) for a stacked group and
    (size,) otherwise; the vectorized engine's client axis refuses a
    stacked group, too many tensors for one launch raise, and Omega of
    no groups is an fp32 zero, as the reference's."""
    d = inputs[TAIL]
    gen = torch.Generator()
    gen.manual_seed(0)
    scores = P.random_scores(gen, d["groups"], device="cpu")
    assert {k: tuple(v.shape) for k, v in scores.items()} == {
        g.name: (g.stacked, g.size) if g.stacked else (g.size,)
        for g in d["groups"]}
    with pytest.raises(ValueError, match="clients=2"):
        P.omega(d["tparams"], d["groups"],
                P.depth_lambdas(d["groups"], LAMBDA0), clients=2)
    tail = [g for g in d["groups"] if not g.stacked]
    many = [dataclasses.replace(g, name=f"{g.name}{i}", members=tuple(
        dataclasses.replace(m, path=m.path + (i,)) for m in g.members))
        for i in range(9) for g in tail]
    with pytest.raises(ValueError, match=f"{15 * 18} tensors"):
        P.member_table(d["tparams"], many)
    none = P.omega(d["tparams"], [], {})
    assert none.dtype == torch.float32 and none.shape == () \
        and float(none) == 0.0


def test_lm_moon_feature(inputs, ref):
    """An LM's MOON feature, the mean over the sequence of the hidden
    states, within FEATURE_TOL of the reference's ``model_features`` on
    the same params and tokens; the client axis stacks U-Net params
    only."""
    cfg, _ = _cfgs(ARCHS[0])
    d = inputs[ARCHS[0]]
    batch = _tbatch(_batch(cfg, FEATURE_SEED), drop=("labels",))
    got = tclient.model_features(d["tparams"], cfg, batch).numpy()
    want = ref["feature"]
    assert got.shape == want.shape == (B, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FEATURE_TOL * np.abs(want).max())
    with pytest.raises(ValueError, match="clients"):
        tclient.model_features(d["tparams"], cfg, batch, clients=2)
