"""The transformer stack's dense extras of the port against the JAX
package: gemma2's attention soft-capping, command-r's parallel blocks,
internlm2's plain GQA stack, internvl2's image prefix, and whisper's
encoder and cross-attention.

Each of ``gemma2-2b``, ``command-r-35b``, ``internlm2-20b``,
``internvl2-76b`` and ``whisper-base`` runs as the reference's smoke
variant, with non-degenerate weights drawn from a numpy seed (nonzero
biases and norm scales: the reference's init leaves them at zero, which
would hide the bias paths) and carried across by ``repro_torch.convert``:
the configs, smoke variants, input shapes and ``adapt_for_shape``; the
parameter and cache trees at full size; the hidden states, loss and
every gradient leaf; three decode steps (whisper's against the reference
encoder's output with nonzero biases, which pins the reference's decode
cross-attention without q/k/v biases); the port's prefill against its own
decode; the attention route (which layers launch ``ops.attention``);
a whisper refill; ``convert`` on the encoder tree; and the LM CLIs.

Every reference value comes from one program (:func:`ref`), jitted once
at XLA's O0: eagerly, JAX compiles each primitive on its own.  The
port's CPU tensors run the kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import adapt_for_shape as jax_adapt_for_shape
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import list_archs as jax_list_archs
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import config_to_dict as jax_cfg_dict
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models import transformer as jax_tfm
from repro.models.common import ApplyOptions
from repro_torch.configs import (INPUT_SHAPES, RWKV, adapt_for_shape,
                                 get_config, get_shape, list_archs,
                                 smoke_variant)
from repro_torch.configs.base import InputShape, config_to_dict
from repro_torch.convert import params_from_jax, params_to_jax, state_dict
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import train as lm_train
from repro_torch.models import attention as attn_lib
from repro_torch.models import model
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ("gemma2-2b", "command-r-35b", "internlm2-20b", "internvl2-76b",
         "whisper-base")
B, S = 2, 72                     # past the smoke window of 64
T_DECODE, CACHE_LEN = 3, 16
# prefill against decode: gemma2 past its window of 64 (the ring
# wraps); the others over a few tokens
CONSISTENCY_SEQ = {"gemma2-2b": 72, "command-r-35b": 8,
                   "internvl2-76b": 8, "whisper-base": 8}
# fp32 on both sides, differing only in summation order: the reference's
# tolerance for the LM logits (tests/test_torch_lm.py)
LOGIT_TOL = 1e-4
# plain attention with the cap in reach of the logits, and a window
ATTN_CASE = dict(softcap=2.0, window=24, chunk=16)
NO_REMAT = ApplyOptions(remat=False)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several worker
    processes at once, and these shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, r, name=""):
    """Weights at 1/sqrt(fan_in), norm scales and biases at
    0.1 N(0, 1), a unit-scale embedding; stacked leaves keep their first
    axis."""
    if isinstance(tree, dict):
        return {k: _randomize(v, r, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, r, name) for v in tree]
    shape = tree.shape
    if name == "embed":
        z = r.standard_normal(shape)
    elif name.startswith(("w", "lm_head")):
        z = r.standard_normal(shape) / np.sqrt(shape[-2])
    else:
        z = 0.1 * r.standard_normal(shape)
    return z.astype(np.float32)


def _np_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda k: jax_model.init(k, jcfg),
                            jax.random.PRNGKey(0))
    return _randomize(jax.tree.map(lambda s: s, shapes),
                      np.random.default_rng(seed))


def _batch(cfg, seed=1):
    """Token ids from a numpy seed, labels the tokens shifted by one
    (the last position -1); a VLM's image embeddings take the first
    ``num_image_tokens`` positions (labels -1 there), an encdec model's
    frames are unit normal."""
    r = np.random.default_rng(seed)
    n_img = cfg.num_image_tokens if cfg.arch_type == "vlm" else 0
    toks = r.integers(0, cfg.vocab_size, (B, S - n_img), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    out = {"tokens": toks}
    if n_img:
        out["image_embeds"] = r.standard_normal(
            (B, n_img, cfg.d_model)).astype(np.float32)
        labels = np.concatenate([-np.ones((B, n_img), np.int32), labels], 1)
    if cfg.arch_type == "encdec":
        out["frames"] = r.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    out["labels"] = labels
    return out


def _attend_inputs():
    r = np.random.default_rng(4)
    q = 2.0 * r.standard_normal((B, 64, 4, 32))
    k, v = (r.standard_normal((B, 64, 2, 32)) for _ in range(2))
    return tuple(a.astype(np.float32) for a in (q, k, v))


def _reference(models, attend_in):
    """Every reference value the tests check, as one program."""
    out = {}
    for arch, (params, batch) in models.items():
        jcfg = jax_smoke_variant(arch)

        def loss(p):
            # model.loss_fn's sum, keeping the forward's outputs
            hidden, aux = jax_tfm.forward(p, jcfg, batch, NO_REMAT)
            return jax_tfm.chunked_xent(p, jcfg, hidden, batch["labels"],
                                        opts=NO_REMAT) + aux, hidden
        (out[arch + "/loss"], out[arch + "/hidden"]), \
            out[arch + "/grads"] = jax.value_and_grad(loss, has_aux=True)(
                params)

        enc = None
        if jcfg.arch_type == "encdec":
            enc = out[arch + "/enc"] = jax_tfm.apply_encoder(
                params, batch["frames"], jcfg, NO_REMAT)

        def step(cache, tok):
            lg, cache = jax_model.decode(params, cache, jcfg, tok[:, None])
            return cache, lg
        cache, logits = jax.lax.scan(
            step, jax_tfm.init_cache(params, jcfg, B, CACHE_LEN,
                                     enc_out=enc),
            batch["tokens"][:, :T_DECODE].T)
        out[arch + "/decode"] = (logits, cache)

    q, k, v = attend_in
    pos = jnp.arange(q.shape[1], dtype=jnp.int32)
    out["attend"] = jax_attn.attend(
        q, k, v, q_positions=pos, kv_positions=pos, causal=True,
        window=ATTN_CASE["window"], attn_softcap=ATTN_CASE["softcap"],
        chunk=ATTN_CASE["chunk"])
    return out


@pytest.fixture(scope="module")
def inputs():
    models = {arch: (_np_params(jax_smoke_variant(arch)),
                     _batch(smoke_variant(arch))) for arch in ARCHS}
    return models, _attend_inputs()


@pytest.fixture(scope="module")
def ref(inputs):
    """:func:`_reference`, jitted once at O0 with LLVM's expensive passes
    off."""
    program = jax.jit(_reference, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    return jax.tree.map(np.asarray, program(*inputs))


def _close_rel(got, want, tol=LOGIT_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= tol * scale, (err, tol * scale)


def _torch(tree):
    return params_from_jax(tree, device=CPU)


def _tbatch(batch, drop=("labels",)):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if k not in drop}


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in state_dict(tree).items()}


# ---------------------------------------------------------------------------
# configs, shapes and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_smoke_variants_match_jax(arch):
    assert config_to_dict(get_config(arch)) == jax_cfg_dict(
        jax_get_config(arch))
    assert config_to_dict(smoke_variant(arch)) == jax_cfg_dict(
        jax_smoke_variant(arch))
    plan = tfm.stack_plan(smoke_variant(arch))
    jplan = jax_tfm.stack_plan(jax_smoke_variant(arch))
    assert (plan.n_head, plan.n_cycles, plan.pattern, plan.tail_kinds) == (
        jplan.n_head, jplan.n_cycles, jplan.pattern, jplan.tail_kinds)
    # every reference architecture, and every layer kind planned as the
    # reference plans it
    assert list_archs() == jax_list_archs()
    rwkv = get_config(arch).replace(layer_pattern=(RWKV,))
    plan = tfm.stack_plan(rwkv)
    jplan = jax_tfm.stack_plan(jax_get_config(arch).replace(
        layer_pattern=(RWKV,)))
    assert (plan.n_head, plan.n_cycles, plan.pattern, plan.tail_kinds) == (
        jplan.n_head, jplan.n_cycles, jplan.pattern, jplan.tail_kinds)


def test_shapes_and_adapt_for_shape_match_jax():
    """``get_shape`` and ``adapt_for_shape`` for every architecture at
    every assigned shape (long_500k windows the global layers)."""
    assert sorted(INPUT_SHAPES) == ["decode_32k", "long_500k",
                                    "prefill_32k", "train_4k"]
    for name in INPUT_SHAPES:
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(jax_get_shape(name))
        for arch in list_archs():
            assert config_to_dict(adapt_for_shape(
                get_config(arch), get_shape(name))) == jax_cfg_dict(
                jax_adapt_for_shape(jax_get_config(arch),
                                    jax_get_shape(name)))
    assert adapt_for_shape(get_config("command-r-35b"),
                           get_shape("long_500k")).name \
        == "command-r-35b+swa4096"


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_input_specs_match_jax(mode):
    shape = InputShape("t", 64, 2, mode)
    for arch in ("internvl2-76b", "whisper-base"):
        cfg, jcfg = smoke_variant(arch), jax_smoke_variant(arch)
        want = jax_model.input_specs(jcfg, shape)
        got = model.input_specs(cfg, shape)
        assert {k: (s.shape, str(s.dtype).removeprefix("torch."))
                for k, s in got.items()} == {
            k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}
        gen = torch.Generator()
        gen.manual_seed(0)
        made = model.make_inputs(cfg, shape, gen)
        assert {k: tuple(v.shape) for k, v in made.items()} == \
            {k: s.shape for k, s in got.items()}


def test_param_and_cache_trees_match_jax_at_full_size():
    """Each config's full tree (keys, shapes, dtypes; whisper's
    ``encoder`` and ``cross`` leaves) and decode cache (whisper's
    ``enc_out``), abstractly on both sides (the port draws on
    ``meta``)."""
    for arch in ARCHS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        want = jax.eval_shape(lambda k: jax_model.init(k, jcfg),
                              jax.random.PRNGKey(0))
        params = model.init(cfg, torch.Generator(), device="meta")
        assert _shapes(params) == {k: (tuple(v.shape), str(v.dtype))
                                   for k, v in state_dict(want).items()}
        cache = model.init_cache(params, cfg, 8, 4096)
        jcache = jax.eval_shape(
            lambda: jax_model.init_cache(want, jcfg, 8, 4096))
        assert _shapes(cache) == {k: (tuple(v.shape), str(v.dtype))
                                  for k, v in state_dict(jcache).items()}
        assert ("enc_out" in cache) == (arch == "whisper-base")


def test_convert_carries_the_encoder_and_cross_leaves(inputs):
    np_params = inputs[0]["whisper-base"][0]
    tp = _torch(np_params)
    flat = state_dict(tp)
    assert "encoder.blocks.attn.wq" in flat and "encoder.final_norm" in flat
    assert "cycles.0.cross.bq" in flat and "cycles.0.ln_cross" in flat
    back = state_dict(tree_map(torch.from_numpy, params_to_jax(tp)))
    want = state_dict(tree_map(torch.from_numpy, np_params))
    assert back.keys() == want.keys() == flat.keys()
    assert all(torch.equal(back[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def test_softcapped_windowed_attend_matches_jax(inputs, ref):
    q, k, v = (torch.from_numpy(a) for a in inputs[1])
    pos = torch.arange(q.shape[1], dtype=torch.int32)
    got = attn_lib.attend(q, k, v, q_positions=pos, kv_positions=pos,
                          causal=True, window=ATTN_CASE["window"],
                          attn_softcap=ATTN_CASE["softcap"],
                          chunk=ATTN_CASE["chunk"])
    _close_rel(got, ref["attend"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, inputs, ref):
    np_params, batch = inputs[0][arch]
    cfg = smoke_variant(arch)
    tp = _torch(np_params)
    hidden, aux = tfm.forward(tp, cfg, _tbatch(batch))
    _close_rel(hidden, ref[arch + "/hidden"])
    assert float(aux) == 0.0
    if arch == "whisper-base":
        _close_rel(tfm.apply_encoder(tp, torch.from_numpy(batch["frames"]),
                                     cfg), ref[arch + "/enc"])
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    # remat on (the port's default), off in the reference: the same values
    loss = model.loss_fn(tp, cfg, _tbatch(batch, drop=()))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    _close_rel(loss, ref[arch + "/loss"], 1e-6)
    names = list(state_dict(tp))
    jflat = state_dict(tree_map(lambda a: torch.from_numpy(np.array(a)),
                                ref[arch + "/grads"]))
    assert len(grads) == len(names) == len(jflat)
    largest = max(float(w.abs().max()) for w in jflat.values())
    for name, g in zip(names, grads):
        w = jflat[name]
        if g is None:            # a parallel block's ln2 is not read
            assert arch == "command-r-35b" and name.endswith("ln2"), name
            assert not w.any(), name
            continue
        assert g.shape == w.shape, name
        if name.endswith("cross.bk"):
            # a key bias without RoPE shifts every logit of a query
            # alike, so its exact gradient is 0: both sides hold rounding
            # noise, held to the largest gradient of any leaf
            assert float(w.abs().max()) <= 1e-6 * largest, name
            assert float((g - w).abs().max()) <= LOGIT_TOL * largest, name
            continue
        _close_rel(g, w.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, inputs, ref):
    """Three steps from a fresh cache; whisper's holds the reference
    encoder's output, and its nonzero cross biases must be left out of
    decode's q/k/v, as the reference's decode does."""
    np_params, batch = inputs[0][arch]
    cfg = smoke_variant(arch)
    tp = _torch(np_params)
    if arch == "whisper-base":
        assert float(tp["cycles"][0]["cross"]["bq"].abs().min()) > 0
        cache = tfm.init_cache(tp, cfg, B, CACHE_LEN, enc_out=torch.tensor(
            ref[arch + "/enc"]))
    else:
        cache = model.init_cache(tp, cfg, B, CACHE_LEN)
    given, first = cache, tree_map(torch.clone, cache)
    jlogits, jcache = ref[arch + "/decode"]
    for t in range(T_DECODE):
        lg, cache = model.decode(tp, cache, cfg, torch.from_numpy(
            batch["tokens"][:, t:t + 1]))
        _close_rel(lg, jlogits[t])
    got = state_dict(cache)
    for k, want in state_dict(tree_map(
            lambda a: torch.from_numpy(np.array(a)), jcache)).items():
        if want.dtype == torch.int32:
            assert torch.equal(got[k], want), k
        else:
            _close_rel(got[k], want.numpy())
    # decode left the cache it was given as it was
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(given),
                                                 tree_leaves(first)))


@pytest.mark.parametrize("arch", sorted(CONSISTENCY_SEQ))
def test_prefill_equals_decode(arch, inputs):
    """The port's last prefill logits against its decode after the same
    positions: internvl2's image positions carry the embeddings of chosen
    token ids, which decode then feeds; whisper's cache holds the
    prefill's encoder output and its cross q/k/v biases are zero (the
    reference's decode leaves them out); gemma2's softcaps are on and
    its local layers' rings wrap."""
    np_params, batch = inputs[0][arch]
    cfg = smoke_variant(arch)
    tp = _torch(np_params)
    n = CONSISTENCY_SEQ[arch]
    toks = torch.from_numpy(batch["tokens"][:, :n]).long()
    feed = toks
    pre_batch = {"tokens": toks}
    enc = None
    if arch == "internvl2-76b":
        ids = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, cfg.num_image_tokens)))
        pre_batch["image_embeds"] = tp["embed"][ids]
        feed = torch.cat([ids, toks], dim=1)
    if arch == "whisper-base":
        for key in ("bq", "bk", "bv"):
            tp["cycles"][0]["cross"][key].zero_()
        pre_batch["frames"] = torch.from_numpy(batch["frames"])
        enc = tfm.apply_encoder(tp, pre_batch["frames"], cfg)
    assert cfg.attn_softcap == (50.0 if arch == "gemma2-2b" else 0.0)
    pre = model.prefill(tp, cfg, pre_batch)
    cache = tfm.init_cache(tp, cfg, B, feed.shape[1], enc_out=enc)
    for t in range(feed.shape[1]):
        lg = model.decode_(tp, cache, cfg, feed[:, t:t + 1])
    assert cache["pos"].tolist() == [feed.shape[1]] * B
    _close_rel(lg[:, 0], pre.numpy())


def test_attention_route(inputs, monkeypatch):
    """``ops.attention`` (the kernel's wrapper) runs once a causal layer
    without soft-capping and never for gemma2's soft-capped layers, the
    encoder's bidirectional ones, cross-attention or decode."""
    calls = []
    real = tfm.ops.attention

    def counted(q, k, v, *, causal=False, window=0):
        calls.append((q.shape[2], k.shape[2], causal, window))
        return real(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(tfm.ops, "attention", counted)
    for arch in ARCHS:
        cfg = smoke_variant(arch)
        np_params, batch = inputs[0][arch]
        tp = _torch(np_params)
        calls.clear()
        tfm.forward(tp, cfg, _tbatch(batch))
        want = 0 if cfg.attn_softcap else cfg.num_layers
        assert len(calls) == want, (arch, calls)
        assert all(c[2] for c in calls)
        model.decode_(tp, model.init_cache(tp, cfg, B, CACHE_LEN), cfg,
                      torch.zeros((B, 1), dtype=torch.int32))
        assert len(calls) == want, arch


def test_whisper_serve_refill(inputs):
    """Two slots refilled for four requests give each request what it
    gets alone in its own slot; a reset slot's ``enc_out`` rows are the
    fresh cache's again, the others untouched."""
    arch = "whisper-base"
    cfg = smoke_variant(arch)
    tp = _torch(inputs[0][arch][0])
    kw = dict(requests=4, max_tokens=4, cache_len=CACHE_LEN, seed=0)
    refilled = lm_serve.serve_requests(tp, cfg, slots=2, **kw)
    alone = lm_serve.serve_requests(tp, cfg, slots=4, **kw)
    assert refilled["outputs"] == alone["outputs"]
    assert refilled["generated"] == alone["generated"] == 16
    enc = torch.randn(2, cfg.encoder_seq_len, cfg.d_model)
    cache = tfm.init_cache(tp, cfg, 2, CACHE_LEN, enc_out=enc.clone())
    model.decode_(tp, cache, cfg, torch.ones((2, 1), dtype=torch.int32))
    fresh = model.init_cache(tp, cfg, 1, CACHE_LEN)
    model.reset_cache_slots_(cache, fresh, torch.tensor([True, False]))
    assert cache["pos"].tolist() == [0, 1]
    assert not cache["enc_out"][0].any()
    assert torch.equal(cache["enc_out"][1], enc[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_clis_run_each_arch_on_cpu(arch, capsys):
    """Both CLIs on each config's smoke variant; gemma2-2b is what they
    run without ``--arch``, as the reference's launchers do."""
    pick = [] if arch == "gemma2-2b" else ["--arch", arch]
    out = lm_serve.main(pick + ["--device", "cpu", "--requests", "3",
                                "--batch", "2", "--max-tokens", "2",
                                "--cache-len", "8"])
    assert sorted(out["outputs"]) == [0, 1, 2]
    res = lm_train.main(pick + ["--device", "cpu", "--steps", "2",
                                "--batch", "2", "--seq", "16"])
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
    assert capsys.readouterr().out.count(f"arch={arch}-smoke") == 2
