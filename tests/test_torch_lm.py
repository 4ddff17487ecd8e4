"""The RecurrentGemma serving slice of the port against the JAX package.

On ``smoke_variant("recurrentgemma-9b")`` (3 layers: rec, rec, local
attention; d = 256, window 64, fp32) with non-degenerate weights drawn
from a numpy seed (the reference init leaves the norm scales and every
bias at zero) and carried across with ``repro_torch.convert``: the scan
against the Pallas kernel in interpret mode and its oracle, the RG-LRU
layer, the prefill logits past the window, decode steps past the ring's
wrap, ``serve_requests`` token for token, refill isolation, the
parameter tree at smoke and full size, the bf16 and ``None`` leaves of
``convert``, and the entry points without a card.  The reference's runs
are built once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import config_to_dict as jax_cfg_dict
from repro.kernels.rglru_scan.ref import rglru_scan_ref
from repro.kernels.rglru_scan.rglru_scan import rglru_scan as jax_rglru_scan
from repro.launch.serve import seed_token as jax_seed_token
from repro.launch.serve import serve_requests as jax_serve_requests
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models import rglru as jax_rglru
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import config_to_dict
from repro_torch.convert import params_from_jax, params_to_jax, state_dict
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.launch import serve as lm_serve
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import attention as attn_lib
from repro_torch.models import model
from repro_torch.models import rglru

ARCH = "recurrentgemma-9b"
JCFG = jax_smoke_variant(ARCH)
CFG = smoke_variant(ARCH)
S_PREFILL = 128               # past the smoke window of 64
T_DECODE = 40                 # past the wrap of a 32-slot ring
CACHE_LEN = 32
# fp32 on both sides; the two differ only in summation order (XLA's
# dot vs torch's, an associative vs a sequential scan), so the logits
# agree to a few ulps of their largest value
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per process keeps torch from oversubscribing the cores (the
    small shapes here gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, r, name=""):
    """Weights at 1/sqrt(fan_in), norm scales and biases at 0.1 N(0,1),
    the conv taps at 0.3 N(0,1), log_lambda in the init's [-4.3, -1),
    a unit-scale embedding; stacked cycle leaves keep their first axis."""
    if isinstance(tree, dict):
        return {k: _randomize(v, r, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, r, name) for v in tree]
    shape = tree.shape
    if name == "log_lambda":
        z = r.uniform(-4.3, -1.0, shape)
    elif name == "conv_w":
        z = 0.3 * r.standard_normal(shape)
    elif name == "embed":
        z = r.standard_normal(shape)
    elif name.startswith(("w", "lm_head")):
        z = r.standard_normal(shape) / np.sqrt(shape[-2])
    else:                                   # ln1, ln2, final_norm, biases
        z = 0.1 * r.standard_normal(shape)
    return z.astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, torch params): the same numpy draws in both."""
    shapes = jax.eval_shape(lambda k: jax_model.init(k, JCFG),
                            jax.random.PRNGKey(0))
    np_params = _randomize(jax.tree.map(lambda s: s, shapes),
                           np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jparams, params_from_jax(np_params, device="cpu")


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S),
                                                dtype=np.int32)


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= tol * scale, (err, tol * scale)


def test_smoke_config_matches_jax():
    assert config_to_dict(CFG) == jax_cfg_dict(JCFG)
    assert config_to_dict(get_config(ARCH)) == jax_cfg_dict(
        jax_get_config(ARCH))
    assert CFG.layer_kinds() == JCFG.layer_kinds()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_plain_matches_pallas_and_oracle(dtype):
    r = np.random.default_rng(2)
    a = r.uniform(0.4, 0.999, (2, 256, 128)).astype(np.float32)
    b = r.standard_normal((2, 256, 128)).astype(np.float32)
    ja, jb = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (a, b))
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
    got = scan_ops.rglru_scan(ta, tb)          # CPU tensor: plain version
    assert got.dtype == ta.dtype and scan_ops.rglru_scan.launches == 0
    got = got.float().numpy()
    pallas = np.asarray(jax_rglru_scan(ja, jb, bs=128, interpret=True),
                        np.float32)
    oracle = np.asarray(rglru_scan_ref(ja, jb), np.float32)
    if dtype == "float32":
        # tests/test_kernels.py's tolerance for the kernel vs the oracle
        np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=0)
    else:
        # all three carry an fp32 state and round each output to bf16:
        # they differ by one bf16 step where their fp32 states straddle a
        # rounding boundary, and a bf16 step is at most 2^-7 of the value
        for want in (pallas, oracle):
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_scan_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="one"):
        scan_ops.rglru_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 4))


def test_apply_rglru_matches_jax(weights):
    jparams, tparams = weights
    jp = jax.tree.map(lambda t: t[0], jparams["cycles"][0]["rec"])
    tp = {k: v[0] for k, v in tparams["cycles"][0]["rec"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, S_PREFILL, CFG.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_rglru.apply_rglru(
        p, x, conv_width=CFG.conv1d_width))(jp, jnp.asarray(x))
    got = rglru.apply_rglru(tp, torch.from_numpy(x),
                            conv_width=CFG.conv1d_width)
    # fp32 GEMMs of width 256 and a 128-step recurrence in two orders
    _close_rel(got.numpy(), want, 1e-5)


@pytest.fixture(scope="module")
def jax_prefill(weights):
    jparams, _ = weights
    toks = _tokens(2, S_PREFILL)
    return toks, np.asarray(jax.jit(
        lambda p, t: jax_model.prefill(p, JCFG, {"tokens": t}))(
            jparams, jnp.asarray(toks)))


def test_prefill_matches_jax(weights, jax_prefill):
    _, tparams = weights
    toks, want = jax_prefill
    got = build_prefill_step(CFG)(tparams,
                                  {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, CFG.vocab_size) == want.shape
    _close_rel(got.numpy(), want, LOGIT_TOL)


def test_decode_steps_match_jax(weights):
    jparams, tparams = weights
    toks = _tokens(2, T_DECODE, seed=4)
    jdec = jax.jit(lambda p, c, t: jax_model.decode(p, c, JCFG, t))
    jcache = jax_model.init_cache(jparams, JCFG, 2, CACHE_LEN)
    tcache = model.init_cache(tparams, CFG, 2, CACHE_LEN)
    for t in range(T_DECODE):
        jl, jcache = jdec(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = model.decode(tparams, tcache, CFG,
                                  torch.from_numpy(toks[:, t:t + 1]))
        _close_rel(tl.numpy(), jl, LOGIT_TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    # the attention layer's ring (cycle 0, pattern position 2) wrapped
    ring = np.asarray(jcache["cycles"][2]["kv_pos"])
    assert ring.max() == T_DECODE - 1 and ring.min() == T_DECODE - CACHE_LEN
    np.testing.assert_array_equal(tcache["cycles"][2]["kv_pos"].numpy(),
                                  ring)
    for pos in (0, 1):                         # the two RG-LRU layers
        _close_rel(tcache["cycles"][pos]["h"].numpy(),
                   jcache["cycles"][pos]["h"], LOGIT_TOL)


def test_chunked_and_decode_attend_match_jax():
    r = np.random.default_rng(5)
    q = r.standard_normal((2, 128, 4, 32)).astype(np.float32)
    k, v = (r.standard_normal((2, 128, 1, 32)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(128, dtype=np.int32)
    kw = dict(causal=True, window=40, chunk=32)
    want = jax_attn.attend(*map(jnp.asarray, (q, k, v)),
                           q_positions=jnp.asarray(pos),
                           kv_positions=jnp.asarray(pos), **kw)
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    got = attn_lib.attend(tq, tk, tv, q_positions=tp, kv_positions=tp, **kw)
    dense = attn_lib.attend(tq, tk, tv, q_positions=tp, kv_positions=tp,
                            causal=True, window=40)
    # fp32 softmax over at most 40 keys
    _close_rel(got.numpy(), want, 1e-5)
    _close_rel(dense.numpy(), want, 1e-5)
    # one new token per row against a cache valid up to pos
    pos = np.asarray([5, 100], np.int32)
    want = jax_attn.decode_attend(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos), window=40)
    got = attn_lib.decode_attend(tq[:, :1], tk, tv, torch.from_numpy(pos),
                                 window=40)
    _close_rel(got.numpy(), want, 1e-5)


def test_serve_requests_match_jax(weights):
    jparams, tparams = weights
    kw = dict(slots=2, requests=3, max_tokens=4, cache_len=CACHE_LEN,
              seed=0)
    want = jax_serve_requests(jparams, JCFG, **kw)
    got = lm_serve.serve_requests(tparams, CFG, **kw)
    # greedy argmax over logits that agree to LOGIT_TOL: with these
    # weights no step's top two logits are that close, so every token
    # matches exactly
    assert got["outputs"] == want["outputs"]
    assert got["generated"] == want["generated"]
    assert len(got["step_seconds"]) == got["generated"] // kw["slots"]
    for rid in range(4):
        assert lm_serve.seed_token(CFG, 7, rid) == jax_seed_token(JCFG, 7,
                                                                  rid)


def test_serve_requests_refill_isolated(weights):
    """A refilled slot does not see the previous request's cache rows or
    token: a request's output is a function of its id only (the
    reference's tests/test_launch.py regression, on the port)."""
    _, tparams = weights
    kw = dict(requests=4, max_tokens=4, cache_len=16, seed=0)
    refilled = lm_serve.serve_requests(tparams, CFG, slots=2, **kw)
    isolated = lm_serve.serve_requests(tparams, CFG, slots=4, **kw)
    assert refilled["outputs"] == isolated["outputs"]


def test_reset_cache_slots(weights):
    _, tparams = weights
    step = build_serve_step(CFG)
    fresh = model.init_cache(tparams, CFG, 2, 16)
    cache, toks = fresh, torch.ones((2, 1), dtype=torch.int32)
    for _ in range(3):
        toks, cache = step(tparams, cache, toks)
    one = model.reset_cache_slots(cache, fresh, torch.tensor([True, False]))
    assert one["pos"].tolist() == [0, 3]
    for got, want in ((model.reset_cache_slots(cache, fresh,
                                               torch.tensor([True, True])),
                       fresh),
                      (model.reset_cache_slots(cache, fresh,
                                               torch.tensor([False, False])),
                       cache)):
        for (kg, g), (kw_, w) in zip(state_dict(got).items(),
                                     state_dict(want).items()):
            assert kg == kw_ and torch.equal(g, w), kg


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in state_dict(tree).items()}


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_param_tree_matches_jax(full):
    """Keys, shapes and dtypes of the port's init against the
    reference's, abstractly on both sides (the full model's 10.4 B
    parameters are never allocated: the port draws on ``meta``)."""
    jcfg = jax_get_config(ARCH) if full else JCFG
    cfg = get_config(ARCH) if full else CFG
    want = jax.eval_shape(lambda k: jax_model.init(k, jcfg),
                          jax.random.PRNGKey(0))
    gen = torch.Generator("cpu")
    gen.manual_seed(0)
    params = model.init(cfg, gen, device="meta")
    assert _shapes(params) == {k: (tuple(v.shape), str(v.dtype))
                               for k, v in state_dict(want).items()}
    if full:
        n = sum(v.numel() for v in state_dict(params).values())
        assert n == 10_444_984_320
        cache = model.init_cache(params, cfg, 8, 4096)
        jcache = jax.eval_shape(
            lambda: jax_model.init_cache(want, jcfg, 8, 4096))
        assert _shapes(cache) == {k: (tuple(v.shape), str(v.dtype))
                                  for k, v in state_dict(jcache).items()}


def test_convert_carries_bf16_and_none():
    r = np.random.default_rng(6)
    x = jnp.asarray(r.standard_normal((3, 5)), jnp.bfloat16)
    tree = {"w": x, "cycles": [None, {"b": jnp.ones((2,), jnp.float32)}]}
    t = params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    assert t["cycles"][0] is None
    assert t["w"].dtype == torch.bfloat16
    assert t["cycles"][1]["b"].dtype == torch.float32
    np.testing.assert_array_equal(t["w"].float().numpy(),
                                  np.asarray(x, np.float32))
    back = params_to_jax(t)
    assert back["cycles"][0] is None and back["w"].dtype == np.float32
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(back["w"]).astype(jnp.bfloat16)),
        np.asarray(x))
    # a bf16 reference model's whole tree crosses with its dtypes
    jcfg = JCFG.replace(param_dtype="bfloat16")
    jparams = jax.tree.map(
        lambda s: jnp.ones(s.shape, s.dtype),
        jax.eval_shape(lambda k: jax_model.init(k, jcfg),
                       jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert _shapes(tp) == {k: (tuple(v.shape), str(v.dtype))
                           for k, v in state_dict(jparams).items()}


def test_lm_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(CFG, torch.Generator(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_serve.main(["--requests", "1"])
    out = lm_serve.main(["--device", "cpu", "--requests", "3", "--batch",
                         "2", "--max-tokens", "2", "--cache-len", "16"])
    assert sorted(out["outputs"]) == [0, 1, 2]
    assert all(len(v) == 2 for v in out["outputs"].values())
