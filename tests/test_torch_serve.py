"""The serving slice of the port against the JAX package.

On ``SMOKE_UNET`` with non-degenerate weights (the reference init puts
conv2, proj and conv_out at 1e-6, which would make every epsilon match
trivially) drawn from a numpy seed and carried across with
``repro_torch.convert``: the U-Net forward dense and masked, the pruning
masks, the MACs, the DDIM server against ``ddim_sample(x_init=)``,
checkpoints in both directions and the CLI.  Also the full-width
``CIFAR10_UNET`` parameter tree, and that the port imports neither JAX
nor the JAX package.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs import CIFAR10_UNET as JAX_CIFAR
from repro.configs import SMOKE_UNET as JAX_SMOKE
from repro.configs.base import config_to_dict as jax_cfg_dict
from repro.core.pruning import criteria as jax_criteria
from repro.diffusion import ddim_sample as jax_ddim_sample
from repro.diffusion.schedule import linear_schedule as jax_schedule
from repro.metrics.flops import unet_macs as jax_unet_macs
from repro.models.unet import apply_unet as jax_apply_unet
from repro.models.unet import init_unet as jax_init_unet
from repro.serve import masks_for_ratio as jax_masks_for_ratio
from repro_torch import checkpoint
from repro_torch.configs import CIFAR10_UNET, SMOKE_UNET
from repro_torch.configs.base import config_to_dict
from repro_torch.convert import (masks_from_jax, params_from_jax,
                                 params_to_jax, state_dict)
from repro_torch.diffusion import ddim_sample, linear_schedule
from repro_torch.metrics.flops import unet_macs
from repro_torch.models.unet import apply_unet, init_unet
from repro_torch.serve import DiffusionServer, Request, masks_for_ratio
from repro_torch.serve.__main__ import main as serve_main

JCFG = JAX_SMOKE.replace(backend="xla")
STEPS = 3
ATOL = 1e-4
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
# the reference's programs compile at XLA's O0 with LLVM's expensive
# passes off: a SMOKE U-Net forward compiles in less time than the
# default level takes, and the few runs here do not pay for slower code
O0 = {"xla_backend_optimization_level": 0,
      "xla_llvm_disable_expensive_passes": True,
      # XLA's loop emitters: less compile CPU, the same graph
      "xla_cpu_use_fusion_emitters": False}
_jax_forward = jax.jit(lambda p, x, t: jax_apply_unet(p, JCFG, x, t),
                       compiler_options=O0)
# the reference's deterministic DDIM sampler from x_init, one program a
# batch size
_jax_ddim = jax.jit(lambda p, x: jax_ddim_sample(
    lambda xx, tt: jax_apply_unet(p, JCFG, xx, tt),
    jax_schedule(JCFG.diffusion_steps), jax.random.PRNGKey(0), x.shape,
    num_steps=STEPS, x_init=x), compiler_options=O0)
_L2_PROGRAMS = {}
_jax_l2_scores = jax_criteria.l2_scores


def _jitted_l2_scores(params, groups, backend=""):
    """The reference's ``l2_scores`` in one program per group list:
    eagerly it compiles each of its ops on its own (~3 s here)."""
    key = (tuple(groups), backend)
    if key not in _L2_PROGRAMS:
        _L2_PROGRAMS[key] = jax.jit(
            lambda p: _jax_l2_scores(p, groups, backend=backend),
            compiler_options=O0)
    return _L2_PROGRAMS[key](params)


@pytest.fixture(autouse=True, scope="module")
def _jitted_reference_scores():
    """The reference's ``masks_for_ratio`` scores through
    :func:`_jitted_l2_scores` (it looks ``l2_scores`` up when called)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_criteria, "l2_scores", _jitted_l2_scores)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per process keeps torch from oversubscribing the cores (the
    small shapes here gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, r):
    """Weights at 1/sqrt(fan_in), norm scales near 1, small biases."""
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
            # float32, as the reference holds them: dividing by numpy's
            # float64 sqrt would otherwise hand the port float64 weights
            out[k] = z.astype(np.float32)
        return out
    return [_randomize(v, r) for v in tree]


@pytest.fixture(scope="module")
def np_params():
    # every leaf is redrawn, so the reference tree's shapes are enough
    shapes = jax.eval_shape(lambda k: jax_init_unet(k, JAX_SMOKE),
                            jax.random.PRNGKey(0))
    return _randomize(shapes, np.random.default_rng(0))


@pytest.fixture(scope="module")
def jax_params(np_params):
    return jax.tree.map(jnp.asarray, np_params)


@pytest.fixture(scope="module")
def torch_params(np_params):
    return params_from_jax(np_params, device="cpu")


def _xt(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 16, 16, 3)).astype(np.float32)


def test_convert_roundtrip_and_state_dict_keys(np_params, torch_params):
    back = params_to_jax(torch_params)
    jax.tree.map(np.testing.assert_array_equal, back, np_params)
    flat = state_dict(torch_params)
    assert "down.1.blocks.0.attn.qkv.w" in flat
    assert "mid.res1.conv1.b" in flat
    assert flat["down.1.blocks.0.attn.qkv.w"] is \
        torch_params["down"][1]["blocks"][0]["attn"]["qkv"]["w"]


@pytest.mark.parametrize("ratio", [0.0, 0.44])
def test_apply_unet_matches_jax(jax_params, torch_params, ratio):
    x = _xt(1, 2)
    t = np.array([3, 97], np.int32)
    jmasks = None if ratio == 0 else \
        jax_masks_for_ratio(jax_params, JCFG, ratio)
    # the host masks specialize the trace: a program of its own
    fwd = _jax_forward if jmasks is None else jax.jit(
        lambda p, x_, t_: jax_apply_unet(p, JCFG, x_, t_, masks=jmasks),
        compiler_options=O0)
    want = fwd(jax_params, jnp.asarray(x), jnp.asarray(t))
    masks = None if jmasks is None else masks_from_jax(jmasks)
    got = apply_unet(torch_params, SMOKE_UNET, torch.from_numpy(x),
                     torch.from_numpy(t).long(), masks=masks)
    assert float(np.abs(np.asarray(want)).max()) > 0.1     # not degenerate
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("ratio", [0.3, 0.44, 0.9])
def test_masks_for_ratio_keeps_identical_sets(jax_params, torch_params,
                                              ratio):
    want = jax_masks_for_ratio(jax_params, JCFG, ratio)
    got = masks_for_ratio(torch_params, SMOKE_UNET, ratio)
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_unet_macs_match_jax(np_params, torch_params):
    masks = masks_for_ratio(torch_params, SMOKE_UNET, 0.44)
    assert unet_macs(torch_params, 16) == jax_unet_macs(np_params, 16)
    assert unet_macs(torch_params, 16, masks=masks) == \
        jax_unet_macs(np_params, 16, masks=masks)


def test_server_matches_jax_ddim_sample_mixed_depths(jax_params,
                                                     torch_params):
    """Three requests through two slots: the third is admitted while the
    second is mid-trajectory, so the batch mixes denoising depths."""
    xt = _xt(2, 3)
    server = DiffusionServer(torch_params, SMOKE_UNET, slots=2,
                             num_steps=STEPS, device="cpu")
    res = server.run([Request(rid=0, seed=0, x_init=xt[0]),
                      Request(rid=1, seed=1, x_init=xt[1])])
    assert sorted(res.images) == [0, 1]
    server.submit(Request(rid=2, seed=2, x_init=xt[2]))
    server.submit(Request(rid=3, seed=3, x_init=xt[0]))
    server.step()
    server.kill(3)
    server.submit(Request(rid=1, seed=1, x_init=xt[1]))
    out = {}
    while server.active_count():
        out.update(dict(server.step()))
    want = np.asarray(_jax_ddim(jax_params, jnp.asarray(xt)))
    for rid, img in [(0, res.images[0]), (1, res.images[1]), (2, out[2]),
                     (1, out[1])]:
        np.testing.assert_allclose(img, want[rid], atol=ATOL)


def test_ddim_sample_matches_jax(jax_params, torch_params):
    xt = _xt(3, 2)
    want = _jax_ddim(jax_params, jnp.asarray(xt))
    got = ddim_sample(lambda x, t: apply_unet(torch_params, SMOKE_UNET, x, t),
                      linear_schedule(SMOKE_UNET.diffusion_steps,
                                      device="cpu"),
                      xt.shape, num_steps=STEPS, x_init=torch.from_numpy(xt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_server_eta_pos_is_per_seed_and_slot_independent(torch_params):
    def serve(reqs, slots):
        s = DiffusionServer(torch_params, SMOKE_UNET, slots=slots,
                            num_steps=STEPS, eta=1.0, device="cpu")
        return s.run(reqs).images

    alone = serve([Request(rid=7, seed=42)], 2)
    crowded = serve([Request(rid=1, seed=1), Request(rid=2, seed=2),
                     Request(rid=7, seed=42)], 2)
    # the slot and its neighbours change only the GEMM row a sample takes:
    # equal up to CPU GEMM reduction order
    np.testing.assert_allclose(alone[7], crowded[7], atol=1e-5)
    np.testing.assert_array_equal(alone[7], serve([Request(rid=7, seed=42)],
                                                  2)[7])
    assert not np.array_equal(crowded[1], crowded[2])
    assert np.isfinite(crowded[1]).all()


def test_server_degrades_on_source_faults(torch_params):
    calls = iter([RuntimeError("queue down"), None,
                  Request(rid=0, seed=0)])

    def source():
        item = next(calls, StopIteration())
        if isinstance(item, BaseException):
            raise item
        return item

    server = DiffusionServer(torch_params, SMOKE_UNET, slots=1,
                             num_steps=1, device="cpu")
    res = server.run(source)
    assert list(res.images) == [0]
    assert any("queue down" in f for f in res.faults)


def test_checkpoints_cross_load(np_params, torch_params, tmp_path):
    meta = {"cfg": config_to_dict(SMOKE_UNET)}
    assert meta["cfg"] == jax_cfg_dict(JAX_SMOKE)
    jax_checkpoint.save(str(tmp_path / "j"), {"params": np_params}, meta)
    checkpoint.save(str(tmp_path / "t"), {"params": torch_params}, meta)
    with open(tmp_path / "j.manifest.json") as f:
        jm = json.load(f)
    with open(tmp_path / "t.manifest.json") as f:
        assert json.load(f) == jm
    for loader, path in [(checkpoint.load, "j"), (jax_checkpoint.load, "t")]:
        tree, got_meta = loader(str(tmp_path / path))
        assert got_meta == json.loads(json.dumps(meta))
        jax.tree.map(np.testing.assert_array_equal, tree["params"],
                     np_params)


def test_cli_serves_on_cpu(torch_params, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, {"params": torch_params},
                    {"cfg": config_to_dict(SMOKE_UNET)})
    out = serve_main(["--ckpt", ckpt, "--requests", "3", "--slots", "2",
                      "--steps", "2", "--prune-ratio", "0.44",
                      "--device", "cpu", "--out", str(tmp_path / "img"),
                      "--metrics", str(tmp_path / "m.json")])
    with open(tmp_path / "m.json") as f:
        m = json.load(f)
    assert m["schema"] == 1 and m["kind"] == "serve"
    assert m["images"] == out["images"] == 3
    assert m["macs_per_forward"] < m["dense_macs_per_forward"]
    imgs = sorted(os.listdir(tmp_path / "img"))
    assert imgs == ["req0.npy", "req1.npy", "req2.npy"]


def test_entry_points_refuse_missing_cuda(torch_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionServer(torch_params, SMOKE_UNET, slots=1)


def test_cifar10_param_tree_matches_jax():
    shapes = jax.eval_shape(lambda k: jax_init_unet(k, JAX_CIFAR),
                            jax.random.PRNGKey(0))
    gen = torch.Generator("cpu")
    gen.manual_seed(0)
    params = init_unet(CIFAR10_UNET, gen, device="cpu")
    got = jax.tree.map(lambda v: tuple(v.shape), params_to_jax(params))
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert got == want
    assert sum(v.numel() for v in state_dict(params).values()) == 35_746_307


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(n for n in sys.modules "
        "if n.startswith('repro_torch'))))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) > 20
    # LM training's and RWKV-6's modules among them
    assert {"repro_torch.launch.train", "repro_torch.launch.steps",
            "repro_torch.optim.sgd", "repro_torch.optim.schedules",
            "repro_torch.models.transformer",
            "repro_torch.kernels.rglru_scan.ops",
            "repro_torch.models.rwkv6",
            "repro_torch.kernels.wkv6.ops"} <= imported
