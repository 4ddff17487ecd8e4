#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

  python3 chip_smoke.py [--out DIR] [--profile]

Needs one CUDA card; imports neither JAX nor the JAX package.  Phases,
one JSON line each on stdout (every kernel case, with its error,
tolerance and times, goes to ``DIR/kernel_cases.jsonl``, default
``build/chip_smoke``):

1. device   the card's name and count, and nvidia-smi's name/power limit;
2. build    nvcc-builds the three kernels from ``src/repro_torch/kernels``;
3. serve    ``python -m repro_torch.serve`` on a full-width CIFAR10_UNET
            checkpoint with random weights at 1/sqrt(fan_in) scale (16
            requests, 8 slots, 10 steps), dense and at
            ``--prune-ratio 0.44``;
4. train    the port's ``FedPhD`` trains full-width CIFAR10_UNET in fp32
            (TF32 off): 320 synthetic CIFAR-10-like images, 2 classes
            per client over 4 clients, batch 32, 2 edges, 3 rounds
            (R_s = 2): round 1 sparse (Omega), round 2 plain on the dense
            model and pruned at 0.44 at its cloud aggregation, round 3
            on the compacted model; 24 local steps.  The data scale, the
            client count and the rounds are cut; widths and depth are not.
            The first step's time is given on its own; the step p50/p99
            and images/s are over the 23 steps after it, and a p50 is
            given for each round;
5. kernels  every kernel against its plain PyTorch version on the card at
            each shape the serving and training runs launched it with
            (the matmul's forward and backward-dx launches alike), plus
            masked cases (ratios 0 / 0.44 / 0.9, a fully masked N-block)
            and attention at hd=144, causal and windowed, in the dtype
            each ran (fp32, TF32 off) and in bf16 at the serving shapes
            and the largest training shapes, each with its tolerance and
            its time beside the plain version, the library call and the
            bound;
6. forward  one full-width U-Net forward through the kernels against the
            same forward through the plain versions (on CPU copies of the
            weights and inputs, so device dispatch picks them), dense and
            with 0.44 masks;
7. grad     one full-width loss and gradient at batch 4 with injected t
            and eps, through the kernels against the plain versions on
            CPU copies: the dense model with Omega, as in a sparse round,
            and the compacted model.  Every leaf is held to GRAD_TOL of
            the largest plain gradient, and every leaf of at least
            GRAD_LEAF_FLOOR of it also to GRAD_LEAF_TOL of its own;
8. profile  only with ``--profile``: the training run once more under
            ``torch.profiler``, its device time by kernel and category
            and the device's idle share; the training trace for work on
            the step's speed (the profiler's post-processing adds ~4 min).

Every kernel's counters (``.launches``, the per-shape ``.shapes`` and
the matmul's ``.dx_shapes``) are set to 0 just before each serving run
and the training run, and read just after it.

Then a ``{"kernels": [...]}`` line, nvidia-smi's line, and last
``{"ok": true, "device": {...}}``.  In the kernels line the main path is
the training run, the system's own path, which reaches all three
kernels: ``launches`` is its count, and ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are sums over its launches of each
shape's time (count x time per launch).  ``paths`` gives the same for
the dense and pruned serving runs and the training run, the matmul's
training launches also split into forward and dx.  Any failure exits
nonzero before the last line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-5, "bfloat16": 1e-2}             # x max|plain|
FORWARD_TOL = 1e-4                                    # x max|plain|
# x the largest |plain| gradient of any leaf: the gradients of the
# biases feeding a GroupNorm are differences of near-equal sums (zero in
# exact arithmetic for the last block's), so a leaf's own max is no scale
GRAD_TOL = 1e-4
# x the leaf's own max|plain|, for every leaf whose max|plain| is at least
# GRAD_LEAF_FLOOR x the largest (measured worst 3.7e-6 on an H100)
GRAD_LEAF_TOL = 1e-4
GRAD_LEAF_FLOOR = 1e-2
SERVE_PATHS = (("dense", []), ("pruned", ["--prune-ratio", "0.44"]))
PATHS = ("dense", "pruned", "train")
MAIN_PATH = "train"
TRAIN_BATCH = 32
GRAD_BATCH = 4
TPU_KERNELS = {
    "block_masked_matmul":
        "src/repro/kernels/block_masked_matmul/block_masked_matmul.py:43",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:74",
    "group_l2_norms": "src/repro/kernels/group_l2_norms/group_l2_norms.py:19",
}
SOURCES = {
    "block_masked_matmul": "src/repro_torch/kernels/block_masked_matmul/"
                           "csrc/block_masked_matmul.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
    "group_l2_norms": "src/repro_torch/kernels/group_l2_norms/csrc/"
                      "group_l2_norms.cu",
}
TIMES = ("ms", "plain_ms", "library_ms", "bound_ms")


class Failed(Exception):
    pass


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def time_ms(fn, iters: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def randomize(tree, gen):
    """Non-degenerate weights: the reference init puts conv2, proj and
    conv_out at 1e-6, which would make any parity check pass."""
    import torch
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                r = torch.randn(v.shape, generator=gen, device=v.device)
                if k == "w":
                    fan_in = v[..., 0].numel()
                    out[k] = r / fan_in ** 0.5
                elif k == "scale":
                    out[k] = 1.0 + 0.1 * r
                else:
                    out[k] = 0.1 * r
            else:
                out[k] = randomize(v, gen)
        return out
    return [randomize(v, gen) for v in tree]


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 5: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_matmul(cases, gen, dev, log):
    """cases: ((M, K, N), ratio or None, dtype, tally key or None)."""
    import torch
    from repro_torch.kernels.block_masked_matmul import ops as bmm
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (M, K, N), ratio, dtype_name, key in cases:
        dt = getattr(torch, dtype_name)
        x = torch.randn(M, K, generator=gen, device=dev).to(dt)
        w = (torch.randn(K, N, generator=gen, device=dev)
             / K ** 0.5).to(dt)
        cm = rm = None
        if ratio is not None:
            cm = (torch.rand(N, generator=gen, device=dev) >= ratio).float()
            rm = (torch.rand(K, generator=gen, device=dev)
                  >= ratio / 2).float()
        got = bmm.block_masked_matmul(x, w, cm, rm)
        want = bmm.block_masked_matmul_plain(x, w, cm, rm)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        tol = TOL[dtype_name] * scale
        wmask = w if ratio is None else \
            (w * cm[None, :].to(dt) * rm[:, None].to(dt))
        kk = K if rm is None else int(rm.sum())
        nn = N if cm is None else int(cm.sum())
        elt = x.element_size()
        nbytes = (M * K + K * N + M * N) * elt \
            + (0 if ratio is None else 4 * (K + N))
        b_ms, b_by = bound_ms(2.0 * M * kk * nn, nbytes, dtype_name)
        row = {"kernel": "block_masked_matmul", "key": key, "M": M, "K": K,
               "N": N, "ratio": ratio, "dtype": dtype_name,
               "max_abs_err": err, "tol": tol,
               "ms": time_ms(lambda: bmm.block_masked_matmul(x, w, cm, rm)),
               "plain_ms": time_ms(
                   lambda: bmm.block_masked_matmul_plain(x, w, cm, rm)),
               "library_ms": time_ms(lambda: torch.matmul(x, wmask)),
               "bound_ms": b_ms, "bound_by": b_by}
        log(row)
        require(err <= tol, f"block_masked_matmul {M}x{K}x{N} {dtype_name} "
                            f"ratio={ratio}: err {err} > tol {tol}")
        worst[dtype_name] = max(worst[dtype_name], err)
    # a fully masked N-block writes exact zeros (tests/test_kernels.py:38)
    x = torch.randn(128, 128, generator=gen, device=dev)
    w = torch.randn(128, 256, generator=gen, device=dev)
    cm = torch.cat([torch.zeros(128, device=dev), torch.ones(128, device=dev)])
    y = bmm.block_masked_matmul(x, w, cm, torch.ones(128, device=dev))
    torch.cuda.synchronize()
    zero = float(y[:, :128].abs().max())
    live = float(y[:, 128:].abs().max())
    log({"kernel": "block_masked_matmul", "case": "masked N-block",
         "masked_max": zero, "live_max": live})
    require(zero == 0.0 and live > 0.0,
            f"masked N-block: max {zero} (want exactly 0), live {live}")
    return worst


def check_attention(cases, gen, dev, log):
    """cases: ((BH, Sq, Skv, hd), causal, window, dtype, tally key)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (BH, Sq, Skv, hd), causal, window, dtype_name, key in cases:
        dt = getattr(torch, dtype_name)
        q = torch.randn(BH, Sq, hd, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(BH, Skv, hd, generator=gen, device=dev).to(dt)
                for _ in range(2))
        got = fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[dtype_name] * max(1.0, float(want.float().abs().max()))
        mask = None
        pairs = Sq * Skv
        if window > 0 or causal:
            qp = torch.arange(Sq, device=dev)[:, None]
            kp = torch.arange(Skv, device=dev)[None, :]
            mask = torch.ones(Sq, Skv, dtype=torch.bool, device=dev)
            if causal:
                mask &= kp <= qp
            if window > 0:
                mask &= (qp - kp) < window
            pairs = int(mask.sum())
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        b_ms, b_by = bound_ms(4.0 * BH * pairs * hd,
                              BH * (2 * Sq + 2 * Skv) * hd * q.element_size(),
                              dtype_name)
        row = {"kernel": "flash_attention", "key": key, "BH": BH, "S": Sq,
               "Skv": Skv, "hd": hd, "causal": causal, "window": window,
               "dtype": dtype_name, "max_abs_err": err, "tol": tol,
               "ms": time_ms(lambda: fa.flash_attention_bhsd(
                   q, k, v, causal=causal, window=window)),
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                   q, k, v, causal=causal, window=window)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=mask)),
               "bound_ms": b_ms, "bound_by": b_by}
        log(row)
        require(err <= tol, f"flash_attention {(BH, Sq, Skv, hd)} "
                            f"causal={causal} window={window} {dtype_name}: "
                            f"err {err} > tol {tol}")
        worst[dtype_name] = max(worst[dtype_name], err)
    return worst


def check_group_l2(shapes, gen, dev, log):
    """shapes: the (K, N, G) tally keys of the pruned run."""
    import torch
    from repro_torch.kernels.group_l2_norms import ops as gl2
    worst = 0.0
    for K, N, G in shapes:
        w = torch.randn(K, N, generator=gen, device=dev)
        a = gl2.group_l2_norms(w, G)
        b = gl2.group_l2_norms(w, G)
        want = gl2.group_l2_norms_plain(w, G)
        torch.cuda.synchronize()
        err = float((a - want).abs().max())
        tol = TOL["float32"] * float(want.abs().max())
        b_ms, b_by = bound_ms(2.0 * K * N, 4 * (K * N + G), "float32")
        w3 = w.view(K, G, N // G)
        row = {"kernel": "group_l2_norms", "key": (K, N, G), "K": K, "N": N,
               "G": G, "dtype": "float32", "max_abs_err": err,
               "tol": tol, "deterministic": bool(torch.equal(a, b)),
               "ms": time_ms(lambda: gl2.group_l2_norms(w, G)),
               "plain_ms": time_ms(lambda: gl2.group_l2_norms_plain(w, G)),
               "library_ms": time_ms(
                   lambda: torch.einsum("kgc,kgc->g", w3, w3)),
               "bound_ms": b_ms, "bound_by": b_by}
        log(row)
        require(err <= tol, f"group_l2_norms {(K, N)}: err {err} > {tol}")
        require(row["deterministic"], f"group_l2_norms {(K, N)} differs "
                                      f"between two runs")
        worst = max(worst, err)
    return worst


def path_totals(rows, tally):
    """One run's launches and count x time per launch, summed over the
    shapes ``tally`` (tally key -> launches in that run) records."""
    by_key = {r["key"]: r for r in rows if r.get("key") is not None}
    out = {"launches": sum(tally.values()), **{k: 0.0 for k in TIMES}}
    by = {"bytes": 0.0, "operations": 0.0}
    for key, n in tally.items():
        r = by_key[key]
        for k in TIMES:
            out[k] += n * r[k]
        by[r["bound_by"]] += n * r["bound_ms"]
    out["bound_by"] = max(by, key=by.get) if tally else None
    return out


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def make_trainer(cfg, dev):
    """The port's FedPhD on 320 synthetic CIFAR-10-like images: 4
    clients holding 2 classes each, batch 32, 2 edges, 3 rounds with
    R_s = 2 (round 1 sparse, the prune at round 2's cloud aggregation)."""
    from repro_torch.configs import FLConfig
    from repro_torch.core.hfl import FedPhD
    from repro_torch.data import (CIFAR10_LIKE, ClientData, make_dataset,
                                  shards_per_client)
    from repro_torch.fl.client import Client

    ds = dataclasses.replace(CIFAR10_LIKE, samples_per_class=32)
    images, labels = make_dataset(ds, seed=0)
    parts = shards_per_client(labels, 4, 2, seed=0)
    # wired as the reference's experiment/data.py:make_clients wires them
    clients = [Client(i, ClientData(images[p], labels[p],
                                    batch_size=TRAIN_BATCH, seed=i),
                      ds.num_classes) for i, p in enumerate(parts)]
    fl = FLConfig(num_clients=4, num_edges=2, participation=1.0,
                  local_epochs=1, edge_agg_every=1, cloud_agg_every=1,
                  rounds=3, sparse_rounds=2, prune_ratio=0.44)
    return FedPhD(cfg.replace(precision="fp32"), fl, clients, device=dev)


def train_phase(cfg, dev, counters, zero_counters):
    """Full-width FedPhD through sparse -> prune -> plain; returns the
    run's tallies: kernel -> {shape key: launches}, plus the matmul's
    dx launches under "block_masked_matmul_dx"."""
    import numpy as np
    import torch

    trainer = make_trainer(cfg, dev)
    bmm = counters["block_masked_matmul"]
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    t0 = time.perf_counter()
    ends = [0]                           # step count at each round's end
    for r in (1, 2, 3):                  # sparse; plain, pruned; compacted
        hist, _ = trainer.run(r)
        ends.append(len(trainer.step_seconds))
        if r == 1:
            omega_l2 = counters["group_l2_norms"].launches
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = {k: dict(fn.shapes) for k, fn in counters.items()}
    tally["block_masked_matmul_dx"] = dict(bmm.dx_shapes)
    steps = np.asarray(trainer.step_seconds)
    # the first step pays one-off start-up costs; the rates are taken
    # over the steps after it
    steady = steps[1:]
    dx = sum(tally["block_masked_matmul_dx"].values())
    hds = sorted({key[3] for key in tally["flash_attention"]})
    for rec in hist:
        emit("train", round=rec.round, loss=rec.loss, comm_gb=rec.comm_gb,
             comm_up_gb=rec.comm_up_gb, comm_down_gb=rec.comm_down_gb,
             params_m=rec.params_m, pruned=rec.pruned,
             selected=rec.selected)
    emit("train", run="summary", model=cfg.name, precision="fp32",
         cut="data 320 images (32 per class), 4 clients, 3 rounds; "
             "full width and depth",
         steps=len(steps), batch=TRAIN_BATCH, wall_s=wall,
         first_step_ms=float(steps[0] * 1e3), steady_steps=len(steady),
         p50_step_ms=float(np.percentile(steady, 50) * 1e3),
         p99_step_ms=float(np.percentile(steady, 99) * 1e3),
         images_per_s=float(TRAIN_BATCH * len(steady) / steady.sum()),
         p50_step_ms_by_round=[
             float(np.percentile(steps[max(a, 1):b], 50) * 1e3)
             for a, b in zip(ends, ends[1:])],
         step_ms=[float(x * 1e3) for x in steps],
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
         launches=launches, matmul_fwd=launches["block_masked_matmul"] - dx,
         matmul_dx=dx, attention_hd=hds, group_l2_in_round1=omega_l2,
         prune_report_kept=sum(k for k, _ in
                               trainer.prune_report.values()))
    require(len(hist) == 3 and len(steps) == 24,
            f"train: {len(hist)} rounds, {len(steps)} steps (want 3, 24)")
    require(all(np.isfinite(r.loss) for r in hist),
            f"train: a loss is not finite: {[r.loss for r in hist]}")
    require(hist[1].params_m < hist[0].params_m and hist[1].pruned
            and hist[2].params_m == hist[1].params_m,
            f"train: params_m did not fall at the prune round: "
            f"{[(r.params_m, r.pruned) for r in hist]}")
    require(launches["block_masked_matmul"] - dx > 0 and dx > 0,
            f"train: matmul forward/dx launches {launches} / {dx}")
    require(256 in hds and 144 in hds,
            f"train: attention head dims {hds}, want 256 and 144")
    require(omega_l2 > 0, "train: no group-L2 launch inside Omega in "
                          "round 1")
    require(all(sum(t.values()) == launches[k] for k, t in tally.items()
                if k in launches),
            f"train: per-shape tallies do not add up to {launches}")
    return tally


# kernel-name fragments -> category, for the profile's device-time split
PROFILE_CATEGORIES = (("block_masked_matmul", ("bmm_kernel",)),
                      ("flash_attention", ("flash_kernel",)),
                      ("group_l2_norms", ("col_partials", "group_sums")),
                      ("library_gemm", ("gemm", "gemv")))


def profile_phase(cfg, dev, out_dir):
    """``--profile``: a second, identical training run under
    ``torch.profiler``.  Emits the device time by category and by kernel
    name, and the device's busy share of the run (the union of kernel
    intervals over the run's wall time).  The profiler's own host cost
    inflates the wall time, so the idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer = make_trainer(cfg, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                   # union of the kernel intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        cat = next((c for c, frags in PROFILE_CATEGORIES
                    if any(f in e.name.lower() for f in frags)), "other")
        n, t = by_cat.get(cat, (0, 0.0))
        by_cat[cat] = (n + 1, t + us)
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    with open(os.path.join(out_dir, "train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    emit("profile", run="train, profiled", wall_s=wall,
         steps=len(trainer.step_seconds), device_kernels=len(kernels),
         device_busy_s=busy_us / 1e6,
         device_idle_share=1.0 - busy_us / 1e6 / wall,
         device_ms_by_category={c: {"launches": n, "ms": t / 1e3}
                                for c, (n, t) in by_cat.items()},
         top_kernels=[{"name": k[:80], "launches": n, "ms": t / 1e3}
                      for k, (n, t) in top])
    require(kernels, "profile: the profiler recorded no device kernel")


# ---------------------------------------------------------------------------
# phase 7: one loss and gradient, kernels against plain versions
# ---------------------------------------------------------------------------

def grad_phase(cfg, rparams, gen, dev, counters):
    import torch
    from repro_torch.configs import FLConfig
    from repro_torch.core.pruning import (compact, depth_lambdas, l2_scores,
                                          make_masks, omega, unet_groups)
    from repro_torch.diffusion import ddpm_loss, linear_schedule
    from repro_torch.models.unet import apply_unet
    from repro_torch.tree import tree_leaves

    cpu = torch.device("cpu")
    img = (GRAD_BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)
    x0 = torch.rand(img, generator=gen, device=dev) * 2 - 1
    t = torch.randint(0, cfg.diffusion_steps, (GRAD_BATCH,), generator=gen,
                      device=dev)
    eps = torch.randn(img, generator=gen, device=dev)
    groups = unet_groups(cfg, rparams)
    masks = make_masks(l2_scores(rparams, groups), groups, 0.44)
    small, _, _ = compact(rparams, cfg, groups, masks)

    def loss_and_grads(params, device, omega_groups):
        params = to_device(params, device)
        leaves = tree_leaves(params)
        for v in leaves:
            v.requires_grad_()
        sched = linear_schedule(cfg.diffusion_steps, device=device)
        loss = ddpm_loss(lambda x, tt: apply_unet(params, cfg, x, tt), sched,
                         x0.to(device), t=t.to(device), eps=eps.to(device))
        if omega_groups is not None:
            lam = depth_lambdas(omega_groups, FLConfig().lambda0)
            loss = loss + omega(params, omega_groups, lam)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.detach().to(cpu) for g in grads]

    for label, params, og in (("dense + omega", rparams, groups),
                              ("compacted 0.44", small, None)):
        before = {k: fn.launches for k, fn in counters.items()}
        loss, grads = loss_and_grads(params, dev, og)
        torch.cuda.synchronize()
        ran = {k: fn.launches - before[k] for k, fn in counters.items()}
        want_loss, want = loss_and_grads(params, cpu, og)
        after = {k: fn.launches for k, fn in counters.items()}
        scale = max(float(g.abs().max()) for g in want)
        errs = [float((a - b).abs().max()) for a, b in zip(grads, want)]
        rel = [e / float(b.abs().max()) for e, b in zip(errs, want)
               if float(b.abs().max()) >= GRAD_LEAF_FLOOR * scale]
        emit("grad", model=label, batch=GRAD_BATCH, loss=loss,
             loss_plain=want_loss, loss_err=abs(loss - want_loss),
             leaves=len(want), max_abs_grad_plain=scale,
             max_abs_grad_err=max(errs), tol=GRAD_TOL * scale,
             leaves_held_alone=len(rel), worst_leaf_rel_err=max(rel),
             leaf_tol_rel=GRAD_LEAF_TOL, kernel_launches=ran)
        need = ["block_masked_matmul", "flash_attention"] \
            + (["group_l2_norms"] if og is not None else [])
        require(all(ran[k] > 0 for k in need),
                f"grad {label}: the card's pass skipped a kernel: {ran}")
        require(after == {k: before[k] + ran[k] for k in before},
                f"grad {label}: the plain pass launched a kernel")
        require(abs(loss - want_loss) <= FORWARD_TOL * abs(want_loss),
                f"grad {label}: loss {loss} vs plain {want_loss}")
        require(max(errs) <= GRAD_TOL * scale and scale > 0,
                f"grad {label}: gradient err {max(errs)} > "
                f"{GRAD_TOL} x {scale}")
        require(max(rel) <= GRAD_LEAF_TOL,
                f"grad {label}: a leaf's gradient is {max(rel)} of its own "
                f"max|plain| (limit {GRAD_LEAF_TOL})")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def run(out_dir: str, profile: bool = False) -> dict:
    import numpy as np
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise Failed("torch.cuda.is_available() is false: this run needs "
                     "an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", **device, nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # -- 2. build ------------------------------------------------------------
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    emit("build", seconds=time.perf_counter() - t0,
         compiled=build.build_seconds is not None, library=str(lib_path))

    from repro_torch import checkpoint
    from repro_torch.configs import CIFAR10_UNET
    from repro_torch.configs.base import config_to_dict
    from repro_torch.kernels.block_masked_matmul import ops as bmm
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.group_l2_norms import ops as gl2
    from repro_torch.models.unet import apply_unet, init_unet
    from repro_torch.serve import __main__ as serve_cli
    from repro_torch.serve.artifact import masks_for_ratio

    cfg = CIFAR10_UNET
    slots = 8
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    rparams = randomize(init_unet(cfg, gen, device=dev), gen)
    counters = {"block_masked_matmul": bmm.block_masked_matmul,
                "flash_attention": fa.flash_attention_bhsd,
                "group_l2_norms": gl2.group_l2_norms}

    def zero_counters():
        for fn in counters.values():
            fn.launches = 0
            fn.shapes.clear()
        bmm.block_masked_matmul.dx_shapes.clear()

    # -- 3. serving: the CLI, dense and at ratio 0.44 ------------------------
    tallies = {}                  # path -> kernel -> {shape key: launches}
    img_shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        checkpoint.save(ckpt, {"params": rparams},
                        {"cfg": config_to_dict(cfg)})
        for name, extra in SERVE_PATHS:
            img_dir = os.path.join(tmp, name)
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counters()
            m = serve_cli.main(["--ckpt", ckpt, "--requests", "16",
                                "--slots", str(slots), "--steps", "10",
                                "--out", img_dir, *extra])
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
            tallies[name] = {k: dict(fn.shapes) for k, fn in counters.items()}
            imgs = [np.load(os.path.join(img_dir, f))
                    for f in sorted(os.listdir(img_dir))]
            finite = sum(bool(np.isfinite(i).all()) and i.shape == img_shape
                         for i in imgs)
            emit("serve", run=name, images=m["images"], finite_images=finite,
                 requests_per_s=m["requests_per_s"],
                 p50_step_ms=m["p50_step_ms"], p99_step_ms=m["p99_step_ms"],
                 macs_per_forward=m["macs_per_forward"],
                 peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                 launches=launches)
            require(m["images"] == 16 and finite == 16,
                    f"{name}: {finite}/16 finite images")
            require(all(sum(t.values()) == launches[k]
                        for k, t in tallies[name].items()),
                    f"{name}: per-shape tallies do not add up to the "
                    f"launch counts {launches}")
            require(launches["block_masked_matmul"] > 0
                    and launches["flash_attention"] > 0,
                    f"{name}: a kernel was not launched: {launches}")
            require(not bmm.block_masked_matmul.dx_shapes,
                    f"{name}: serving launched a backward dx")

    # -- 4. the main path: training ------------------------------------------
    tallies["train"] = train_phase(cfg, dev, counters, zero_counters)
    require(all(sum(tallies[MAIN_PATH][k].values()) > 0 for k in counters),
            f"the {MAIN_PATH} run left a kernel unlaunched")

    # -- 5. kernels vs plain, at the shapes the runs launched ----------------
    def launched(kernel, paths=PATHS):
        keys = set()
        for p in paths:
            keys |= set(tallies[p][kernel])
        return sorted(keys)

    os.makedirs(out_dir, exist_ok=True)
    case_log = open(os.path.join(out_dir, "kernel_cases.jsonl"), "w")
    rows = []

    def log(row):                 # one line per case, to the log only
        if row.get("key") is not None:
            row["launches"] = {p: tallies[p][row["kernel"]].get(row["key"], 0)
                               for p in PATHS}
            if row["kernel"] == "block_masked_matmul":
                row["launches"]["train_dx"] = \
                    tallies["train"]["block_masked_matmul_dx"].get(
                        row["key"], 0)
        rows.append(row)
        case_log.write(json.dumps(row) + "\n")

    def other(dt):
        return "bfloat16" if dt == "float32" else "float32"

    try:
        mm_keys = launched("block_masked_matmul")
        serve_mm = set(launched("block_masked_matmul", ("dense", "pruned")))
        largest = sorted(set(tallies["train"]["block_masked_matmul"])
                         - serve_mm, key=lambda k: -k[0] * k[1] * k[2])[:4]
        cases = []
        for key in mm_keys:
            M, K, N, masked, dt = key
            ratio = 0.44 if masked else None
            cases.append(((M, K, N), ratio, dt, key))
            # serving shapes in the other dtype too; training shapes at
            # the largest few
            if key in serve_mm or key in largest:
                cases.append(((M, K, N), ratio, other(dt), None))
        for shape in [(8, 27, 3), (8192, 1152, 128), (2048, 2304, 256),
                      (512, 4608, 256)]:
            for dt in ("float32", "bfloat16"):
                for ratio in (0.0, 0.44, 0.9):
                    cases.append((shape, ratio, dt, None))
        mm_err = check_matmul(cases, gen, dev, log)
        emit("kernels", kernel="block_masked_matmul",
             launched_shapes=len(mm_keys),
             train_dx_shapes=len(tallies["train"]["block_masked_matmul_dx"]),
             cases=len(cases), max_abs_err=mm_err, tol_rel=TOL)

        att_keys = launched("flash_attention")
        att_cases = []
        for key in att_keys:
            BH, Sq, Skv, hd, causal, window, dt = key
            att_cases += [((BH, Sq, Skv, hd), causal, window, dt, key),
                          ((BH, Sq, Skv, hd), causal, window, other(dt),
                           None)]
        for dt in ("float32", "bfloat16"):
            att_cases += [((slots, 256, 256, 256), True, 0, dt, None),
                          ((slots, 256, 256, 256), False, 64, dt, None),
                          ((slots, 200, 200, 256), True, 48, dt, None)]
        att_err = check_attention(att_cases, gen, dev, log)
        emit("kernels", kernel="flash_attention",
             launched_shapes=len(att_keys), cases=len(att_cases),
             max_abs_err=att_err, tol_rel=TOL)

        l2_keys = launched("group_l2_norms")
        l2_err = check_group_l2(l2_keys, gen, dev, log)
        emit("kernels", kernel="group_l2_norms", launched_shapes=len(l2_keys),
             max_abs_err=l2_err, tol_rel=TOL["float32"])
    finally:
        case_log.close()

    # -- 6. full-width forward: kernels vs plain versions --------------------
    # The plain forward runs on CPU copies: device dispatch picks the plain
    # versions, and no kernel can launch there.
    cpu = torch.device("cpu")
    cparams = to_device(rparams, cpu)
    masks44 = masks_for_ratio(rparams, cfg, 0.44)
    x = torch.randn(slots, *img_shape, generator=gen, device=dev)
    t = torch.randint(0, cfg.diffusion_steps, (slots,), generator=gen,
                      device=dev)
    for label, masks in (("dense", None), ("masked 0.44", masks44)):
        before = {k: fn.launches for k, fn in counters.items()}
        got = apply_unet(rparams, cfg, x, t, masks=masks)
        torch.cuda.synchronize()
        ran = {k: fn.launches - before[k] for k, fn in counters.items()}
        want = apply_unet(cparams, cfg, x.to(cpu), t.to(cpu), masks=masks)
        after = {k: fn.launches for k, fn in counters.items()}
        err = float((got.to(cpu) - want).abs().max())
        scale = float(want.abs().max())
        emit("forward", masks=label, max_abs_err=err, max_abs_plain=scale,
             tol=FORWARD_TOL * scale, finite=bool(torch.isfinite(got).all()),
             kernel_launches=ran)
        require(ran["block_masked_matmul"] > 0
                and ran["flash_attention"] > 0,
                f"forward {label}: the card's forward skipped a kernel: {ran}")
        require(after == {k: before[k] + ran[k] for k in before},
                f"forward {label}: the plain forward launched a kernel")
        require(bool(torch.isfinite(got).all()) and scale > 1e-3
                and err <= FORWARD_TOL * scale,
                f"forward {label}: err {err} vs plain max {scale}")
    del cparams

    # -- 7. one loss and gradient: kernels vs plain versions -----------------
    grad_phase(cfg, rparams, gen, dev, counters)
    if profile:
        profile_phase(cfg, dev, out_dir)

    kernels = []
    errs = {"block_masked_matmul": mm_err["float32"],
            "flash_attention": att_err["float32"],
            "group_l2_norms": l2_err}
    for name, err in errs.items():
        paths = {p: path_totals(rows, tallies[p][name]) for p in PATHS}
        if name == "block_masked_matmul":
            dx = tallies["train"]["block_masked_matmul_dx"]
            fwd = {k: n - dx.get(k, 0)
                   for k, n in tallies["train"][name].items()}
            paths["train"]["fwd"] = path_totals(
                rows, {k: n for k, n in fwd.items() if n})
            paths["train"]["dx"] = path_totals(rows, dx)
        main = paths[MAIN_PATH]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name],
                        "replaces": TPU_KERNELS[name],
                        "launches": main["launches"], "max_abs_err": err,
                        **{k: main[k] for k in TIMES},
                        "bound_by": main["bound_by"],
                        "main_path": MAIN_PATH, "paths": paths})
    require("jax" not in sys.modules and "repro" not in sys.modules,
            "JAX or the JAX package was imported")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    return device


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "chip_smoke"),
                    help="directory for the per-case kernel log")
    ap.add_argument("--profile", action="store_true",
                    help="also run the training path once more under "
                         "torch.profiler (device time by kernel, idle "
                         "share; the table goes to DIR/train_profile.txt)")
    args = ap.parse_args()
    try:
        device = run(args.out, profile=args.profile)
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
