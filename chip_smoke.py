#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

  python3 chip_smoke.py [--out DIR] [--profile]

Needs one CUDA card; imports neither JAX nor the JAX package.  Phases,
one JSON line each on stdout (every kernel case, with its error,
tolerance and times, goes to ``DIR/kernel_cases.jsonl``, default
``build/chip_smoke``):

1. device   the card's name and count, and nvidia-smi's name/power limit;
2. build    nvcc-builds the kernels from ``src/repro_torch/kernels`` (its
            seconds, and each kernel's registers and spills from
            ``-Xptxas=-v``, the whole report in ``DIR/ptxas.txt``);
3. serve    ``python -m repro_torch.serve`` on a full-width CIFAR10_UNET
            checkpoint with random weights at 1/sqrt(fan_in) scale (16
            requests, 8 slots, 10 steps), dense and at
            ``--prune-ratio 0.44``;
4. train    the port's ``FedPhD`` trains full-width CIFAR10_UNET in fp32
            (TF32 off): 320 synthetic CIFAR-10-like images, 2 classes
            per client over 4 clients, batch 32, 2 edges, 3 rounds
            (R_s = 2): round 1 sparse (Omega), round 2 plain on the dense
            model and pruned at 0.44 at its cloud aggregation, round 3
            on the compacted model; 24 local client steps.  The data
            scale, the client count and the rounds are cut; widths and
            depth are not.  It trains on each engine, two runs a side
            in turns (sequential, vectorized, ...), fresh clients from
            the same seeds each run: the first pair here, the other
            after phase 8, so that the kernels are timed after the same
            work as before the vectorized engine existed.  The first
            sequential run keeps the
            sequential engine's checks and summary (the first step's
            time on its own; step p50/p99 and images/s over the 23
            steps after it; a p50 for each round).  The first
            vectorized run (6 batched steps of the 4 clients) must match
            it: the same selections, bitwise bytes, params_m and prune
            report, each round's loss within TRAIN_LOSS_RTOL, the final
            params within TRAIN_PARAMS_ATOL with TRAIN_PARAMS_BULK of
            them within 1e-5, and launch exactly VECTORIZED_LAUNCHES,
            every matmul over the 4 clients.  Each engine's local
            seconds a round (host clock ending in the round's loss
            syncs), images/s, peak memory and launches a step are given
            as medians over its runs.  After those runs, the vectorized
            engine's peak memory for one sparse step at C = 4, 8, 10, 12,
            16, 20 clients, up to the first C that does not fit;
4b. train_bf16  the first vectorized run again at ``precision="bf16"``
            (the params cast to bf16 inside the loss): finite losses,
            each round's within BF16_LOSS_ATOL of the fp32 run's, the
            downloads exactly half its, the same launch counts with
            every matmul, attention and group-L2 launch in bf16 (phase 8
            holds each of those shapes against its plain version), peak
            memory and images/s beside the fp32 run's;
5. lm_prefill  the full 38-layer recurrentgemma-9b in bf16 with random
            weights from the port's init, ``build_prefill_step`` on
            B = 2, S = 4096 token ids from a numpy seed: one warm-up and
            3 timed prefills; 26 scan and 12 attention launches each;
6. lm_serve ``serve_requests`` on the same model: 8 slots, 16 requests of
            32 tokens, cache_len 4096 (decode is plain tensor ops, as the
            reference's: no kernel launches);
6b. lm_prune  LM pruning on the same model (before it is freed):
            ``build_groups`` (LM_PRUNE_GROUPS: 3 pattern positions over
            12 stacked cycles and the 2 unstacked tail layers),
            ``l2_scores`` timed (one warm-up and LM_TIMED runs, exactly
            one group-L2 forward launch each, over the tail's 30 tensors,
            and no other kernel: the stacked cycles are plain ops),
            ``make_masks`` at LM_PRUNE_RATIO and ``compact`` timed (no
            launch, every leaf's dtype kept); the pruned config must be
            LM_PRUNED, what ``kept_count`` gives (d_ff 12288 -> 6912,
            lru_width 4096 -> 2304, the one KV head), and its tree must
            hold ``count_params_analytic``'s count; then one warm-up and
            LM_TIMED prefills of the pruned model at B = 2, S = 4096:
            26 scans at W = 2304 and 12 attentions each, no U-Net
            kernel; its median beside the dense one's, tokens/s, peak;
7. lm_consistency  recurrentgemma-9b at depth 5 (one cycle plus the
            two-layer tail), full width, fp32: the last position's
            prefill logits (scan and windowed attention kernels) against
            the decode logits after the same 2304 tokens one by one
            (plain ``rglru_decode`` and ring-buffer ``attend``), within
            LM_TOL of max|logit|; 2304 is past the 2048 window.  Then
            pruning on the same weights: the prefill logits of
            ``apply_masks(params)`` against the compacted model's,
            within LM_TOL of max|logit| (one group-L2 launch for the
            scores), and Omega with its gradient in every member leaf
            (one group-L2 forward and one backward launch) against the
            plain route on CPU copies of the layers: Omega within
            TOL["float32"], each leaf within GRAD_TOL of its largest;
7h. lm_train  ``build_opt_init`` and ``build_train_step`` on full-width
            recurrentgemma-9b cut to LM_TRAIN_DEPTH = 3 layers (one rec,
            rec, local-attention cycle, 2,753,654,784 params): bf16
            params from ``model.init`` over an fp32 master, fp32
            moments, remat on, B = 1, S = 4096 (past the 2048 window),
            token ids from a numpy seed with the labels shifted by one;
            one warm-up and LM_TIMED timed steps on the same batch:
            finite losses, the last below the first, exactly 4 scan, 2
            scan-backward and 2 attention launches a step (remat
            recomputes the cycle), no U-Net kernel, every bf16 param
            its master's cast bitwise, the peak below the card's
            memory; step p50, tokens/s, peak, and the resident state
            beside 14 B a param (16 with the step's grads);
            ``lm_train_cli`` then runs ``python -m
            repro_torch.launch.train --arch recurrentgemma-9b --steps 3
            --ckpt`` on the card and loads the checkpoint back;
7i. lm_grad one loss and gradient of the same model in fp32 (TF32 off)
            at S = LM_GRAD_SEQ through the kernels and through the plain
            versions on CPU copies, every leaf within GRAD_TOL of the
            largest plain gradient and each leaf within GRAD_LEAF_TOL
            of its own largest, with the host's memory;
7j. moe_prefill  the full 48-layer moonshot-v1-16b-a3b (28.4e9 params,
            64 experts top-6, 2 shared, one dense head layer) in bf16
            with random weights from the port's init, B = 2, S = 4096:
            one warm-up and LM_TIMED timed prefills, exactly 48 attention
            launches each at (BH 32, S 4096, hd 128, causal, bf16), the
            pairs the capacity dropped, the analytic params and
            MODEL_FLOPS (``metrics/flops.py``);
7k. moe_serve  ``serve_requests`` on the same model with LM_SERVE (the
            loop decodes in place: weights and one KV cache, ~69.7e9 B);
7l. moe_consistency  moonshot, qwen3-moe-235b-a22b (GQA 64/4) and
            deepseek-v3-671b (MLA; 3 dense head layers and one MoE layer)
            at full width cut to 4 layers, fp32, one at a time: the
            prefill's last logits against decode after the same 8 tokens
            (no pair can drop at T <= 8), within LM_TOL, 0 pairs dropped;
            MLA attends in plain ops (prefill) and in the absorbed form
            (decode), as the reference does;
7m. moe_train  ``build_train_step`` on moonshot cut to 4 layers (the
            dense head layer and 3 MoE layers), bf16 over an fp32 master,
            remat, B = 1, S = 4096: finite falling losses, aux above 0,
            exactly 7 attention launches a step (the head once, each
            cycle twice), params their master's cast;
7n. dense_prefill  the full 40-layer command-r-35b (30.3e9 params,
            parallel attention and FFN blocks, GQA 64/8 at hd 128, tied
            256,000-token embedding) in bf16 with random weights from
            the port's init, B = 2, S = 4096: one warm-up and LM_TIMED
            timed prefills, exactly 40 attention launches each at
            (BH 128, S 4096, hd 128, causal, bf16), MODEL_FLOPS and
            model TFLOP/s (``metrics/flops.py``), the peak above the
            resident weights;
7o. dense_serve  ``serve_requests`` on the same model with LM_SERVE
            (weights, one 5.37e9 B KV cache and a one-slot fresh cache);
7p. dense_consistency  command-r, internlm2-20b and internvl2-76b at
            full width cut to 4 layers, gemma2-2b (soft-capped: no
            attention launch) and whisper-base (6 encoder and 6 decoder
            layers) whole, fp32, one at a time: the prefill's last
            logits against decode after the same positions, within
            DENSE_TOL; internvl2's 256 image positions hold the token
            embeddings of chosen ids, which decode feeds, and whisper's
            decode cache holds the prefill's encoder output;
7q. dense_train  ``build_train_step`` on the full 26-layer gemma2-2b
            (2,614,222,080 params), bf16 over an fp32 master, remat,
            B = 1, S = 4096: finite falling losses, 0 attention launches
            (the soft-capped route), params their master's cast;
7r. rwkv_prefill  the full 32-layer rwkv6-7b (7,576,621,056 params,
            64 WKV heads of 64, d_ff 14,336, 65,536-token vocab) in bf16
            with random weights from the port's init, B = 2, S = 4096:
            one warm-up and LM_TIMED timed prefills, exactly one WKV
            launch a layer at (2, 4096, 64, 64) and no other kernel,
            MODEL_FLOPS and model TFLOP/s, the peak above the weights;
7s. rwkv_serve  ``serve_requests`` on the same model with LM_SERVE:
            exactly one one-token WKV launch a layer and decode step (the
            state written in place), no other kernel;
7t. rwkv_consistency  rwkv6-7b at full width cut to 4 layers, fp32:
            the prefill's last logits on the exact route and on the
            chunked route (``wkv_chunk`` 64, plain ops, no launch)
            against decode after the same 256 tokens, within RWKV_TOL
            and RWKV_CHUNK_TOL of max|logit|;
7u. rwkv_train  ``build_train_step`` on rwkv6-7b cut to 8 layers, bf16
            over an fp32 master, remat, B = 1, S = 4096: finite falling
            losses, exactly 2 WKV forward launches (with remat's
            recompute) and one backward a layer and step, params their
            master's cast;
7b. experiment  ``repro_torch.experiment.runner.main`` in process with
            ``--preset paper --eval-every 1``: full-width CIFAR10_UNET,
            20 clients of 256 cifar10-like images (2 classes each), 2
            edges, batch 32, cut to EXPERIMENT_ROUNDS rounds (160 client
            steps a round, all sparse); the round's clients train on the
            vectorized engine in ``client_chunk``'s chunks, and the eval
            hook DDIM-samples 64 images in 10 steps for ``is_proxy``.
            Unbroken, then run for one round and resumed from its
            checkpoint: the chunk k, the estimate, the peak memory,
            seconds a round, images/s and each round's ``is_proxy``.
            Every training matmul launch must be at C = k, attention
            must run at the chunk's BH and the eval's 64, the resumed
            history's selections, bytes, params_m and eval keys must
            equal the unbroken run's, its losses within TRAIN_LOSS_RTOL
            and params within TRAIN_PARAMS_ATOL (and whether they are
            bitwise is reported).  One sparse step of two clients under
            ``torch.use_deterministic_algorithms(True)`` names the ops on
            the path with no deterministic CUDA kernel (a control,
            ``torch.histc``, must raise in that mode);
7c. baselines  the flat baselines (FedAvg, FedProx, MOON, SCAFFOLD,
            FedDiffuse) through the experiment API on the ``train``
            cell's data (4 clients of 2 classes, 32 images a class) and
            full-width CIFAR10_UNET in fp32 at batch 32: each method 2
            rounds on the vectorized engine (round 2 reading what round 1
            stored): finite losses, ``comm_gb`` equal to a count of the
            bytes its method sends, local seconds and images/s a round,
            peak memory, and exactly the matmul and attention launches
            of its forwards (MOON: 2 with a backward, and the global
            model's one-client forward over the chunk's images and the
            previous models' stacked one without); ``baselines_engines``
            one round of each on the sequential engine against the
            vectorized run's first (losses within TRAIN_LOSS_RTOL,
            params and method state within TRAIN_PARAMS_ATOL, SCAFFOLD's
            variates in parameter units, ``comm_gb`` identical);
            ``baselines_resume`` ``runner --method`` scaffold and moon
            killed after round 1 and resumed, bit for bit against the
            unbroken run (params, method stacks, losses); and
            ``centralized``, 8 steps of ``run_centralized`` with the EMA,
            which must equal the EMA recomputed here in fp32;
7d. faults  FAULT_SPEC (arrivals, dropouts, stragglers past a deadline,
            churn) on the ``train`` cell through the experiment API,
            experiment seed FAULT_SEED: FedPhD 3 rounds (sparse, the
            prune, compacted), and under FAULT_STALE (a deadline a fast
            client meets) ``fedphd-stale`` 3 and ``fedavg-stale`` 2, on
            each engine: each round's availability record, ``comm_gb``
            equal to a count of the bytes sent (from the availability,
            the edge assignment and the parameter counts), exactly the
            launches the budgets make; ``faults_engines`` the two
            engines' availability, selections and bytes identical, losses
            within TRAIN_LOSS_RTOL, params and late deltas within
            TRAIN_PARAMS_ATOL; ``faults_resume`` ``fedphd-stale`` killed
            after round 1 and resumed, bit for bit (history, params, late
            deltas, the fault stream).  A dropped and a late client must
            occur, and in each staleness run an aggregate that takes an
            on-time reporter and buffers a late client;
7e. quant   the int8 and fp8 uplink with error feedback (QUANT_RUNS):
            FedPhD and SCAFFOLD on the vectorized engine, bytes equal to
            the count and the uplink's ratio to fp32's, exact launches;
            ``quant_engines`` one sequential FedPhD round against the
            vectorized run's first, the bytes identical, params within
            TRAIN_PARAMS_ATOL plus the largest quantization bucket of
            each leaf (taken on the sequential run, which is not timed);
            ``quant_resume`` FedPhD int8 killed and resumed, params,
            error-feedback rows (nonzero) and history bit for bit; and the
            card's quantizer bitwise against the CPU's on the same
            deltas (exact ties, values past +-448);
7f. obs     (run after ``quant_memory``, so the earlier phases' times do
            not move) the ``train (vectorized)`` cell stepped, pipelined
            (``run(3)``) and traced, in turns (OBS_RUNS): every run bitwise
            the first's; the trace's phase counts, ``overlap_ratio``,
            compiles (the plan and table caches cleared before the traced
            run) and no recompile; the pipelined peak within
            OBS_PEAK_SHARE of the stepped; the sync probe (an ``.item()``
            control must be caught) on rounds 1-4 of the cell and of the
            cell with persistent Adam rows in the host store, a steady
            round's syncs within OBS_SYNCS_ALLOWED; 16 requests served
            dense with ``--trace``: a ``serve/tick`` span a tick, the host
            caches grown in the first tick only;
7g. sweep   (after quant) the ``train`` cell's spec as a 4-run grid
            (``method`` fedphd | fedavg x ``comm.quant`` none | int8,
            SWEEP_ROUNDS rounds, R_s past them, the eval hook at the
            last) through every sweep executor: the runner's ``--sweep``
            killed by ``--max-runs`` and resumed, the same unbroken, the
            k8s executor on a ``FakeCluster`` preempting one run, and
            one spawned process worker on two points; the histories
            bitwise equal across them, the report's groups, the int8
            uplink against the none runs', exact launches, the worker's
            start-up and its nvcc builds (0);
8. kernels  every kernel against its plain PyTorch version on the card at
            each shape the serving, training, LM, experiment,
            baselines, faults, quant and sweep runs launched it with
            (the matmul's backward-dx launches as the backward runs them,
            reading w.T in place), plus masked cases (ratios 0 / 0.44 /
            0.9, a fully masked N-block, a ragged unaligned 1000 x 999 x
            77 forward and dx), attention at hd = 100 (the SIMT kernel:
            rows TMA cannot address) and 144, causal and windowed, ragged
            S = 1000 and S = 16, and the scan on a ragged shape and with a
            in [0.999, 1), and the scan's backward at each shape
            ``lm_train`` launched it with, S = 1000 with W = 999 and a in
            [0.999, 1), the WKV kernel and its backward at each shape the
            rwkv phases launched them with and at ragged shapes with fast
            and underflowing decays (WKV_DECAYS), in the dtype each ran (fp32, TF32 off) and in
            bf16 (or fp32) beside it, each with its tolerance and its time
            beside the plain version, the library call (none computes the
            scan or its gradient) and the bound.  A matmul launch that splits K runs twice
            and must give the same bits.  Group-L2 is checked per launched
            member signature (the whole table of a launch), in its dtype
            and in bf16: forward within tolerance, a repeat bitwise equal,
            the backward bitwise equal to 2 w g.  Client-axis launches
            (the vectorized run's: C products, C copies of a member
            table) are checked the same way and also against C
            one-client launches, bitwise where the matmul's plan cuts
            both alike and always for group-L2.  The scan and its
            backward must equal their plain loops bitwise in every case;
            on TMA-addressable rows the SIMT kernel is timed and checked
            beside the TMA one.  The WKV kernel's output, state and six
            gradients must be within WKV_TOL of the plain loop's (sums
            in another order), and its in-place form bitwise its other;
9. forward  one full-width U-Net forward through the kernels against the
            same forward through the plain versions (on CPU copies of the
            weights and inputs, so device dispatch picks them), dense and
            with 0.44 masks;
10. grad    one full-width loss and gradient at batch 4 with injected t
            and eps, through the kernels against the plain versions on
            CPU copies: the dense model with Omega, as in a sparse round,
            and the compacted model.  Every leaf is held to GRAD_TOL of
            the largest plain gradient, and every leaf of at least
            GRAD_LEAF_FLOOR of it also to GRAD_LEAF_TOL of its own.
            Then one stacked loss and gradient of 4 clients (client-axis
            launches), with and without Omega, against each client's own
            through one-client launches, within GRAD_TOL of the largest
            gradient;
11. profile only with ``--profile``: one more training run on each engine,
            after lm_serve one more prefill and 8 decode steps, and
            after lm_train one more LM train step, each under
            ``torch.profiler``: device time by kernel and category,
            the device's idle share and kernels a step, the traces for
            work on the step's speed (the sequential training profile's
            post-processing adds ~4 min).

The engine-memory line also gives ``round_bytes``' estimate at each C
and fails if it is below the measured peak.  After it,
``baselines_memory`` runs one round of MOON and of SCAFFOLD over the
paper preset's 20 clients (one step each) in chunks of the k
``client_chunk`` picks for the paper preset, the 20-row method state on
the card: its peak, less what was allocated before, must not exceed the
method's estimate.  ``quant_memory`` does the same for FedPhD with the
int8 uplink over the paper preset's round, its 20 error-feedback rows
on the card, in chunks of ``client_chunk``'s k with the uplink counted.

Every kernel's counters (``.launches``, the per-shape ``.shapes``, the
matmul's ``.dx_shapes``, and group-L2's, the scan's and WKV's
``.bwd_launches`` and ``.bwd_shapes``) are set to 0 just before each serving run, each
training run, each LM run, each experiment run, each baselines run,
each faults and quant run and each in-process sweep (the killed and
resumed pair counted as one), and read just after it.  Group-L2
launches once per Omega evaluation and once per pruning score: the
sequential training run must launch it once a sparse step plus once at R_s, the
vectorized one once a batched sparse step plus once at R_s, the 0.44
serving run once; ``lm_prune`` once a score evaluation, and
``lm_consistency`` once for its scores and once forward and once
backward for its Omega.

Then a ``{"kernels": [...]}`` line, nvidia-smi's line, and last
``{"ok": true, "device": {...}}``.  In the kernels line each kernel's
main path (``MAIN_PATHS``) is the training run, the system's own path,
for the three U-Net kernels, the LM prefill for the scan and
``rwkv_prefill`` for WKV (``wkv6_backward``, its backward, on
``rwkv_train``):
``launches`` is its count there, and ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are sums over its launches of each
shape's time (count x time per launch; ``library_ms`` is null where no
PyTorch call computes the function), ``bound_share`` is bound_ms / ms
and ``vs_library`` ms / library_ms.  ``paths`` gives the same for every
run, among them ``train_vectorized`` (the first vectorized training
run), ``train_bf16``, ``experiment`` (the unbroken paper run),
``baselines``, ``faults`` and ``quant`` (every run of phases 7c, 7d and
7e) and ``sweep`` (phase 7g's unbroken sweep, its eval included), the
matmul's launches on those and ``train`` also
split into forward and dx; group-L2's entry
is its forward launches, and ``backward`` (and
``backward_train_vectorized``, ``backward_experiment``) gives its
backward kernel's on those runs; the scan's ``backward`` gives its
backward kernel's on ``lm_train``.
Any failure exits nonzero before the last line.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the H100's peak rates (FLOP/s by dtype, HBM bytes/s), the port's one
# source of them
from repro_torch.roofline.hw import PEAK_BYTES, PEAK_FLOPS  # noqa: E402
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
# the last-position prefill logits against the decode logits after the
# same tokens, x max|decode logit|: fp32 with TF32 off on both sides,
# which differ in summation order only (GEMMs over 2304 rows vs GEMVs,
# the attention kernel vs the plain ring-buffer attention)
LM_TOL = 1e-4
SERVE_PATHS = (("dense", []), ("pruned", ["--prune-ratio", "0.44"]))
LM_PATHS = ("lm_prefill", "lm_serve", "lm_consistency", "lm_prune",
            "lm_train")
# phases 7j-7m: moonshot at full width and depth (prefill, serving), each
# MoE/MLA config at full width cut to MOE_DEPTH layers in fp32 (prefill
# against decode), moonshot's train step at MOE_TRAIN_DEPTH layers
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_CONSISTENCY = (("moonshot", "moonshot-v1-16b-a3b", 4),
                   ("qwen3", "qwen3-moe-235b-a22b", 4),
                   ("deepseek", "deepseek-v3-671b", 4))
MOE_CONSISTENCY_SEQ = 8          # T <= 8 tokens cannot drop a pair
MOE_TRAIN_DEPTH = 4              # the dense head layer and 3 MoE layers
MOE_PATHS = ("moe_prefill", "moe_serve") + tuple(
    f"moe_consistency_{label}" for label, _, _ in MOE_CONSISTENCY) + (
    "moe_train",)
# phases 7n-7q: command-r at full width and depth (prefill, serving),
# each dense-extras config at full width in fp32 (prefill against decode;
# command-r, internlm2 and internvl2 cut in depth, gemma2 and whisper
# whole), gemma2's train step at full depth
DENSE_ARCH = "command-r-35b"
DENSE_CONSISTENCY = (("command_r", "command-r-35b", 4),
                     ("internlm2", "internlm2-20b", 4),
                     ("internvl2", "internvl2-76b", 4),
                     ("gemma2", "gemma2-2b", 26),
                     ("whisper", "whisper-base", 6))
DENSE_CONSISTENCY_SEQ = 8        # text tokens; internvl2 adds its 256 images
# prefill against decode, x max|decode logit|, fp32 with TF32 off
DENSE_TOL = 1e-5
DENSE_TRAIN_ARCH = "gemma2-2b"
DENSE_PATHS = ("dense_prefill", "dense_serve") + tuple(
    f"dense_consistency_{label}" for label, _, _ in DENSE_CONSISTENCY) + (
    "dense_train",)
# phases 7r-7u: rwkv6-7b at full width and depth (prefill, serving), at
# full width cut to RWKV_DEPTH layers in fp32 (prefill against decode on
# the exact and the chunked route), its train step at RWKV_TRAIN_DEPTH
RWKV_ARCH = "rwkv6-7b"
RWKV_DEPTH, RWKV_CONSISTENCY_SEQ = 4, 256
RWKV_CHUNK = 64                  # the chunked route's wkv_chunk
# the exact route's prefill against decode, x max|decode logit|: fp32,
# TF32 off, GEMMs over 256 rows against GEMVs (and the WKV kernel's
# 256-step launch against its one-step ones) in other summation orders,
# carried through the state's sums over the sequence; LM_TOL, as the
# RG-LRU's recurrence is held (DENSE_TOL's 1e-5 is not met: 2.3e-5
# measured, PERF.md)
RWKV_TOL = LM_TOL
# the chunked route against decode: the same, and its clamp of
# log-cumulative decays at +-25, which the init's w ~ 0.99 stay far from
RWKV_CHUNK_TOL = 1e-4
# bf16 over an fp32 master: 16 B a param, 36.8e9 B at 8 layers
RWKV_TRAIN_DEPTH = 8
RWKV_PATHS = ("rwkv_prefill", "rwkv_serve", "rwkv_consistency",
              "rwkv_train")
# the WKV kernel against its plain loop, x max|plain| of each output:
# fp32 sums over K in another order, carried through the state for S
# steps
WKV_TOL = 1e-4
# w = exp(-exp(x)), x uniform in: the init's range (w ~ 0.99), w0 near 0
# (w ~ 0.07-0.4), and decays that underflow (w < 1e-8, 0 past x ~ 4.5)
WKV_DECAYS = {"init": (-7.0, -4.0), "fast": (-0.1, 0.9),
              "underflow": (3.0, 5.0)}
TRAIN_PATHS = ("train", "train_vectorized")     # the engines' first runs
# the runs with a backward: the matmul's dx and group-L2's backward
BACKWARD_PATHS = TRAIN_PATHS + ("train_bf16", "mesh", "experiment",
                                "baselines", "faults", "quant", "sweep",
                                "lm_consistency")
PATHS = tuple(dict.fromkeys(("dense", "pruned") + TRAIN_PATHS + LM_PATHS
                            + MOE_PATHS + DENSE_PATHS + RWKV_PATHS
                            + BACKWARD_PATHS[2:]))
MAIN_PATHS = {"block_masked_matmul": "train", "flash_attention": "train",
              "group_l2_norms": "train", "rglru_scan": "lm_prefill",
              "wkv6": "rwkv_prefill"}
TRAIN_BATCH = 32
TRAIN_CLIENTS = 4
TRAIN_LR = 2e-4
TRAIN_ENGINES = ("sequential", "vectorized")
# runs a side, the engines in turns: host time drifts 1.3-1.6x in a call
# (three until the experiment phase came; cut to keep the script short)
TRAIN_PAIRS = 2
# vectorized against sequential (the same draws, other summation orders):
# each round's loss relative; params within 6 local steps x 2 lr (Adam
# moves a parameter whose exact gradient is zero by up to lr a step), and
# this share of them within 1e-5 (tests/test_torch_train.py's form)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAMS_ATOL = 6 * 2 * TRAIN_LR
TRAIN_PARAMS_BULK = (1e-5, 0.995)
# the vectorized run's launches: 6 batched steps (2 a round) of the
# sequential run's 200 matmul and 6 attention launches a client step;
# group-L2 once a sparse step (2) plus the scores at R_s, backward 2
VECTORIZED_LAUNCHES = {"block_masked_matmul": 1200, "flash_attention": 36,
                       "group_l2_norms": 3, "group_l2_norms_bwd": 2}
# the mesh phase: the train cell's vectorized FedPhD on a one-rank NCCL
# mesh (the world of one this card holds), in turns with the unsharded
# engine: mesh, unsharded, mesh; and one MOON round a side
MESH_AXES = {"data": 1, "model": 1}
MESH_RUNS = (True, False, True)
MESH_FLAT = "moon"
# collectives a round: FedPhD reduces agg and gathers the losses; MOON
# also gathers its trained rows
MESH_COLLECTIVES = {"fedphd": (1, 1), "moon": (1, 2)}
# the vectorized engine's peak memory at these client counts (20 is
# FLConfig's default population at participation 1.0), until one fails
MEMORY_CLIENTS = (4, 8, 10, 12, 16, 20)
# the experiment phase: the paper preset, its rounds cut to 2; the eval
# hook samples EVAL_IMAGES images (runner._default_eval)
EXPERIMENT_PRESET = "paper"
EXPERIMENT_ROUNDS = 2
EXPERIMENT_BATCH = 32
EVAL_IMAGES = 64
GRAD_CLIENTS = 4
GRAD_BATCH = 4
LM_ARCH = "recurrentgemma-9b"
LM_BATCH, LM_SEQ, LM_TIMED = 2, 4096, 3
LM_SERVE = dict(slots=8, requests=16, max_tokens=32, cache_len=4096)
LM_DEPTH, LM_CONSISTENCY_SEQ = 5, 2304
# phase 6b (lm_prune): recurrentgemma-9b's groups (3 pattern positions
# over 12 stacked cycles, 2 unstacked tail layers), pruned at the
# paper's ratio; masks.kept_count's results at that ratio, 128-aligned
# channels and lanes, one of the single KV head kept
LM_PRUNE_RATIO = 0.44
LM_PRUNE_GROUPS = ("cyc0/lru", "cyc0/ffn", "cyc1/lru", "cyc1/ffn",
                   "cyc2/heads", "cyc2/ffn", "tail0/lru", "tail0/ffn",
                   "tail1/lru", "tail1/ffn")
LM_PRUNED = {"d_ff": 6912, "lru_width": 2304, "num_kv_heads": 1,
             "num_heads": 16}
LM_OMEGA_LAMBDA0 = 1e-3
LM_PROFILE_STEPS = 8
# phase 7h (lm_train): full width at the least depth that runs both
# kernels, one (rec, rec, local attention) cycle; bf16 params, an fp32
# master and two fp32 moments, and bf16 grads in the step: 16 B a param
LM_TRAIN_DEPTH, LM_TRAIN_SEQ, LM_TRAIN_LR, LM_TRAIN_WARMUP = 3, 4096, 3e-4, 1
LM_BYTES_PER_PARAM = 16
LM_GRAD_SEQ = 512                # phase 7i (lm_grad), fp32
# phase 7c, the flat baselines: the train cell's data at full width
BASELINE_METHODS = ("fedavg", "fedprox", "moon", "scaffold", "feddiffuse")
BASELINE_ROUNDS = 2
BASELINE_DATASET = "cifar10-like-320"
BASELINE_RESUMED = ("scaffold", "moon")
BASELINE_MEMORY_METHODS = ("moon", "scaffold")
# FedDiffuse's shared half (repro_torch.fl.baselines._SHARED_KEYS_UNET)
BASELINE_SHARED = ("conv_in", "temb1", "temb2", "down", "mid")
# a local step's U-Net forwards (with a backward, without): MOON adds
# the trained model's feature forward and the global and previous
# models' no-grad ones; every other method makes one with a backward
BASELINE_FORWARDS = {"moon": (2, 2)}
# phase 7d (faults): every fault of the reference's fault model at once
# on the train cell (2 steps a client: a deadline of 0.75 leaves 1 to a
# fast client, 0 to a slow one), for the truncation and dropout run;
# the staleness runs' deadline of 1.0 leaves a fast client on time and
# makes a slow one late, so that one aggregate takes reporters and
# buffers late deltas (with the fault seed 2, FedPhD's edges in rounds 1
# and 2, FedAvg in both of its rounds; a client drops in round 2)
FAULT_SPEC = dict(arrival=0.9, dropout=0.25, straggler_frac=0.5,
                  slowdown=2.0, deadline=0.75, churn=0.1, seed=1)
FAULT_STALE = dict(FAULT_SPEC, deadline=1.0, seed=2)
FAULT_SEED = 0
FAULT_RUNS = (("fedphd", 3, FAULT_SPEC),
              ("fedphd-stale", 3, FAULT_STALE),
              ("fedavg-stale", 2, FAULT_STALE))
FAULT_RESUMED = "fedphd-stale"
# phase 7e (quant): (method, uplink dtype, rounds), vectorized; FedPhD's
# int8 run is also killed and resumed
QUANT_RUNS = (("fedphd", "int8", 3), ("fedphd", "fp8", 2),
              ("scaffold", "int8", 2), ("scaffold", "fp8", 1))
QUANT_RESUMED = "int8"
# the widest gap between neighbouring codes of each uplink dtype, in
# scales: int8's 1, fp8-e4m3's 32 (its step from 256 to 448)
QUANT_STEP = {"int8": 1.0, "fp8": 32.0}
# bf16 training against fp32: each round's loss (tests/test_precision.py)
BF16_LOSS_ATOL = 0.05
# one CIFAR10_UNET forward's launches: its 101 GEMMs, the 99 dx of its
# backward (all but conv_in's and temb1's, whose inputs need no
# gradient), and its 6 attention blocks
U_NET_GEMMS = (101, 99)
U_NET_ATTENTION = 6
IMAGE = (32, 32, 3)
# the paper preset's round (20 clients, 8 steps each), for the chunk size
PAPER_CLIENTS, PAPER_STEPS = 20, 8
CENTRAL_STEPS = 8
OBS_PHASES = ("round/host_prep", "round/h2d", "round/dispatch",
              "round/loss_sync")
# the runs in turns: the stepped and pipelined pair around the traced run
OBS_RUNS = ("stepped", "pipelined", "traced", "pipelined", "stepped")
OBS_PEAK_SHARE = 0.02            # pipelined peak over the stepped one
# the trainers the sync probe runs, by label: the cell's, and the cell's
# with persistent Adam rows in the host store
OBS_PROBES = {"default": {},
              "host_store": dict(persistent_opt=True, state_store="host")}
# synchronizing calls a steady-state vectorized _start_round may make
# (file:line; ROADMAP B.5 lists them)
OBS_SYNCS_ALLOWED = ()
# phase 7g (sweep): the train cell's spec as a grid over these axes, 2
# rounds with R_s past them (Omega in both, nothing pruned) and the eval
# hook at the last; the CLI's sequential sweep killed after
# SWEEP_KILL_AFTER runs and resumed, a FakeCluster run preempted after
# SWEEP_PREEMPT_AFTER rounds, and the process executor on the grid less
# SWEEP_PROCESS_EXCLUDE (two points)
SWEEP_AXES = {"method": ["fedphd", "fedavg"], "comm.quant": ["none", "int8"]}
SWEEP_ROUNDS = 2
SWEEP_KILL_AFTER = 2
SWEEP_PREEMPT_AFTER = 1
SWEEP_PROCESS_EXCLUDE = ({"method": "fedphd", "comm.quant": "none"},
                         {"method": "fedavg", "comm.quant": "int8"})
EVAL_STEPS = 10                  # runner._default_eval's DDIM steps
TPU_KERNELS = {
    "block_masked_matmul":
        "src/repro/kernels/block_masked_matmul/block_masked_matmul.py:43",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:74",
    "group_l2_norms": "src/repro/kernels/group_l2_norms/group_l2_norms.py:19",
    "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:41",
    "wkv6": "no TPU kernel: lax.scan at src/repro/models/rwkv6.py:67",
}
SOURCES = {
    "block_masked_matmul": "src/repro_torch/kernels/block_masked_matmul/"
                           "csrc/block_masked_matmul.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
    "group_l2_norms": "src/repro_torch/kernels/group_l2_norms/csrc/"
                      "group_l2_norms.cu",
    "rglru_scan": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
    "wkv6": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
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
# phase 8: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_matmul(cases, gen, dev, log):
    """cases: ((M, K, N), ratio or None, dtype, tally key or None, role,
    clients or None).  A "dx" case runs as the backward launches it:
    B = w.T read in place from a row-major w (N, K).  A launch that
    splits K runs twice and must give the same bits.  A client-axis case
    (C products in one launch) must also give the bits of C one-client
    launches wherever the plan cuts both alike."""
    import torch
    from repro_torch.kernels.block_masked_matmul import ops as bmm
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (M, K, N), ratio, dtype_name, key, role, C in cases:
        dt = getattr(torch, dtype_name)
        dx = role == "dx"
        lead = () if C is None else (C,)
        x = torch.randn(lead + (M, K), generator=gen, device=dev).to(dt)
        w = (torch.randn(lead + ((N, K) if dx else (K, N)), generator=gen,
                         device=dev) / K ** 0.5).to(dt)
        b = w.transpose(-1, -2) if dx else w     # the B operand, (K, N)
        cm = rm = None
        if ratio is not None:
            cm = (torch.rand(N, generator=gen, device=dev) >= ratio).float()
            rm = (torch.rand(K, generator=gen, device=dev)
                  >= ratio / 2).float()

        def kernel():
            return bmm.block_masked_matmul(x, w, cm, rm, trans_b=dx)
        got = kernel()
        plan = bmm.plan(M, K, N, C or 1)
        again = kernel() if plan.splits > 1 else got
        want = bmm.block_masked_matmul_plain(x, b, cm, rm)
        same_plan = C is not None and plan == bmm.plan(M, K, N)
        per_client = torch.stack([
            bmm.block_masked_matmul(x[c], w[c], cm, rm, trans_b=dx)
            for c in range(C)]) if same_plan else None
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        tol = TOL[dtype_name] * scale
        wmask = b if ratio is None else \
            (b * cm[None, :].to(dt) * rm[:, None].to(dt))
        kk = K if rm is None else int(rm.sum())
        nn = N if cm is None else int(cm.sum())
        elt = x.element_size()
        nbytes = (C or 1) * (M * K + K * N + M * N) * elt \
            + (0 if ratio is None else 4 * (K + N))
        b_ms, b_by = bound_ms(2.0 * (C or 1) * M * kk * nn, nbytes,
                              dtype_name)
        row = {"kernel": "block_masked_matmul", "key": key, "role": role,
               "C": C, "M": M, "K": K, "N": N, "ratio": ratio,
               "dtype": dtype_name, "plan": plan._asdict(),
               "max_abs_err": err, "tol": tol,
               "bitwise_repeat": bool(torch.equal(got, again)),
               "bitwise_per_client": None if per_client is None
               else bool(torch.equal(got, per_client)),
               "ms": time_ms(kernel),
               "plain_ms": time_ms(
                   lambda: bmm.block_masked_matmul_plain(x, b, cm, rm)),
               "library_ms": time_ms(lambda: torch.matmul(x, wmask)),
               "bound_ms": b_ms, "bound_by": b_by}
        log(row)
        what = f"block_masked_matmul {lead + (M, K, N)} {role} " \
               f"{dtype_name} ratio={ratio}"
        require(err <= tol, f"{what}: err {err} > tol {tol}")
        require(row["bitwise_repeat"], f"{what}: split {plan.splits} ways "
                                       f"differs between two launches")
        require(row["bitwise_per_client"] is not False,
                f"{what}: differs from {C} one-client launches of the "
                f"same plan")
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
               "dtype": dtype_name, "variant": fa.variant(dt, hd),
               "max_abs_err": err, "tol": tol,
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
    # bf16 tiles arrive by TMA: a base off 16 bytes is refused, not rerouted
    q = torch.randn(8 * 64 * 64 + 1, generator=gen, device=dev).to(
        torch.bfloat16)[1:].view(8, 64, 64)
    try:
        fa.flash_attention_bhsd(q, q, q)
    except ValueError:
        pass
    else:
        raise Failed("flash_attention launched on a misaligned bf16 q")
    return worst


def signature_name(key) -> str:
    """A group-L2 tally key (a signature, with C for a client axis) in a
    few words, for the case log."""
    import hashlib
    shapes, members = key[:2]
    dts = sorted({dt for _, dt in shapes})
    clients = f", {key[2]} clients" if len(key) > 2 else ""
    return (f"{len(members)} members of {len(shapes)} tensors, "
            f"{'/'.join(dts)}{clients}, "
            f"{hashlib.sha1(repr(key).encode()).hexdigest()[:10]}")


# group-L2 tally key -> per slot, the first slot that holds the same
# tensor on the main path (:func:`note_aliases`); keys absent alias none
GL2_ALIASES = {}


def note_aliases(params, groups):
    """Record which of the one launch's slots over ``groups`` are one
    tensor (a member owning two axes of it: the RG-LRU's gates), so
    that the kernel check runs on the same sharing and its bound reads
    each element once."""
    from repro_torch.core.pruning import member_table
    tensors, tab = member_table(params, groups)
    first = {}
    alias = tuple(first.setdefault(t.data_ptr(), i)
                  for i, t in enumerate(tensors))
    if alias != tuple(range(len(tensors))):
        GL2_ALIASES[tab.key] = alias


def group_l2_bytes(tab, alias):
    """(member bytes, tensor bytes) a launch of ``tab`` must move at
    least: every distinct member element read once, and every distinct
    tensor's gradient written whole (zeros off its members), where the
    slots ``alias`` maps together are one tensor."""
    import math
    from collections import defaultdict

    import torch
    alias = alias or tuple(range(len(tab.signature[0])))
    by_tensor = defaultdict(list)
    for m, v in zip(tab.members, tab.views):
        by_tensor[alias[m.tensor]].append((m, v))
    members = tensors = 0
    for t, mvs in by_tensor.items():
        shape, dt = tab.signature[0][t]
        size = getattr(torch, dt).itemsize
        tensors += math.prod(shape) * size
        if sum(alias[i] == t for i in range(len(alias))) == 1:
            members += sum(math.prod(shape) // v[1] * m.size * m.chunk
                           for m, v in mvs) * size
            continue
        seen = torch.zeros(math.prod(shape), dtype=torch.bool)
        for m, (outer, L, inner) in mvs:
            seen.view(outer, L, inner)[
                :, m.offset:m.offset + m.size * m.chunk] = True
        members += int(seen.sum()) * size
    C = tab.clients or 1
    return C * members, C * tensors


def check_group_l2(keys, gen, dev, log):
    """keys: the launched tally keys (a launch's whole member table, and
    C for a client-axis table).  Each runs on random tensors of its
    shapes, in its dtype (slots that are one tensor on the main path,
    GL2_ALIASES, one tensor here too), and the first also in bf16: the
    forward against the plain version within TOL["float32"] x max (fp32
    sums on both sides), a repeat bitwise equal, the backward bitwise
    equal to the plain 2 w g; a client-axis table also bitwise against
    one one-client launch per client, forward and backward.
    ``library_ms`` is the loop of one ``einsum`` a member that a
    PyTorch user would write; the bound reads every distinct member
    element once and writes every distinct gradient once."""
    import torch
    from repro_torch.kernels.group_l2_norms import ops as gl2
    worst = 0.0
    cases = [(k, k) for k in keys]
    if keys:
        shapes, members = keys[0][:2]
        cases.append(((tuple((sh, "bfloat16") for sh, _ in shapes),
                       members), None))
    for sig, key in cases:
        C = sig[2] if len(sig) > 2 else None
        tab = gl2.table(sig[:2], clients=C)
        lead = () if C is None else (C,)
        alias = GL2_ALIASES.get(sig)
        tensors = [torch.randn(lead + shape, generator=gen, device=dev).to(
            getattr(torch, dt)) for shape, dt in sig[0]]
        if alias is not None:
            tensors = [tensors[a] for a in alias]
        g = torch.randn(tab.out_units, generator=gen, device=dev)
        got = gl2.segmented_sq_norms(tensors, tab)
        again = gl2.segmented_sq_norms(tensors, tab)
        want = gl2.segmented_sq_norms_plain(tensors, tab)
        dw = gl2.segmented_sq_norms_backward(tensors, tab, g)
        dw_want = gl2.segmented_sq_norms_backward_plain(tensors, tab, g)
        per_client = None
        if C is not None:                # one-client launches, client by client
            one, u = gl2.table(sig[:2]), tab.units
            slices = [[t[c] for t in tensors] for c in range(C)]
            fwd = torch.cat([gl2.segmented_sq_norms(sl, one)
                             for sl in slices])
            bwd = [gl2.segmented_sq_norms_backward(sl, one,
                                                   g[c * u:(c + 1) * u])
                   for c, sl in enumerate(slices)]
            per_client = bool(torch.equal(got, fwd)) and all(
                torch.equal(d[c], bwd[c][i]) for i, d in enumerate(dw)
                for c in range(C))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL["float32"] * float(want.abs().max())
        views = [(t.reshape(lead + v).narrow(len(lead) + 1, m.offset,
                                              m.size * m.chunk)
                  .unflatten(len(lead) + 1, (m.size, m.chunk)))
                 for m, v in zip(tab.members, tab.views)
                 for t in (tensors[m.tensor],)]

        def library():
            out = []
            for _, _, m0, m1 in tab.groups:
                acc = None
                for v in views[m0:m1]:
                    vf = v.float()
                    s = torch.einsum("...okci,...okci->...k", vf, vf)
                    acc = s if acc is None else acc + s
                out.append(acc)
            return out

        nbytes, grad_bytes = group_l2_bytes(tab, alias)
        elems = sum(v.numel() for v in views)
        dtypes = "/".join(sorted({dt for _, dt in sig[0]}))
        common = {"kernel": "group_l2_norms", "key": key,
                  "signature": signature_name(sig), "clients": C,
                  "members": len(tab.members), "tensors": len(tensors),
                  "shared_tensors": alias is not None,
                  "units": tab.out_units, "work_items": tab.counts[1],
                  "dtype": dtypes}
        b_ms, b_by = bound_ms(2.0 * elems, nbytes + 4 * tab.out_units,
                              "float32")
        row = {**common, "role": "fwd", "max_abs_err": err, "tol": tol,
               "bitwise_repeat": bool(torch.equal(got, again)),
               "bitwise_per_client": per_client,
               "ms": time_ms(lambda: gl2.segmented_sq_norms(tensors, tab)),
               "plain_ms": time_ms(
                   lambda: gl2.segmented_sq_norms_plain(tensors, tab)),
               "library_ms": time_ms(library),
               "bound_ms": b_ms, "bound_by": b_by}
        log(row)
        b_ms, b_by = bound_ms(2.0 * elems, nbytes + 4 * tab.out_units
                              + grad_bytes, "float32")
        bwd_equal = all(torch.equal(x, y) for x, y in zip(dw, dw_want))
        log({**common, "role": "bwd", "bitwise_equal": bwd_equal,
             "ms": time_ms(lambda: gl2.segmented_sq_norms_backward(
                 tensors, tab, g)),
             "plain_ms": time_ms(lambda: gl2.segmented_sq_norms_backward_plain(
                 tensors, tab, g)),
             # no single PyTorch call computes the gradient
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        what = f"group_l2_norms {common['signature']}"
        require(err <= tol, f"{what}: err {err} > {tol}")
        require(row["bitwise_repeat"], f"{what}: two runs differ")
        require(bwd_equal, f"{what}: the backward differs from 2 w g")
        require(per_client is not False,
                f"{what}: differs from one-client launches on each slice")
        worst = max(worst, err)
    return worst


def check_scan(cases, gen, dev, log):
    """cases: ((B, S, W), a's range, dtype, tally key or None).  a is
    drawn uniform in the range, b standard normal.  Every kernel must
    give the plain loop's bits; where the wrapper takes the TMA pipeline
    the SIMT kernel (the one any W takes) is timed beside it."""
    import torch
    from repro_torch.kernels.rglru_scan import ops as scan
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (B, S, W), (lo, hi), dtype_name, key in cases:
        dt = getattr(torch, dtype_name)
        a = (lo + (hi - lo) * torch.rand(B, S, W, generator=gen,
                                         device=dev)).to(dt)
        b = torch.randn(B, S, W, generator=gen, device=dev).to(dt)
        kern = scan.variant(W, dt)
        others = ("simt",) if kern == "tma" else ()
        got = scan.rglru_scan(a, b)
        other_out = {k: scan.launch(a, b, k) for k in others}
        want = scan.rglru_scan_plain(a, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        tol = TOL[dtype_name] * scale
        # a multiply and an add per element, in fp32 whatever the dtype
        b_ms, b_by = bound_ms(2.0 * B * S * W,
                              3 * B * S * W * a.element_size(), "float32")
        row = {"kernel": "rglru_scan", "key": key, "B": B, "S": S, "W": W,
               "a_range": [lo, hi], "dtype": dtype_name, "variant": kern,
               "max_abs_err": err, "max_abs_plain": scale, "tol": tol,
               "bitwise_equal": bool(torch.equal(got, want)),
               "ms": time_ms(lambda: scan.rglru_scan(a, b)),
               # a Python loop of S steps: a few launches each
               "plain_ms": time_ms(lambda: scan.rglru_scan_plain(a, b),
                                   iters=2),
               # no single PyTorch call computes a linear recurrence
               "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by}
        for k, out in other_out.items():
            row[f"ms_{k}"] = time_ms(lambda: scan.launch(a, b, k))
            row[f"bitwise_equal_{k}"] = bool(torch.equal(out, want))
        log(row)
        what = f"rglru_scan {(B, S, W)} a in [{lo}, {hi}) {dtype_name}"
        require(err <= tol, f"{what}: err {err} > tol {tol}")
        require(row["bitwise_equal"] and all(
            row[f"bitwise_equal_{k}"] for k in others),
            f"{what}: a kernel differs from the plain loop's bits")
        worst[dtype_name] = max(worst[dtype_name], err)
    # rows arrive by TMA: a base off 16 bytes is refused, not rerouted
    a = torch.rand(2 * 64 * 512 + 1, generator=gen, device=dev)[1:].view(
        2, 64, 512)
    try:
        scan.rglru_scan(a, a)
    except ValueError:
        pass
    else:
        raise Failed("rglru_scan launched on a misaligned a")
    return worst


def check_scan_backward(cases, gen, dev, log):
    """cases: ((B, S, W), a's range, dtype, tally key or None).  a is
    drawn uniform in the range, b and the output gradient g standard
    normal, h the forward's output.  Each kernel's (da, db) must equal
    the plain reverse loop's bits; where the wrapper takes the TMA
    pipeline the SIMT kernel is timed and checked beside it."""
    import torch
    from repro_torch.kernels.rglru_scan import ops as scan
    for (B, S, W), (lo, hi), dtype_name, key in cases:
        dt = getattr(torch, dtype_name)
        a = (lo + (hi - lo) * torch.rand(B, S, W, generator=gen,
                                         device=dev)).to(dt)
        b = torch.randn(B, S, W, generator=gen, device=dev).to(dt)
        g = torch.randn(B, S, W, generator=gen, device=dev).to(dt)
        h = scan.rglru_scan(a, b)
        kern = scan.variant(W, dt)
        others = ("simt",) if kern == "tma" else ()
        got = scan.rglru_scan_backward(a, h, g)
        other_out = {k: scan.launch_backward(a, h, g, k) for k in others}
        want = scan.rglru_scan_backward_plain(a, h, g)
        torch.cuda.synchronize()
        equal = lambda x: all(torch.equal(u, v) for u, v in zip(x, want))
        # g, a, h read once, da and db written once; a multiply, an add
        # and a multiply per element in fp32
        b_ms, b_by = bound_ms(3.0 * B * S * W,
                              5 * B * S * W * a.element_size(), "float32")
        row = {"kernel": "rglru_scan", "role": "bwd", "key": key, "B": B,
               "S": S, "W": W, "a_range": [lo, hi], "dtype": dtype_name,
               "variant": kern, "bitwise_equal": equal(got),
               "max_abs_err": max(float((u.float() - v.float()).abs().max())
                                  for u, v in zip(got, want)),
               "ms": time_ms(lambda: scan.rglru_scan_backward(a, h, g)),
               "plain_ms": time_ms(
                   lambda: scan.rglru_scan_backward_plain(a, h, g), iters=2),
               # no single PyTorch call computes the recurrence's gradient
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        for k, out in other_out.items():
            row[f"ms_{k}"] = time_ms(lambda: scan.launch_backward(a, h, g,
                                                                  k))
            row[f"bitwise_equal_{k}"] = equal(out)
        log(row)
        require(row["bitwise_equal"] and all(row[f"bitwise_equal_{k}"]
                                             for k in others),
                f"rglru_scan backward {(B, S, W)} a in [{lo}, {hi}) "
                f"{dtype_name}: a kernel differs from the plain loop's bits")


def _wkv_inputs(B, S, H, K, decay, gen, dev):
    """r, k, v and the state standard normal, u 0.5 N, w = exp(-exp(x))
    with x uniform in WKV_DECAYS[decay], all fp32 on ``dev``."""
    import torch
    lo, hi = WKV_DECAYS[decay]
    n = (B, S, H, K)
    r, k, v = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    w = torch.exp(-torch.exp(lo + (hi - lo) * torch.rand(
        n, generator=gen, device=dev)))
    u = 0.5 * torch.randn((H, K), generator=gen, device=dev)
    st = torch.randn((B, H, K, K), generator=gen, device=dev)
    return r, k, v, w, u, st


def check_wkv(cases, gen, dev, log):
    """cases: ((B, S, H, K), decay, tally key or None); inputs from
    :func:`_wkv_inputs`.  The kernel's output and new state each within
    WKV_TOL of the plain loop's max; the in-place (decode) form bitwise
    the same.  Returns (the largest error, the largest relative to its
    output's max)."""
    import torch
    from repro_torch.kernels.wkv6 import ops as wkv
    worst, worst_rel = 0.0, 0.0
    for (B, S, H, K), decay, key in cases:
        r, k, v, w, u, st = _wkv_inputs(B, S, H, K, decay, gen, dev)
        out, new = wkv.wkv6(r, k, v, w, u, st)
        given = st.clone()
        out1, _ = wkv.wkv6(r, k, v, w, u, given, inplace=True)
        want_out, want_new = wkv.wkv6_plain(r, k, v, w, u, st)
        torch.cuda.synchronize()
        err = float((out - want_out).abs().max())
        err_state = float((new - want_new).abs().max())
        scale = float(want_out.abs().max())
        scale_state = float(want_new.abs().max())
        ok = torch.isfinite(out).all() and torch.isfinite(new).all()
        # r, k, v, w and out a (B, S, H, K) stream each, u, the state in
        # and out; three multiply-adds a state element and step
        elems = B * S * H * K
        b_ms, b_by = bound_ms(6.0 * elems * K, 4 * (5 * elems + H * K
                                                    + 2 * B * H * K * K),
                              "float32")
        row = {"kernel": "wkv6", "key": key, "B": B, "S": S, "H": H, "K": K,
               "decay": decay, "max_abs_err": err, "max_abs_plain": scale,
               "tol": WKV_TOL * scale, "state_err": err_state,
               "state_plain": scale_state,
               "inplace_bitwise": bool(torch.equal(out1, out)
                                       and torch.equal(given, new)),
               "ms": time_ms(lambda: wkv.wkv6(r, k, v, w, u, st)),
               # a Python loop of S steps, a few launches each
               "plain_ms": time_ms(lambda: wkv.wkv6_plain(r, k, v, w, u, st),
                                   iters=2),
               # no PyTorch call computes the WKV recurrence
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        log(row)
        what = f"wkv6 {(B, S, H, K)} decay {decay}"
        require(bool(ok) and err <= WKV_TOL * scale
                and err_state <= WKV_TOL * scale_state,
                f"{what}: err {err} (state {err_state}) > {WKV_TOL} x "
                f"{scale} ({scale_state})")
        require(row["inplace_bitwise"],
                f"{what}: the in-place launch differs from the other")
        worst = max(worst, err, err_state)
        worst_rel = max(worst_rel, err / scale, err_state / scale_state)
    # what the kernel does not take is refused, not rerouted
    r, k, v, w, u, st = _wkv_inputs(1, 8, 2, 48, "init", gen, dev)
    for what, args in (("K = 48", (r, k, v, w, u, st)),
                       ("bf16", (r.bfloat16(), k, v, w, u, st))):
        try:
            wkv.wkv6(*args)
        except ValueError:
            continue
        raise Failed(f"wkv6 launched on {what}")
    return worst, worst_rel


def check_wkv_backward(cases, gen, dev, log):
    """cases as :func:`check_wkv`, with dout and d(new state) standard
    normal: each of the six gradients within WKV_TOL of the plain
    backward's max of that gradient.  Returns (the largest error, the
    largest relative to its gradient's max)."""
    import torch
    from repro_torch.kernels.wkv6 import ops as wkv
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    worst, worst_rel = 0.0, 0.0
    for (B, S, H, K), decay, key in cases:
        r, k, v, w, u, st = _wkv_inputs(B, S, H, K, decay, gen, dev)
        dout = torch.randn((B, S, H, K), generator=gen, device=dev)
        dst = torch.randn((B, H, K, K), generator=gen, device=dev)
        args = (r, k, v, w, u, st, dout, dst)
        got = wkv.wkv6_backward(*args)
        want = wkv.wkv6_backward_plain(*args)
        torch.cuda.synchronize()
        errs = {n: float((g - x).abs().max()) for n, g, x in
                zip(names, got, want)}
        scales = {n: float(x.abs().max()) for n, x in zip(names, want)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        # r, k, v, w and dout read, dr, dk, dv and dw written (B, S, H, K
        # each), u, du, the state, d(new state) and its gradient; the
        # state replayed and the adjoint carried (a multiply-add an
        # element each), one for each of dr, dk, dv and dw
        elems = B * S * H * K
        b_ms, b_by = bound_ms(12.0 * elems * K, 4 * (
            9 * elems + 2 * H * K + 3 * B * H * K * K), "float32")
        row = {"kernel": "wkv6", "role": "bwd", "key": key, "B": B, "S": S,
               "H": H, "K": K, "decay": decay, "finite": finite,
               "max_abs_err": max(errs.values()), "errors": errs,
               "max_abs_plain": scales, "tol_rel": WKV_TOL,
               "ms": time_ms(lambda: wkv.wkv6_backward(*args)),
               "plain_ms": time_ms(lambda: wkv.wkv6_backward_plain(*args),
                                   iters=2),
               # no PyTorch call computes the recurrence's gradient
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        log(row)
        bad = [n for n in names if not errs[n] <= WKV_TOL * scales[n]]
        require(finite and not bad,
                f"wkv6 backward {(B, S, H, K)} decay {decay}: {bad} past "
                f"{WKV_TOL} x their max (errors {errs}, max {scales})")
        worst = max([worst] + list(errs.values()))
        worst_rel = max([worst_rel] + [errs[n] / scales[n] for n in names
                                       if scales[n]])
    return worst, worst_rel


def ptxas_summary(log: str):
    """Each compiled kernel's registers and spill stores, from nvcc's
    ``-Xptxas=-v`` report."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None,
                   "spill_stores": None}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                cur["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def path_totals(rows, tally, role="fwd"):
    """One run's launches and count x time per launch, summed over the
    shapes ``tally`` (tally key -> launches in that run) records, each
    timed as that run launched it (``role``: the matmul's "dx" cases read
    w in place); a time no case has (``library_ms`` of the scan) stays
    None.  Adds ``bound_share`` (bound_ms / ms) and ``vs_library`` (ms /
    library_ms)."""
    by_key = {r["key"]: r for r in rows if r.get("key") is not None
              and r.get("role", "fwd") == role}
    out = {"launches": sum(tally.values()), **{k: 0.0 for k in TIMES}}
    by = {"bytes": 0.0, "operations": 0.0}
    for key, n in tally.items():
        r = by_key[key]
        for k in TIMES:
            out[k] = None if out[k] is None or r[k] is None \
                else out[k] + n * r[k]
        by[r["bound_by"]] += n * r["bound_ms"]
    out["bound_by"] = max(by, key=by.get) if tally else None
    return shares(out)


def shares(totals):
    """``totals`` with bound_share and vs_library (None where a time is
    0 or missing)."""
    ms, lib = totals["ms"], totals["library_ms"]
    totals["bound_share"] = totals["bound_ms"] / ms if ms else None
    totals["vs_library"] = ms / lib if ms and lib else None
    return totals


def add_totals(a, b):
    """Two disjoint sets of launches of one run, summed."""
    out = {"launches": a["launches"] + b["launches"]}
    for k in TIMES:
        out[k] = None if a[k] is None or b[k] is None else a[k] + b[k]
    out["bound_by"] = a["bound_by"] if a["bound_ms"] >= b["bound_ms"] \
        else b["bound_by"]
    return shares(out)


def tally_of(counters):
    """A run's kernel tallies: kernel -> {shape key: launches}, with the
    matmul's dx launches under "block_masked_matmul_dx", group-L2's
    backward under "group_l2_norms_bwd" and the scan's and WKV's under
    "rglru_scan_bwd" and "wkv6_bwd"."""
    tally = {k: dict(fn.shapes) for k, fn in counters.items()}
    tally["block_masked_matmul_dx"] = dict(
        counters["block_masked_matmul"].dx_shapes)
    tally["group_l2_norms_bwd"] = dict(counters["group_l2_norms"].bwd_shapes)
    tally["rglru_scan_bwd"] = dict(counters["rglru_scan"].bwd_shapes)
    tally["wkv6_bwd"] = dict(counters["wkv6"].bwd_shapes)
    return tally


def merge_tally(into, tally):
    for kernel, shapes in tally.items():
        dst = into.setdefault(kernel, {})
        for key, n in shapes.items():
            dst[key] = dst.get(key, 0) + n


# ---------------------------------------------------------------------------
# phases 5-7: RecurrentGemma serving
# ---------------------------------------------------------------------------

def lm_kinds(cfg):
    """(recurrent layers, attention layers) of a decoder config."""
    from repro_torch.configs.base import RECURRENT
    kinds = cfg.layer_kinds()
    n_rec = sum(k == RECURRENT for k in kinds)
    return n_rec, len(kinds) - n_rec


def lm_prefill_runs(cfg, params, dev, counters, zero_counters):
    """One warm-up and LM_TIMED timed prefills of B = 2, S = 4096, the
    counters zeroed just before: (seconds per run, the last logits, the
    launches, the tallies, the peak memory)."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import build_prefill_step

    step = build_prefill_step(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (LM_BATCH, LM_SEQ))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    times = []
    for _ in range(1 + LM_TIMED):
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    return (times, logits, launches, tally_of(counters),
            torch.cuda.max_memory_allocated(dev))


def check_lm_prefill(phase, cfg, logits, launches, tally, width=None):
    """26 scan and 12 attention launches a prefill (scans at ``width``
    lanes if given), no other kernel, finite logits of the right
    shape."""
    n_rec, n_attn = lm_kinds(cfg)
    runs = 1 + LM_TIMED
    finite = bool(torch_isfinite(logits))
    require((n_rec, n_attn) == (26, 12),
            f"{phase}: {cfg.name} plans {n_rec} recurrent and {n_attn} "
            f"attention layers, want 26 and 12")
    require(launches["rglru_scan"] == n_rec * runs
            and launches["flash_attention"] == n_attn * runs,
            f"{phase}: launches {launches} over {runs} prefills, want "
            f"{n_rec} scans and {n_attn} attentions each")
    require(all(n == 0 for k, n in launches.items()
                if k not in ("rglru_scan", "flash_attention"))
            and not any(tally[k] for k in ("block_masked_matmul_dx",
                                           "group_l2_norms_bwd",
                                           "rglru_scan_bwd", "wkv6_bwd")),
            f"{phase}: another kernel was launched: {launches}")
    require(width is None or all(k[2] == width for k in tally["rglru_scan"]),
            f"{phase}: scans at {sorted(tally['rglru_scan'])}, want "
            f"{width} lanes")
    require(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size) and finite,
            f"{phase}: logits {tuple(logits.shape)}, finite={finite}")


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def lm_prefill_phase(cfg, params, dev, counters, zero_counters):
    """One warm-up and LM_TIMED timed prefills of B = 2, S = 4096; returns
    the run's tallies and the median prefill's seconds."""
    import numpy as np
    times, logits, launches, tally, peak = lm_prefill_runs(
        cfg, params, dev, counters, zero_counters)
    runs = 1 + LM_TIMED
    med = float(np.median(times[1:]))
    emit("lm_prefill", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, batch=LM_BATCH, seq=LM_SEQ, cut="none",
         warmup_ms=times[0] * 1e3, prefill_ms=[t * 1e3 for t in times[1:]],
         prefill_ms_median=med * 1e3, tokens_per_s=LM_BATCH * LM_SEQ / med,
         peak_mem_bytes=peak, prefills=runs, launches=launches,
         launches_per_prefill={k: v / runs for k, v in launches.items()},
         logits_shape=list(logits.shape), finite=torch_isfinite(logits),
         max_abs_logit=float(logits.float().abs().max()))
    check_lm_prefill("lm_prefill", cfg, logits, launches, tally)
    return tally, med


def lm_prune_phase(cfg, params, dev, counters, zero_counters, dense_s):
    """Phase 6b: ``build_groups`` of the full bf16 model, ``l2_scores``
    timed (one warm-up, LM_TIMED timed: one group-L2 launch each over the
    two tail layers, plain ops for the stacked cycles), ``make_masks`` at
    LM_PRUNE_RATIO, ``compact`` timed, the pruned config and parameter
    count against ``count_params_analytic``, then LM_TIMED + 1 prefills
    of the pruned model beside the dense one's median ``dense_s``.
    Frees the pruned tree; returns the scores' and prefills' tallies."""
    import numpy as np
    import torch
    from repro_torch.convert import state_dict
    from repro_torch.core.pruning import (build_groups, compact, kept_count,
                                          l2_scores, make_masks)
    from repro_torch.metrics.flops import count_params_analytic

    groups = build_groups(cfg, params)
    note_aliases(params, groups)
    require(tuple(g.name for g in groups) == LM_PRUNE_GROUPS
            and [g.stacked for g in groups] == [12] * 6 + [0] * 4,
            f"lm_prune: groups {[(g.name, g.stacked) for g in groups]}")
    torch.cuda.synchronize()
    zero_counters()
    score_s = []
    for _ in range(1 + LM_TIMED):
        t0 = time.perf_counter()
        scores = l2_scores(params, groups)
        torch.cuda.synchronize()
        score_s.append(time.perf_counter() - t0)
    score_launches = {k: fn.launches for k, fn in counters.items()}
    score_tally = tally_of(counters)
    runs = 1 + LM_TIMED
    require(score_launches == {k: runs if k == "group_l2_norms" else 0
                               for k in counters}
            and not any(score_tally[k] for k in (
                "group_l2_norms_bwd", "block_masked_matmul_dx",
                "rglru_scan_bwd", "wkv6_bwd")),
            f"lm_prune: {runs} score evaluations launched {score_launches} "
            f"and backward {score_tally['group_l2_norms_bwd']}, want one "
            f"group-L2 forward each and nothing else")
    require(all(tuple(v.shape) == ((g.stacked, g.size) if g.stacked
                                   else (g.size,))
                and torch_isfinite(v) for g in groups
                for v in (scores[g.name],)),
            "lm_prune: a score has the wrong shape or is not finite")
    masks = make_masks(scores, groups, LM_PRUNE_RATIO)
    want = {"d_ff": kept_count(groups[1], LM_PRUNE_RATIO),
            "lru_width": kept_count(groups[0], LM_PRUNE_RATIO),
            "num_kv_heads": kept_count(groups[4], LM_PRUNE_RATIO)}
    want["num_heads"] = want["num_kv_heads"] * cfg.q_per_kv
    require(want == LM_PRUNED, f"lm_prune: kept_count gives {want}, the "
            f"phase expects {LM_PRUNED}")
    dense_n = sum(v.numel() for v in state_dict(params).values())
    dense_bytes = tensor_bytes(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    zero_counters()
    t0 = time.perf_counter()
    pruned, pcfg, report = compact(params, cfg, groups, masks)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    compact_peak = torch.cuda.max_memory_allocated(dev) - base
    compact_launches = {k: fn.launches for k, fn in counters.items()}
    leaves = state_dict(pruned)
    n = sum(v.numel() for v in leaves.values())
    analytic = count_params_analytic(pcfg)
    got = {k: getattr(pcfg, k) for k in LM_PRUNED}
    # bf16 everywhere but the fp32 leaves the port's init makes fp32
    dtypes = {k: str(v.dtype).removeprefix("torch.")
              for k, v in leaves.items()}
    dense_dtypes = {k: str(v.dtype).removeprefix("torch.")
                    for k, v in state_dict(params).items()}
    times, logits, launches, tally, peak = lm_prefill_runs(
        pcfg, pruned, dev, counters, zero_counters)
    med = float(np.median(times[1:]))
    emit("lm_prune", model=cfg.name, pruned_model=pcfg.name,
         layers=cfg.num_layers, dtype=cfg.dtype, ratio=LM_PRUNE_RATIO,
         groups=[[g.name, g.size, g.stacked, report[g.name][0]]
                 for g in groups],
         score_ms=[t * 1e3 for t in score_s[1:]],
         score_ms_median=float(np.median(score_s[1:])) * 1e3,
         score_warmup_ms=score_s[0] * 1e3, score_launches=score_launches,
         compact_ms=compact_s * 1e3, compact_peak_extra_bytes=compact_peak,
         compact_launches=compact_launches, config=got,
         params_dense=dense_n, params_pruned=n,
         params_pruned_analytic=analytic, bytes_dense=dense_bytes,
         bytes_pruned=tensor_bytes(pruned), batch=LM_BATCH, seq=LM_SEQ,
         warmup_ms=times[0] * 1e3, prefill_ms=[t * 1e3 for t in times[1:]],
         prefill_ms_median=med * 1e3,
         dense_prefill_ms_median=dense_s * 1e3,
         vs_dense=med / dense_s, tokens_per_s=LM_BATCH * LM_SEQ / med,
         peak_mem_bytes=peak, launches=launches,
         launches_per_prefill={k: v / (1 + LM_TIMED)
                               for k, v in launches.items()},
         scan_shapes=sorted(tally["rglru_scan"]),
         finite=torch_isfinite(logits))
    require(got == LM_PRUNED and pcfg.name == cfg.name + "-pruned",
            f"lm_prune: the pruned config is {pcfg.name} {got}, want "
            f"{LM_PRUNED}")
    require(n == analytic, f"lm_prune: the pruned tree holds {n} params, "
            f"count_params_analytic {analytic}")
    require(dtypes == dense_dtypes, "lm_prune: compaction changed a "
            "leaf's dtype")
    require(all(v == 0 for v in compact_launches.values()),
            f"lm_prune: compaction launched {compact_launches}")
    check_lm_prefill("lm_prune", pcfg, logits, launches, tally,
                     width=LM_PRUNED["lru_width"])
    del pruned, leaves
    torch.cuda.empty_cache()
    merge_tally(tally, score_tally)
    return tally


def lm_serve_phase(cfg, params, dev, counters, zero_counters,
                   phase="lm_serve", per_step=None):
    """``serve_requests`` with LM_SERVE; returns the run's tallies.
    ``per_step``: kernel -> the launches each decode step must make
    (rwkv6-7b's WKV, once a layer); every other kernel of the port, and
    every kernel of a model without ``per_step``, must launch 0 times
    (the decode step is plain tensor ops, as the reference's).  ``phase``
    names the line and the checks."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve_requests

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    res = serve_requests(params, cfg, seed=0, **LM_SERVE)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = {k: dict(fn.shapes) for k, fn in counters.items()}
    steps = np.asarray(res["step_seconds"])
    outs = res["outputs"]
    toks = [t for rid in sorted(outs) for t in outs[rid]]
    emit(phase, model=cfg.name, **LM_SERVE, steps=len(steps),
         generated=res["generated"], seconds=res["seconds"],
         tok_per_s=res["tok_per_s"],
         first_step_ms=float(steps[0] * 1e3),
         p50_step_ms=float(np.percentile(steps, 50) * 1e3),
         p99_step_ms=float(np.percentile(steps, 99) * 1e3),
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
         launches=launches, request0=outs[0][:8])
    want = LM_SERVE["requests"] * LM_SERVE["max_tokens"]
    require(sorted(outs) == list(range(LM_SERVE["requests"]))
            and all(len(v) == LM_SERVE["max_tokens"] for v in outs.values())
            and len(toks) == want,
            f"{phase}: {len(toks)} tokens over {len(outs)} requests, want "
            f"{want}")
    require(all(0 <= t < cfg.vocab_size for t in toks),
            f"{phase}: a token outside [0, vocab)")
    want_launches = {k: len(steps) * (per_step or {}).get(k, 0)
                     for k in launches}
    require(launches == want_launches,
            f"{phase}: the decode loop launched {launches}, want "
            f"{want_launches} ({per_step or 'no kernel'} a step)")
    return tally


def lm_consistency_phase(cfg, dev, counters, zero_counters):
    """Depth-LM_DEPTH fp32 model: the prefill's last logits (kernels)
    against decode's after the same tokens one by one (plain ops); then
    :func:`lm_prune_consistency` on the same weights and tokens."""
    import numpy as np
    import torch
    from repro_torch.convert import state_dict
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import model

    gen = torch.Generator(dev)
    gen.manual_seed(1)
    params = model.init(cfg, gen, device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, LM_CONSISTENCY_SEQ))).to(dev)
    zero_counters()
    t0 = time.perf_counter()
    pre = build_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    cache = model.init_cache(params, cfg, 1, LM_CONSISTENCY_SEQ)
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(LM_CONSISTENCY_SEQ):
            dec, cache = model.decode(params, cache, cfg, toks[:, t:t + 1])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    after = {k: fn.launches for k, fn in counters.items()}
    dec = dec[:, 0]
    err = float((pre - dec).abs().max())
    scale = float(dec.abs().max())
    n_rec, n_attn = lm_kinds(cfg)
    prune, prune_tally = lm_prune_consistency(cfg, params, toks, dev,
                                              counters, zero_counters)
    merge_tally(tally, prune_tally)
    emit("lm_consistency", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, seq=LM_CONSISTENCY_SEQ,
         window=cfg.sliding_window, cut=f"depth {LM_DEPTH} of 38",
         params=sum(v.numel() for v in state_dict(params).values()),
         prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s * 1e3
         / LM_CONSISTENCY_SEQ, max_abs_err=err, max_abs_logit=scale,
         tol=LM_TOL * scale, same_argmax=bool(
             torch.equal(pre.argmax(-1), dec.argmax(-1))),
         prefill_launches=launches, prune=prune)
    require(launches["rglru_scan"] == n_rec
            and launches["flash_attention"] == n_attn,
            f"lm_consistency: prefill launches {launches}, want {n_rec} "
            f"scans and {n_attn} attentions")
    require(after == launches,
            f"lm_consistency: decode launched a kernel: {after}")
    require(bool(torch.isfinite(pre).all()) and scale > 0
            and err <= LM_TOL * scale,
            f"lm_consistency: prefill vs decode logits err {err} > "
            f"{LM_TOL} x {scale}")
    p = prune
    require(p["mask_vs_compact_err"] <= p["mask_vs_compact_tol"],
            f"lm_consistency: masked vs compacted logits err "
            f"{p['mask_vs_compact_err']} > {p['mask_vs_compact_tol']}")
    require(p["prune_launches"] == p["prune_launches_want"],
            f"lm_consistency: scoring and the two prefills launched "
            f"{p['prune_launches']}, want {p['prune_launches_want']}")
    require(p["omega_launches"] == p["omega_launches_want"],
            f"lm_consistency: Omega and its gradient launched "
            f"{p['omega_launches']}, want {p['omega_launches_want']}")
    require(p["omega_err"] <= p["omega_tol"],
            f"lm_consistency: Omega {p['omega']} off the plain route's by "
            f"{p['omega_err']} > {p['omega_tol']}")
    require(p["omega_grad_err_rel"] <= GRAD_TOL,
            f"lm_consistency: an Omega gradient leaf is off the plain "
            f"route's by {p['omega_grad_err_rel']} of its largest, past "
            f"{GRAD_TOL}")
    return tally


def lm_prune_consistency(cfg, params, toks, dev, counters, zero_counters):
    """On the depth-LM_DEPTH fp32 model (one stacked cycle and the
    unstacked two-layer tail): the prefill's last logits of the model
    with its pruned units zeroed (``apply_masks``) against the
    compacted model's, within LM_TOL of max|logit|, from one score
    evaluation (one group-L2 launch) and masks at LM_PRUNE_RATIO; then
    Omega and its gradient in every member leaf, one forward and one
    backward group-L2 launch, against the plain route on CPU copies of
    the layers.  Returns (the line's fields, the launches' tallies)."""
    import torch
    from repro_torch.core.pruning import (apply_masks, build_groups,
                                          compact, depth_lambdas, get_path,
                                          l2_scores, make_masks, omega,
                                          set_path)
    from repro_torch.launch.steps import build_prefill_step

    groups = build_groups(cfg, params)
    note_aliases(params, groups)
    n_rec, n_attn = lm_kinds(cfg)
    zero_counters()
    masks = make_masks(l2_scores(params, groups), groups, LM_PRUNE_RATIO)
    masked = apply_masks(params, groups, masks)
    pre_masked = build_prefill_step(cfg)(masked, {"tokens": toks})
    del masked
    pruned, pcfg, _ = compact(params, cfg, groups, masks)
    pre_pruned = build_prefill_step(pcfg)(pruned, {"tokens": toks})
    torch.cuda.synchronize()
    del pruned
    prune_launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    err = float((pre_masked - pre_pruned).abs().max())
    scale = float(pre_masked.abs().max())

    paths = list(dict.fromkeys(m.path for g in groups for m in g.members))
    lam = depth_lambdas(groups, LM_OMEGA_LAMBDA0)
    layers = {"cycles": params["cycles"], "tail": params["tail"]}

    def omega_and_grads(tree):
        leaves = [get_path(tree, p).detach().requires_grad_()
                  for p in paths]
        for p, leaf in zip(paths, leaves):
            tree = set_path(tree, p, leaf)
        om = omega(tree, groups, lam)
        return om.detach(), torch.autograd.grad(om, leaves)

    zero_counters()
    om, grads = omega_and_grads(layers)
    torch.cuda.synchronize()
    omega_launches = {k: fn.launches for k, fn in counters.items()}
    omega_launches["group_l2_norms_bwd"] = \
        counters["group_l2_norms"].bwd_launches
    merge_tally(tally, tally_of(counters))
    om_cpu, grads_cpu = omega_and_grads(to_device(layers, "cpu"))
    # a leaf the init zeroes (the gates' biases) has a zero gradient
    grad_rel = max(float((g.cpu() - w).abs().max())
                   / (float(w.abs().max()) or 1.0)
                   for g, w in zip(grads, grads_cpu))
    kernels = dict.fromkeys(counters, 0)
    return {"pruned_model": pcfg.name, "lru_width": pcfg.lru_width,
            "d_ff": pcfg.d_ff, "mask_vs_compact_err": err,
            "max_abs_logit": scale, "mask_vs_compact_tol": LM_TOL * scale,
            "prune_launches": prune_launches,
            "prune_launches_want": {**kernels, "group_l2_norms": 1,
                                    "rglru_scan": 2 * n_rec,
                                    "flash_attention": 2 * n_attn},
            "omega": float(om), "omega_plain": float(om_cpu),
            "omega_err": abs(float(om) - float(om_cpu)),
            "omega_tol": TOL["float32"] * abs(float(om_cpu)),
            "omega_grad_leaves": len(grads), "omega_grad_err_rel": grad_rel,
            "omega_launches": omega_launches,
            "omega_launches_want": {**kernels, "group_l2_norms": 1,
                                    "group_l2_norms_bwd": 1}}, tally


# ---------------------------------------------------------------------------
# phases 7h-7i: RecurrentGemma training
# ---------------------------------------------------------------------------

def lm_train_batch(cfg, dev, seq, seed):
    """B = 1 token ids from a numpy seed; the labels are the tokens
    shifted by one, the last position -1."""
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, seq))
    labels = np.concatenate([toks[:, 1:], -np.ones((1, 1), np.int64)], 1)
    return {"tokens": torch.from_numpy(toks).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def tensor_bytes(tree):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lm_train_phase(dev, counters, zero_counters, out_dir, profile=False):
    """``build_opt_init`` and LM_TRAIN_WARMUP + LM_TIMED steps of
    ``build_train_step`` on the same batch: full-width recurrentgemma-9b
    at LM_TRAIN_DEPTH layers, bf16 params from ``model.init`` over an
    fp32 master, fp32 moments, remat on, B = 1, S = LM_TRAIN_SEQ (past
    the 2048 window); with ``profile``, one more step under
    ``torch.profiler`` (:func:`profiled`).  Then the training CLI on the
    card.  Returns the steps' tallies."""
    import numpy as np
    import torch
    from repro_torch import checkpoint
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import state_dict
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.launch.steps import build_opt_init, build_train_step
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves

    cfg = get_config(LM_ARCH).replace(num_layers=LM_TRAIN_DEPTH)
    n_rec, n_attn = lm_kinds(cfg)
    gen = torch.Generator(dev)
    gen.manual_seed(2)
    params = model.init(cfg, gen, device=dev)
    opt = build_opt_init(cfg)(params)
    n = sum(p.numel() for p in tree_leaves(params))
    resident = tensor_bytes(params) + tensor_bytes(opt)
    allocated = torch.cuda.memory_allocated(dev)
    batch = lm_train_batch(cfg, dev, LM_TRAIN_SEQ, 3)
    step = build_train_step(cfg, lr=LM_TRAIN_LR)
    runs = LM_TRAIN_WARMUP + LM_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    times, losses = [], []
    for i in range(runs):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    bwd = scan.rglru_scan.bwd_launches
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(x) for x in losses]
    master_cast = all(torch.equal(p, m.to(p.dtype)) for p, m in
                      zip(tree_leaves(params), tree_leaves(opt.master)))
    med = float(np.median(times[LM_TRAIN_WARMUP:]))
    total = torch.cuda.get_device_properties(dev).total_memory
    want = {"rglru_scan": 2 * n_rec * runs, "rglru_scan_bwd": n_rec * runs,
            "flash_attention": 2 * n_attn * runs}
    got = {"rglru_scan": launches["rglru_scan"], "rglru_scan_bwd": bwd,
           "flash_attention": launches["flash_attention"]}
    emit("lm_train", model=cfg.name, layers=cfg.num_layers,
         cut=f"depth 38 -> {LM_TRAIN_DEPTH}", params=n, dtype=cfg.dtype,
         param_dtype=cfg.param_dtype, master="float32", moments="float32",
         remat=True, batch=1, seq=LM_TRAIN_SEQ, window=cfg.sliding_window,
         lr=LM_TRAIN_LR, losses=losses, warmup_ms=times[0] * 1e3,
         step_ms=[t * 1e3 for t in times[LM_TRAIN_WARMUP:]],
         step_ms_p50=med * 1e3, tokens_per_s=LM_TRAIN_SEQ / med,
         peak_mem_bytes=peak, card_mem_bytes=total,
         state_bytes=resident, state_allocated_bytes=allocated,
         state_estimate_bytes=14 * n,
         state_with_grads_estimate_bytes=LM_BYTES_PER_PARAM * n,
         launches={**launches, "rglru_scan_bwd": bwd},
         launches_want=want, params_are_master_cast=master_cast)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"lm_train: losses {losses} are not finite and falling")
    require(got == want, f"lm_train: launches {got}, want {want} (remat: "
            f"a forward and a recompute a step)")
    require(launches["block_masked_matmul"] == 0
            and launches["group_l2_norms"] == 0,
            f"lm_train: a U-Net kernel was launched: {launches}")
    require(master_cast, "lm_train: a bf16 param is not its master's cast")
    require(peak < total, f"lm_train: peak {peak} >= the card's {total}")
    if profile:
        os.makedirs(out_dir, exist_ok=True)
        emit("profile", run="lm_train step, profiled", seq=LM_TRAIN_SEQ,
             **profiled(lambda: step(params, opt, batch, runs),
                        os.path.join(out_dir, "lm_train_profile.txt")))
    del params, opt, batch, step
    torch.cuda.empty_cache()

    # the CLI: the smoke variant on the default device, and its checkpoint
    ckpt = os.path.join(out_dir, "lm_train", "lm.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(HERE, "src"), os.environ.get("PYTHONPATH"))
        if p))
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", LM_ARCH, "--steps", "3", "--ckpt", ckpt],
                         cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=600)
    cli_s = time.perf_counter() - t0
    require(cli.returncode == 0, f"lm_train CLI failed: {cli.stderr[-2000:]}")
    tree, meta = checkpoint.load(ckpt)
    lines = cli.stdout.strip().splitlines()
    small = smoke_variant(LM_ARCH)
    want_keys = set(state_dict(model.init(small, torch.Generator(),
                                          device="cpu")))
    emit("lm_train_cli", seconds=cli_s, stdout_tail=lines[-3:],
         checkpoint_leaves=len(state_dict(tree)), metadata=meta)
    require(set(state_dict(tree)) == want_keys
            and meta["arch"] == small.name and meta["steps"] == 3
            and np.isfinite(meta["final_loss"]),
            f"lm_train CLI: the checkpoint does not hold the smoke model "
            f"({meta})")
    return tally


def host_memory():
    """(MemTotal, MemAvailable) in bytes, from /proc/meminfo."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            info[k] = int(v.split()[0]) * 1024
    return info.get("MemTotal"), info.get("MemAvailable")


def lm_grad_phase(dev, counters):
    """One loss and gradient of full-width recurrentgemma-9b at
    LM_TRAIN_DEPTH layers in fp32 (TF32 off), B = 1, S = LM_GRAD_SEQ,
    through the kernels and through the plain versions on CPU copies of
    the weights; every leaf within GRAD_TOL of the largest plain
    gradient, and every leaf also within GRAD_LEAF_TOL of its own
    largest: phase 10's floor (GRAD_LEAF_FLOOR) is for the U-Net's
    GroupNorm-fed biases, whose gradients cancel to rounding level, and
    the LM has no such leaf, while its RG-LRU gates (``w_a``, ``b_a``,
    ``log_lambda``: their gradient comes only through the scan
    backward's da) sit far below that floor.  The line gives each leaf's
    largest plain gradient and its error relative to it, and names the
    worst."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import state_dict
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves

    cpu = torch.device("cpu")
    cfg = get_config(LM_ARCH).replace(num_layers=LM_TRAIN_DEPTH,
                                      dtype="float32", param_dtype="float32")
    gen = torch.Generator(dev)
    gen.manual_seed(4)
    params = model.init(cfg, gen, device=dev)
    batch = lm_train_batch(cfg, dev, LM_GRAD_SEQ, 5)

    def loss_and_grads(params, batch):
        leaves = tree_leaves(params)
        for v in leaves:
            v.requires_grad_()
        loss = model.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        for v in leaves:
            v.requires_grad_(False)
        return float(loss.detach()), grads

    before = {k: fn.launches for k, fn in counters.items()}
    bwd0 = scan.rglru_scan.bwd_launches
    loss, grads = loss_and_grads(params, batch)
    torch.cuda.synchronize()
    ran = {k: fn.launches - before[k] for k, fn in counters.items()}
    ran["rglru_scan_bwd"] = scan.rglru_scan.bwd_launches - bwd0
    t0 = time.perf_counter()
    cparams = to_device(params, cpu)
    del params
    mem_total, mem_free = host_memory()
    want_loss, want = loss_and_grads(cparams, to_device(batch, cpu))
    cpu_s = time.perf_counter() - t0
    after = {k: fn.launches for k, fn in counters.items()}
    names = list(state_dict(cparams))
    scale = max(float(g.abs().max()) for g in want)
    errs = [float((a.to(cpu) - b).abs().max()) for a, b in zip(grads, want)]
    own = [float(b.abs().max()) for b in want]
    rel = {n: e / m if m > 0 else float("inf")
           for n, e, m in zip(names, errs, own)}
    worst = max(rel, key=rel.get)
    emit("lm_grad", model=cfg.name, layers=cfg.num_layers, dtype="float32",
         seq=LM_GRAD_SEQ, params=sum(g.numel() for g in want), loss=loss,
         loss_plain=want_loss, loss_err=abs(loss - want_loss),
         leaves=len(want), max_abs_grad_plain=scale,
         max_abs_grad_err=max(errs), tol=GRAD_TOL * scale,
         worst_leaf=worst, worst_leaf_rel_err=rel[worst],
         leaf_tol_rel=GRAD_LEAF_TOL,
         leaf_max_abs_plain=dict(zip(names, own)), leaf_rel_err=rel,
         kernel_launches=ran, cpu_seconds=cpu_s,
         host_mem_total_bytes=mem_total,
         host_mem_available_bytes_with_cpu_params=mem_free,
         cpu_copy_bytes=2 * tensor_bytes(cparams))
    require(ran["rglru_scan"] > 0 and ran["rglru_scan_bwd"] > 0
            and ran["flash_attention"] > 0,
            f"lm_grad: the card's pass skipped a kernel: {ran}")
    require(after == {k: before[k] + ran[k] for k in before},
            "lm_grad: the plain pass launched a kernel")
    require(abs(loss - want_loss) <= FORWARD_TOL * abs(want_loss),
            f"lm_grad: loss {loss} vs plain {want_loss}")
    require(max(errs) <= GRAD_TOL * scale and scale > 0,
            f"lm_grad: gradient err {max(errs)} > {GRAD_TOL} x {scale}")
    require(rel[worst] <= GRAD_LEAF_TOL,
            f"lm_grad: leaf {worst}'s gradient is {rel[worst]} of its own "
            f"max|plain| off (limit {GRAD_LEAF_TOL})")
    del grads, want, cparams
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7j-7m: the MoE and MLA decoders
# ---------------------------------------------------------------------------

def flash_key(cfg, batch, seq, dtype):
    """The attention kernel's tally key for a decoder's causal global
    layers: GQA heads are expanded before the launch."""
    return (batch * cfg.num_heads, seq, seq, cfg.head_dim, True, 0, dtype)


def moe_prefill_phase(cfg, params, dev, counters, zero_counters):
    """Full-width, full-depth MoE prefill: one warm-up and LM_TIMED timed
    prefills of B = 2, S = 4096; exactly one attention launch a layer,
    at the key :func:`flash_key` gives; the pairs the capacity dropped.
    Returns the run's tallies."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.metrics import flops
    from repro_torch.models import moe

    step = build_prefill_step(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (LM_BATCH, LM_SEQ))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    moe.apply_moe.dropped = 0
    times = []
    for _ in range(1 + LM_TIMED):
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    runs = 1 + LM_TIMED
    dropped = int(moe.apply_moe.dropped)
    m = cfg.moe
    n_moe = cfg.num_layers - m.first_dense_layers
    tokens = LM_BATCH * LM_SEQ
    med = float(np.median(times[1:]))
    work = flops.model_flops(cfg, InputShape("moe_prefill", LM_SEQ,
                                             LM_BATCH, "prefill"))
    finite = bool(torch.isfinite(logits).all())
    key = flash_key(cfg, LM_BATCH, LM_SEQ, cfg.dtype)
    emit("moe_prefill", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, batch=LM_BATCH, seq=LM_SEQ, cut="none",
         params=flops.count_params_analytic(cfg),
         active_params=flops.active_params(cfg),
         param_bytes=tensor_bytes(params), model_flops=work,
         warmup_ms=times[0] * 1e3, prefill_ms=[t * 1e3 for t in times[1:]],
         prefill_ms_median=med * 1e3, tokens_per_s=tokens / med,
         model_tflops_per_s=work / med / 1e12,
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
         capacity=moe.capacity(tokens, m.experts_per_token, m.num_experts,
                               m.capacity_factor),
         pairs_per_prefill=n_moe * tokens * m.experts_per_token,
         pairs_dropped_per_prefill=dropped / runs, prefills=runs,
         launches=launches, flash_shapes={str(k): v for k, v in
                                          tally["flash_attention"].items()},
         logits_shape=list(logits.shape), finite=finite,
         max_abs_logit=float(logits.float().abs().max()))
    require(tally["flash_attention"] == {key: cfg.num_layers * runs},
            f"moe_prefill: attention launches {tally['flash_attention']} "
            f"over {runs} prefills, want {cfg.num_layers} a prefill at "
            f"{key}")
    require(launches["block_masked_matmul"] == 0
            and launches["group_l2_norms"] == 0
            and launches["rglru_scan"] == 0,
            f"moe_prefill: another kernel was launched: {launches}")
    require(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size) and finite,
            f"moe_prefill: logits {tuple(logits.shape)}, finite={finite}")
    return tally


def moe_consistency_phase(label, arch, depth, dev, counters, zero_counters):
    """``arch`` at full width cut to ``depth`` layers, fp32 (TF32 off):
    the prefill's last logits over MOE_CONSISTENCY_SEQ tokens (at most 8:
    the capacity is at least 8, so no pair can drop) against the decode
    logits after the same tokens one by one, within LM_TOL of
    max|logit|; no pair dropped, one attention launch a non-MLA layer
    (MLA attends in plain ops), none while decoding.  Returns the
    prefill's tallies."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.metrics import flops
    from repro_torch.models import model, moe

    full = get_config(arch)
    cfg = full.replace(num_layers=depth, dtype="float32",
                       param_dtype="float32")
    gen = torch.Generator(dev)
    gen.manual_seed(5)
    t0 = time.perf_counter()
    params = model.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    seq = MOE_CONSISTENCY_SEQ
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, seq))).to(dev)
    zero_counters()
    moe.apply_moe.dropped = 0
    t0 = time.perf_counter()
    pre = build_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    dropped_prefill = int(moe.apply_moe.dropped)
    cache = model.init_cache(params, cfg, 1, seq)
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(seq):
            dec, cache = model.decode(params, cache, cfg, toks[:, t:t + 1])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    after = {k: fn.launches for k, fn in counters.items()}
    dropped = int(moe.apply_moe.dropped)
    dec = dec[:, 0]
    err = float((pre - dec).abs().max())
    scale = float(dec.abs().max())
    want = {} if cfg.mla else {flash_key(cfg, 1, seq, "float32"): depth}
    emit("moe_consistency", model=arch, label=label, layers=depth,
         cut=f"depth {full.num_layers} -> {depth}", dtype="float32",
         params=flops.count_params_analytic(cfg),
         param_bytes=tensor_bytes(params), init_s=init_s, seq=seq,
         attention="mla (plain attend; absorbed decode)" if cfg.mla
         else f"flash (heads {cfg.num_heads}, kv {cfg.num_kv_heads})",
         prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s * 1e3
         / seq, max_abs_err=err, max_abs_logit=scale, tol=LM_TOL * scale,
         same_argmax=bool(torch.equal(pre.argmax(-1), dec.argmax(-1))),
         pairs_dropped_prefill=dropped_prefill,
         pairs_dropped=dropped, prefill_launches=launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    require(tally["flash_attention"] == want,
            f"moe_consistency {label}: attention launches "
            f"{tally['flash_attention']}, want {want}")
    require(after == launches,
            f"moe_consistency {label}: decode launched a kernel: {after}")
    require(dropped == 0, f"moe_consistency {label}: {dropped} pairs "
                          f"dropped, want 0")
    require(bool(torch.isfinite(pre).all()) and scale > 0
            and err <= LM_TOL * scale,
            f"moe_consistency {label}: prefill vs decode logits err {err} "
            f"> {LM_TOL} x {scale}")
    del params, cache
    torch.cuda.empty_cache()
    return tally


def moe_train_phase(dev, counters, zero_counters):
    """``build_opt_init`` and LM_TRAIN_WARMUP + LM_TIMED steps of
    ``build_train_step`` on the same batch: full-width MOE_ARCH cut to
    MOE_TRAIN_DEPTH layers (its dense head layer and 3 MoE layers), bf16
    params over an fp32 master, fp32 moments, remat on, B = 1,
    S = LM_TRAIN_SEQ, lr LM_TRAIN_LR: finite, falling losses, the aux
    loss above 0 (one more forward after the steps), exactly one
    attention launch a step for the head layer and two for each cycle
    (remat recomputes the cycles, not the head), every bf16 param its
    master's cast bitwise, the peak below the card's memory.  Returns
    the steps' tallies."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_opt_init, build_train_step
    from repro_torch.metrics import flops
    from repro_torch.models import model, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves

    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_TRAIN_DEPTH)
    plan = tfm.stack_plan(cfg)
    gen = torch.Generator(dev)
    gen.manual_seed(6)
    params = model.init(cfg, gen, device=dev)
    opt = build_opt_init(cfg)(params)
    n = sum(p.numel() for p in tree_leaves(params))
    resident = tensor_bytes(params) + tensor_bytes(opt)
    batch = lm_train_batch(cfg, dev, LM_TRAIN_SEQ, 7)
    step = build_train_step(cfg, lr=LM_TRAIN_LR)
    runs = LM_TRAIN_WARMUP + LM_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    moe.apply_moe.dropped = 0
    times, losses = [], []
    for i in range(runs):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    dropped = int(moe.apply_moe.dropped)
    losses = [float(x) for x in losses]
    with torch.no_grad():
        _, aux = tfm.forward(params, cfg, batch)
    aux = float(aux)
    master_cast = all(torch.equal(p, m.to(p.dtype)) for p, m in
                      zip(tree_leaves(params), tree_leaves(opt.master)))
    med = float(np.median(times[LM_TRAIN_WARMUP:]))
    total = torch.cuda.get_device_properties(dev).total_memory
    per_step = plan.n_head + 2 * plan.n_cycles * len(plan.pattern)
    key = flash_key(cfg, 1, LM_TRAIN_SEQ, cfg.dtype)
    emit("moe_train", model=cfg.name, layers=cfg.num_layers,
         cut=f"depth 48 -> {MOE_TRAIN_DEPTH}", params=n,
         params_analytic=flops.count_params_analytic(cfg),
         dtype=cfg.dtype, param_dtype=cfg.param_dtype, master="float32",
         moments="float32", remat=True, batch=1, seq=LM_TRAIN_SEQ,
         lr=LM_TRAIN_LR, losses=losses, aux_after=aux,
         warmup_ms=times[0] * 1e3,
         step_ms=[t * 1e3 for t in times[LM_TRAIN_WARMUP:]],
         step_ms_p50=med * 1e3, tokens_per_s=LM_TRAIN_SEQ / med,
         peak_mem_bytes=peak, card_mem_bytes=total, state_bytes=resident,
         state_with_grads_estimate_bytes=LM_BYTES_PER_PARAM * n,
         pairs_dropped=dropped, launches=launches,
         launches_want={"flash_attention": per_step * runs},
         params_are_master_cast=master_cast)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"moe_train: losses {losses} are not finite and falling")
    require(np.isfinite(aux) and aux > 0, f"moe_train: aux {aux}, want > 0")
    require(tally["flash_attention"] == {key: per_step * runs},
            f"moe_train: attention launches {tally['flash_attention']}, "
            f"want {per_step * runs} at {key}")
    require(launches["block_masked_matmul"] == 0
            and launches["group_l2_norms"] == 0
            and launches["rglru_scan"] == 0,
            f"moe_train: another kernel was launched: {launches}")
    require(master_cast, "moe_train: a bf16 param is not its master's cast")
    require(peak < total, f"moe_train: peak {peak} >= the card's {total}")
    del params, opt, batch, step
    torch.cuda.empty_cache()
    return tally


def moe_phases(dev, counters, zero_counters, profile_dir=None):
    """Phases 7j-7m in order, each model freed before the next; returns
    path -> tallies.  With ``profile_dir``, one more prefill and
    LM_PROFILE_STEPS decode steps of moonshot under ``torch.profiler``
    after moe_serve (:func:`lm_profile_phase`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model

    tallies = {}
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    emit("moe_init", model=cfg.name, seconds=time.perf_counter() - t0,
         param_bytes=tensor_bytes(params),
         allocated_bytes=torch.cuda.memory_allocated(dev))
    tallies["moe_prefill"] = moe_prefill_phase(cfg, params, dev, counters,
                                               zero_counters)
    torch.cuda.empty_cache()
    tallies["moe_serve"] = lm_serve_phase(cfg, params, dev, counters,
                                          zero_counters, phase="moe_serve")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        lm_profile_phase(cfg, params, dev, profile_dir, name="moe")
    del params
    torch.cuda.empty_cache()
    for label, arch, depth in MOE_CONSISTENCY:
        tallies[f"moe_consistency_{label}"] = moe_consistency_phase(
            label, arch, depth, dev, counters, zero_counters)
    tallies["moe_train"] = moe_train_phase(dev, counters, zero_counters)
    return tallies


# ---------------------------------------------------------------------------
# phases 7n-7q: the dense extras (soft-capping, parallel blocks, the VLM
# prefix, the encoder and cross-attention)
# ---------------------------------------------------------------------------

def dense_prefill_phase(cfg, params, dev, counters, zero_counters):
    """Full-width, full-depth DENSE_ARCH prefill: one warm-up and
    LM_TIMED timed prefills of B = 2, S = 4096; exactly one attention
    launch a layer (every layer causal, no soft-capping) at the key
    :func:`flash_key` gives, GQA expanded before it.  Returns the run's
    tallies."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.metrics import flops

    step = build_prefill_step(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (LM_BATCH, LM_SEQ))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    times = []
    for _ in range(1 + LM_TIMED):
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    runs = 1 + LM_TIMED
    med = float(np.median(times[1:]))
    work = flops.model_flops(cfg, InputShape("dense_prefill", LM_SEQ,
                                             LM_BATCH, "prefill"))
    finite = bool(torch.isfinite(logits).all())
    key = flash_key(cfg, LM_BATCH, LM_SEQ, cfg.dtype)
    peak = torch.cuda.max_memory_allocated(dev)
    # ops.attention's repeat of K and V to every query head, one layer
    kv_copy = 2 * LM_BATCH * LM_SEQ * cfg.num_heads * cfg.head_dim * 2
    emit("dense_prefill", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, batch=LM_BATCH, seq=LM_SEQ, cut="none",
         parallel_block=cfg.parallel_block,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         params=flops.count_params_analytic(cfg),
         param_bytes=tensor_bytes(params), model_flops=work,
         warmup_ms=times[0] * 1e3, prefill_ms=[t * 1e3 for t in times[1:]],
         prefill_ms_median=med * 1e3, tokens_per_s=LM_BATCH * LM_SEQ / med,
         model_tflops_per_s=work / med / 1e12, peak_mem_bytes=peak,
         resident_bytes=resident, peak_over_resident_bytes=peak - resident,
         gqa_kv_copy_bytes_per_layer=kv_copy, prefills=runs,
         launches=launches, flash_shapes={str(k): v for k, v in
                                          tally["flash_attention"].items()},
         logits_shape=list(logits.shape), finite=finite,
         max_abs_logit=float(logits.float().abs().max()))
    require(tally["flash_attention"] == {key: cfg.num_layers * runs},
            f"dense_prefill: attention launches {tally['flash_attention']} "
            f"over {runs} prefills, want {cfg.num_layers} a prefill at "
            f"{key}")
    require(launches["block_masked_matmul"] == 0
            and launches["group_l2_norms"] == 0
            and launches["rglru_scan"] == 0,
            f"dense_prefill: another kernel was launched: {launches}")
    require(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size) and finite,
            f"dense_prefill: logits {tuple(logits.shape)}, finite={finite}")
    return tally


def dense_consistency_phase(label, arch, depth, dev, counters,
                            zero_counters):
    """``arch`` at full width and ``depth`` layers, fp32 (TF32 off): the
    prefill's last logits against the decode logits after the same
    positions one by one, within DENSE_TOL of max|logit|.  internvl2's
    256 image positions (``num_image_tokens``) carry the token
    embeddings of chosen ids, which decode then feeds before the text; whisper's cache
    holds the prefill's encoder output (random frames), and its cross
    q/k/v biases are zero (the init's), since the reference's decode
    leaves them out; gemma2's soft-capping is on.  One attention launch
    a causal layer without soft-capping (none for gemma2, the encoder
    or cross-attention), none while decoding.  Returns the prefill's
    tallies."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.metrics import flops
    from repro_torch.models import model
    from repro_torch.models import transformer as tfm

    full = get_config(arch)
    cfg = full.replace(num_layers=depth, dtype="float32",
                       param_dtype="float32")
    gen = torch.Generator(dev)
    gen.manual_seed(8)
    t0 = time.perf_counter()
    params = model.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    r = np.random.default_rng(8)
    toks = torch.from_numpy(r.integers(
        0, cfg.vocab_size, (1, DENSE_CONSISTENCY_SEQ))).to(dev)
    batch, feed, enc = {"tokens": toks}, toks, None
    if cfg.arch_type == "vlm":
        ids = torch.from_numpy(r.integers(
            0, cfg.vocab_size, (1, cfg.num_image_tokens))).to(dev)
        batch["image_embeds"] = params["embed"][ids]
        feed = torch.cat([ids, toks], dim=1)
    if cfg.arch_type == "encdec":
        batch["frames"] = torch.randn(1, cfg.encoder_seq_len, cfg.d_model,
                                      generator=gen, device=dev)
        require(not any(params["cycles"][0]["cross"][b].any()
                        for b in ("bq", "bk", "bv")),
                f"dense_consistency {label}: cross q/k/v biases not 0")
    zero_counters()
    t0 = time.perf_counter()
    pre = build_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    if cfg.arch_type == "encdec":
        with torch.no_grad():
            enc = tfm.apply_encoder(params, batch["frames"], cfg)
    seq = feed.shape[1]
    cache = tfm.init_cache(params, cfg, 1, seq, enc_out=enc)
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(seq):
            dec = model.decode_(params, cache, cfg, feed[:, t:t + 1])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    after = {k: fn.launches for k, fn in counters.items()}
    dec = dec[:, 0]
    err = float((pre - dec).abs().max())
    scale = float(dec.abs().max())
    causal = 0 if cfg.attn_softcap else depth
    want = {flash_key(cfg, 1, seq, "float32"): causal} if causal else {}
    emit("dense_consistency", model=arch, label=label, layers=depth,
         encoder_layers=cfg.num_encoder_layers
         if cfg.arch_type == "encdec" else 0,
         cut=f"depth {full.num_layers} -> {depth}" if depth <
         full.num_layers else "none", dtype="float32",
         params=flops.count_params_analytic(cfg),
         param_bytes=tensor_bytes(params), init_s=init_s, seq=seq,
         text_tokens=DENSE_CONSISTENCY_SEQ, attn_softcap=cfg.attn_softcap,
         logit_softcap=cfg.logit_softcap,
         parallel_block=cfg.parallel_block, arch_type=cfg.arch_type,
         prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s * 1e3
         / seq, max_abs_err=err, max_abs_logit=scale,
         tol=DENSE_TOL * scale,
         same_argmax=bool(torch.equal(pre.argmax(-1), dec.argmax(-1))),
         prefill_launches=launches,
         flash_shapes={str(k): v for k, v in
                       tally["flash_attention"].items()},
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    require(tally["flash_attention"] == want,
            f"dense_consistency {label}: attention launches "
            f"{tally['flash_attention']}, want {want}")
    require(after == launches,
            f"dense_consistency {label}: decode launched a kernel: {after}")
    require(bool(torch.isfinite(pre).all()) and scale > 0
            and err <= DENSE_TOL * scale,
            f"dense_consistency {label}: prefill vs decode logits err {err} "
            f"> {DENSE_TOL} x {scale}")
    del params, cache
    torch.cuda.empty_cache()
    return tally


def dense_train_phase(dev, counters, zero_counters, profile_dir=None):
    """``build_opt_init`` and LM_TRAIN_WARMUP + LM_TIMED steps of
    ``build_train_step`` on the same batch: full-width, full-depth
    DENSE_TRAIN_ARCH (gemma2: every layer soft-capped, so attention takes
    the plain route and the kernel is launched 0 times), bf16 params
    over an fp32 master, fp32 moments, remat on, B = 1,
    S = LM_TRAIN_SEQ, lr LM_TRAIN_LR: finite, falling losses, every
    bf16 param its master's cast bitwise, the peak below the card's
    memory, beside 16 B a param; with ``profile_dir``, one more step
    under ``torch.profiler``.  Returns the steps' tallies."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_opt_init, build_train_step
    from repro_torch.metrics import flops
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves

    cfg = get_config(DENSE_TRAIN_ARCH)
    gen = torch.Generator(dev)
    gen.manual_seed(9)
    params = model.init(cfg, gen, device=dev)
    opt = build_opt_init(cfg)(params)
    n = sum(p.numel() for p in tree_leaves(params))
    resident = tensor_bytes(params) + tensor_bytes(opt)
    batch = lm_train_batch(cfg, dev, LM_TRAIN_SEQ, 10)
    step = build_train_step(cfg, lr=LM_TRAIN_LR)
    runs = LM_TRAIN_WARMUP + LM_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    times, losses = [], []
    for i in range(runs):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(x) for x in losses]
    master_cast = all(torch.equal(p, m.to(p.dtype)) for p, m in
                      zip(tree_leaves(params), tree_leaves(opt.master)))
    med = float(np.median(times[LM_TRAIN_WARMUP:]))
    total = torch.cuda.get_device_properties(dev).total_memory
    emit("dense_train", model=cfg.name, layers=cfg.num_layers, cut="none",
         params=n, params_analytic=flops.count_params_analytic(cfg),
         attn_softcap=cfg.attn_softcap, logit_softcap=cfg.logit_softcap,
         dtype=cfg.dtype, param_dtype=cfg.param_dtype, master="float32",
         moments="float32", remat=True, batch=1, seq=LM_TRAIN_SEQ,
         lr=LM_TRAIN_LR, losses=losses, warmup_ms=times[0] * 1e3,
         step_ms=[t * 1e3 for t in times[LM_TRAIN_WARMUP:]],
         step_ms_p50=med * 1e3, tokens_per_s=LM_TRAIN_SEQ / med,
         peak_mem_bytes=peak, card_mem_bytes=total, state_bytes=resident,
         state_with_grads_estimate_bytes=LM_BYTES_PER_PARAM * n,
         launches=launches, params_are_master_cast=master_cast)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"dense_train: losses {losses} are not finite and falling")
    require(not any(launches.values()) and not any(
        tally[k] for k in ("rglru_scan_bwd", "group_l2_norms_bwd",
                           "block_masked_matmul_dx")),
            f"dense_train: a kernel was launched (want 0 attention "
            f"launches, the softcap route): {launches}")
    require(master_cast, "dense_train: a bf16 param is not its master's "
                         "cast")
    require(peak < total, f"dense_train: peak {peak} >= the card's {total}")
    if profile_dir:
        emit("profile", run="dense_train step, profiled", seq=LM_TRAIN_SEQ,
             **profiled(lambda: step(params, opt, batch, runs),
                        os.path.join(profile_dir,
                                     "dense_train_profile.txt")))
    del params, opt, batch, step
    torch.cuda.empty_cache()
    return tally


def dense_phases(dev, counters, zero_counters, profile_dir=None):
    """Phases 7n-7q in order, each model freed before the next; returns
    path -> tallies.  With ``profile_dir``, one more prefill and
    LM_PROFILE_STEPS decode steps of DENSE_ARCH under ``torch.profiler``
    after dense_serve (:func:`lm_profile_phase`), and one more
    dense_train step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model

    tallies = {}
    torch.cuda.empty_cache()
    cfg = get_config(DENSE_ARCH)
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    emit("dense_init", model=cfg.name, seconds=time.perf_counter() - t0,
         param_bytes=tensor_bytes(params),
         allocated_bytes=torch.cuda.memory_allocated(dev),
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    tallies["dense_prefill"] = dense_prefill_phase(cfg, params, dev,
                                                   counters, zero_counters)
    torch.cuda.empty_cache()
    tallies["dense_serve"] = lm_serve_phase(cfg, params, dev, counters,
                                            zero_counters,
                                            phase="dense_serve")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        lm_profile_phase(cfg, params, dev, profile_dir, name="dense")
    del params
    torch.cuda.empty_cache()
    for label, arch, depth in DENSE_CONSISTENCY:
        tallies[f"dense_consistency_{label}"] = dense_consistency_phase(
            label, arch, depth, dev, counters, zero_counters)
    tallies["dense_train"] = dense_train_phase(dev, counters, zero_counters,
                                               profile_dir)
    return tallies


# ---------------------------------------------------------------------------
# phases 7r-7u: RWKV-6
# ---------------------------------------------------------------------------

def wkv_key(B, S, cfg):
    """The WKV wrapper's shape key of a launch over (B, S) tokens."""
    return (B, S, cfg.num_heads, cfg.head_dim, "float32")


def rwkv_prefill_phase(cfg, params, dev, counters, zero_counters):
    """Full-width, full-depth RWKV_ARCH prefill: one warm-up and
    LM_TIMED timed prefills of B = 2, S = 4096; exactly one WKV launch a
    layer at (2, 4096, 64, 64) and no other kernel.  Returns the run's
    tallies."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.metrics import flops

    step = build_prefill_step(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (LM_BATCH, LM_SEQ))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    times = []
    for _ in range(1 + LM_TIMED):
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    runs = 1 + LM_TIMED
    med = float(np.median(times[1:]))
    work = flops.model_flops(cfg, InputShape("rwkv_prefill", LM_SEQ,
                                             LM_BATCH, "prefill"))
    finite = bool(torch.isfinite(logits).all())
    key = wkv_key(LM_BATCH, LM_SEQ, cfg)
    peak = torch.cuda.max_memory_allocated(dev)
    emit("rwkv_prefill", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, batch=LM_BATCH, seq=LM_SEQ, cut="none",
         heads=cfg.num_heads, head_dim=cfg.head_dim,
         params=flops.count_params_analytic(cfg),
         param_bytes=tensor_bytes(params), model_flops=work,
         warmup_ms=times[0] * 1e3, prefill_ms=[t * 1e3 for t in times[1:]],
         prefill_ms_median=med * 1e3, tokens_per_s=LM_BATCH * LM_SEQ / med,
         model_tflops_per_s=work / med / 1e12, peak_mem_bytes=peak,
         resident_bytes=resident, peak_over_resident_bytes=peak - resident,
         prefills=runs, launches=launches,
         wkv_shapes={str(k): v for k, v in tally["wkv6"].items()},
         logits_shape=list(logits.shape), finite=finite,
         max_abs_logit=float(logits.float().abs().max()))
    require(tally["wkv6"] == {key: cfg.num_layers * runs},
            f"rwkv_prefill: WKV launches {tally['wkv6']} over {runs} "
            f"prefills, want {cfg.num_layers} a prefill at {key}")
    require(all(n == 0 for k, n in launches.items() if k != "wkv6"),
            f"rwkv_prefill: another kernel was launched: {launches}")
    require(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size) and finite,
            f"rwkv_prefill: logits {tuple(logits.shape)}, finite={finite}")
    return tally


def rwkv_consistency_phase(dev, counters, zero_counters):
    """RWKV_ARCH at full width cut to RWKV_DEPTH layers, fp32 (TF32 off):
    the prefill's last logits on the exact route (one WKV launch a layer
    over the RWKV_CONSISTENCY_SEQ tokens) and on the chunked route
    (``wkv_chunk`` RWKV_CHUNK, plain tensor ops, no launch) against the
    decode logits after the same tokens one at a time (one one-token WKV
    launch a layer and token, the state written in place), within
    RWKV_TOL and RWKV_CHUNK_TOL of max|logit|.  Returns the run's
    tallies (the exact prefill's and the decode's launches)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv6 import ops as wkv
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.metrics import flops
    from repro_torch.models import model

    full = get_config(RWKV_ARCH)
    cfg = full.replace(num_layers=RWKV_DEPTH, dtype="float32",
                       param_dtype="float32")
    gen = torch.Generator(dev)
    gen.manual_seed(11)
    params = model.init(cfg, gen, device=dev)
    seq = RWKV_CONSISTENCY_SEQ
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, seq))).to(dev)
    zero_counters()
    t0 = time.perf_counter()
    pre = build_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    pre_chunk = build_prefill_step(cfg, wkv_chunk=RWKV_CHUNK)(
        params, {"tokens": toks})
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    chunk_launches = wkv.wkv6.launches - prefill_launches["wkv6"]
    cache = model.init_cache(params, cfg, 1, seq)
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(seq):
            dec = model.decode_(params, cache, cfg, toks[:, t:t + 1])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    dec = dec[:, 0]
    err = float((pre - dec).abs().max())
    err_chunk = float((pre_chunk - dec).abs().max())
    scale = float(dec.abs().max())
    want = {wkv_key(1, seq, cfg): RWKV_DEPTH,
            wkv_key(1, 1, cfg): RWKV_DEPTH * seq}
    emit("rwkv_consistency", model=RWKV_ARCH, layers=RWKV_DEPTH,
         cut=f"depth {full.num_layers} -> {RWKV_DEPTH}", dtype="float32",
         params=flops.count_params_analytic(cfg),
         param_bytes=tensor_bytes(params), seq=seq, wkv_chunk=RWKV_CHUNK,
         prefill_ms=prefill_s * 1e3, chunked_prefill_ms=chunk_s * 1e3,
         decode_ms_per_token=decode_s * 1e3 / seq, max_abs_err=err,
         max_abs_err_chunked=err_chunk, max_abs_logit=scale,
         tol=RWKV_TOL * scale, tol_chunked=RWKV_CHUNK_TOL * scale,
         same_argmax=bool(torch.equal(pre.argmax(-1), dec.argmax(-1))),
         same_argmax_chunked=bool(torch.equal(pre_chunk.argmax(-1),
                                              dec.argmax(-1))),
         prefill_launches=prefill_launches,
         chunked_prefill_launches=chunk_launches, launches=launches,
         wkv_shapes={str(k): v for k, v in tally["wkv6"].items()},
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    require(tally["wkv6"] == want and chunk_launches == 0,
            f"rwkv_consistency: WKV launches {tally['wkv6']} (chunked "
            f"prefill {chunk_launches}), want {want} and 0")
    require(all(n == 0 for k, n in launches.items() if k != "wkv6"),
            f"rwkv_consistency: another kernel was launched: {launches}")
    require(bool(torch.isfinite(pre).all()) and scale > 0
            and err <= RWKV_TOL * scale,
            f"rwkv_consistency: prefill vs decode logits err {err} > "
            f"{RWKV_TOL} x {scale}")
    require(bool(torch.isfinite(pre_chunk).all())
            and err_chunk <= RWKV_CHUNK_TOL * scale,
            f"rwkv_consistency: chunked prefill vs decode logits err "
            f"{err_chunk} > {RWKV_CHUNK_TOL} x {scale}")
    del params, cache
    torch.cuda.empty_cache()
    return tally


def rwkv_train_phase(dev, counters, zero_counters, profile_dir=None):
    """``build_opt_init`` and LM_TRAIN_WARMUP + LM_TIMED steps of
    ``build_train_step`` on the same batch: full-width RWKV_ARCH at
    RWKV_TRAIN_DEPTH layers, bf16 params over an fp32 master, fp32
    moments, remat on, B = 1, S = LM_TRAIN_SEQ, lr LM_TRAIN_LR: finite,
    falling losses, exactly two WKV launches a layer and step (the
    forward and remat's recompute) and one backward, no other kernel,
    every bf16 param its master's cast bitwise, the peak below the
    card's memory, beside 16 B a param; with ``profile_dir``, one more
    step under ``torch.profiler``.  Returns the steps' tallies."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_opt_init, build_train_step
    from repro_torch.metrics import flops
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves

    full = get_config(RWKV_ARCH)
    cfg = full.replace(num_layers=RWKV_TRAIN_DEPTH)
    gen = torch.Generator(dev)
    gen.manual_seed(12)
    params = model.init(cfg, gen, device=dev)
    opt = build_opt_init(cfg)(params)
    n = sum(p.numel() for p in tree_leaves(params))
    resident = tensor_bytes(params) + tensor_bytes(opt)
    batch = lm_train_batch(cfg, dev, LM_TRAIN_SEQ, 13)
    step = build_train_step(cfg, lr=LM_TRAIN_LR)
    runs = LM_TRAIN_WARMUP + LM_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    times, losses = [], []
    for i in range(runs):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = {k: fn.launches for k, fn in counters.items()}
    tally = tally_of(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(x) for x in losses]
    master_cast = all(torch.equal(p, m.to(p.dtype)) for p, m in
                      zip(tree_leaves(params), tree_leaves(opt.master)))
    med = float(np.median(times[LM_TRAIN_WARMUP:]))
    total = torch.cuda.get_device_properties(dev).total_memory
    key = wkv_key(1, LM_TRAIN_SEQ, cfg)
    emit("rwkv_train", model=cfg.name, layers=cfg.num_layers,
         cut=f"depth {full.num_layers} -> {cfg.num_layers}", params=n,
         params_analytic=flops.count_params_analytic(cfg),
         dtype=cfg.dtype, param_dtype=cfg.param_dtype, master="float32",
         moments="float32", remat=True, batch=1, seq=LM_TRAIN_SEQ,
         lr=LM_TRAIN_LR, losses=losses, warmup_ms=times[0] * 1e3,
         step_ms=[t * 1e3 for t in times[LM_TRAIN_WARMUP:]],
         step_ms_p50=med * 1e3, tokens_per_s=LM_TRAIN_SEQ / med,
         peak_mem_bytes=peak, card_mem_bytes=total, state_bytes=resident,
         state_with_grads_estimate_bytes=LM_BYTES_PER_PARAM * n,
         launches=launches,
         wkv_backward_launches=sum(tally["wkv6_bwd"].values()),
         params_are_master_cast=master_cast)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"rwkv_train: losses {losses} are not finite and falling")
    require(tally["wkv6"] == {key: 2 * cfg.num_layers * runs}
            and tally["wkv6_bwd"] == {key: cfg.num_layers * runs},
            f"rwkv_train: WKV launches {tally['wkv6']}, backward "
            f"{tally['wkv6_bwd']}, want {2 * cfg.num_layers} and "
            f"{cfg.num_layers} a step at {key}")
    require(all(n == 0 for k, n in launches.items() if k != "wkv6")
            and not any(tally[k] for k in (
                "rglru_scan_bwd", "group_l2_norms_bwd",
                "block_masked_matmul_dx")),
            f"rwkv_train: another kernel was launched: {launches}")
    require(master_cast, "rwkv_train: a bf16 param is not its master's "
                         "cast")
    require(peak < total, f"rwkv_train: peak {peak} >= the card's {total}")
    if profile_dir:
        emit("profile", run="rwkv_train step, profiled", seq=LM_TRAIN_SEQ,
             **profiled(lambda: step(params, opt, batch, runs),
                        os.path.join(profile_dir,
                                     "rwkv_train_profile.txt")))
    del params, opt, batch, step
    torch.cuda.empty_cache()
    return tally


def rwkv_phases(dev, counters, zero_counters, profile_dir=None):
    """Phases 7r-7u in order, each model freed before the next; returns
    path -> tallies.  With ``profile_dir``, one more prefill and
    LM_PROFILE_STEPS decode steps of RWKV_ARCH under ``torch.profiler``
    after rwkv_serve (:func:`lm_profile_phase`), and one more rwkv_train
    step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model

    tallies = {}
    torch.cuda.empty_cache()
    cfg = get_config(RWKV_ARCH)
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    emit("rwkv_init", model=cfg.name, seconds=time.perf_counter() - t0,
         param_bytes=tensor_bytes(params),
         allocated_bytes=torch.cuda.memory_allocated(dev),
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    tallies["rwkv_prefill"] = rwkv_prefill_phase(cfg, params, dev,
                                                 counters, zero_counters)
    torch.cuda.empty_cache()
    tallies["rwkv_serve"] = lm_serve_phase(
        cfg, params, dev, counters, zero_counters, phase="rwkv_serve",
        per_step={"wkv6": cfg.num_layers})
    served = tallies["rwkv_serve"]["wkv6"]
    require(list(served) == [wkv_key(LM_SERVE["slots"], 1, cfg)],
            f"rwkv_serve: WKV launched at {list(served)}, want one token "
            f"over the {LM_SERVE['slots']} slots")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        lm_profile_phase(cfg, params, dev, profile_dir, name="rwkv")
    del params
    torch.cuda.empty_cache()
    tallies["rwkv_consistency"] = rwkv_consistency_phase(dev, counters,
                                                         zero_counters)
    tallies["rwkv_train"] = rwkv_train_phase(dev, counters, zero_counters,
                                             profile_dir)
    return tallies


# ---------------------------------------------------------------------------
# phase 7f: the obs layer and the pipelined rounds
# ---------------------------------------------------------------------------

def _host_state(trainer):
    """The run's params on the host and its history, for comparing runs
    bit for bit after their trainers are gone."""
    from repro_torch.tree import tree_leaves
    return ([t.detach().cpu() for t in tree_leaves(trainer.params)],
            [h.to_dict() for h in trainer.history])


def _same_state(a, b) -> bool:
    import torch
    return a[1] == b[1] and len(a[0]) == len(b[0]) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a[0], b[0]))


def sync_probe(trainer, r):
    """The synchronizing CUDA calls of ``trainer._start_round(r)``, under
    ``torch.cuda.set_sync_debug_mode("warn")``, each by the innermost
    frame of the repo's code on the Python stack when it warned (the
    call site; the warning itself names torch's frame).  Only warnings
    raised inside the call count (turning the mode on warns by itself).
    A control, one ``.item()`` in the same mode, must be caught.  The
    round is then finished as usual.  Returns (sorted "file:line" list,
    the synchronizing calls, the control's calls)."""
    import traceback
    import warnings
    import torch

    src = os.path.join(HERE, "src") + os.sep
    sites, live = [], [False]

    def show(message, category, filename, lineno, file=None, line=None):
        if not live[0] or "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if f.filename.startswith(src)]
        f = ours[-1] if ours else None
        sites.append(f"{os.path.relpath(f.filename, HERE)}:{f.lineno}"
                     if f else f"{filename}:{lineno}")

    def probed(fn):
        del sites[:]
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            live[0] = True
            try:
                return fn()
            finally:
                live[0] = False
                torch.cuda.set_sync_debug_mode(0)

    x = torch.ones((), device=trainer.device)
    probed(lambda: x.item())
    control = len(sites)
    pend = probed(lambda: trainer._start_round(r))
    found = sorted(set(sites)), len(sites)
    trainer._finish_round(pend)
    return found + (control,)


def obs_phase(cfg, dev, out_dir):
    """The ``train (vectorized)`` cell three ways, in turns (OBS_RUNS):
    untraced and stepped (``run_round`` in a loop), untraced and
    pipelined (one ``run(3)``), and traced and pipelined after the
    matmul plans and group-L2 tables were cleared.  Every run must give
    the first one's params and histories bit for bit; the trace's
    summary must count each round phase three times, the prune once,
    compiles (the first round's fill) and no recompile; the pipelined
    run must peak within OBS_PEAK_SHARE of the stepped one.
    Then, untimed, the sync probe (:func:`sync_probe`) on each round of
    the cell and a fourth, steady one (plain, no prune), for each of
    OBS_PROBES: the synchronizing calls of the default trainer's steady
    round must be OBS_SYNCS_ALLOWED, and its state after round 3 the
    first run's.  Then the
    dense serving run of phase 3 again with ``--trace``: one
    ``serve/tick`` span a tick, the host caches filled on the first tick
    and not grown after it."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.configs.base import config_to_dict
    from repro_torch.core.pruning import criteria
    from repro_torch.kernels.block_masked_matmul import ops as bmm
    from repro_torch.kernels.group_l2_norms import ops as gl2
    from repro_torch.models.unet import init_unet
    from repro_torch.obs.metrics import summarize_trace
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve import __main__ as serve_cli

    os.makedirs(out_dir, exist_ok=True)

    def clear_caches():
        bmm.plan.cache_clear()
        gl2.table.cache_clear()
        # the per-group-list table dicts in front of table()
        criteria._layout.cache_clear()

    runs, states = {m_: [] for m_ in set(OBS_RUNS)}, []
    trace_path = os.path.join(out_dir, "obs_trace.jsonl")
    if os.path.exists(trace_path):
        os.remove(trace_path)
    for mode in OBS_RUNS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if mode == "traced":
            clear_caches()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = make_trainer(cfg, dev, "vectorized")
        tracer = None
        if mode == "traced":
            tracer = Tracer(trace_path)
            trainer.bind_tracer(tracer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "stepped":
            for r in (1, 2, 3):
                trainer.run_round(r)
        else:
            trainer.run(3)
        torch.cuda.synchronize()
        runs[mode].append({"wall_s": time.perf_counter() - t0,
                           "peak_bytes": torch.cuda.max_memory_allocated(dev)
                           - base})
        states.append(_host_state(trainer))
        if tracer is not None:
            tracer.close()
        del trainer
    summary = summarize_trace(trace_path)
    phases = {k: v["n"] for k, v in summary["phases"].items()}

    # the sync probe, untimed: every round of the cell and a fourth,
    # steady one (plain, no prune), and the same with persistent Adam
    # rows in the host store
    syncs, controls = {}, []
    for label, kw in OBS_PROBES.items():
        trainer = make_trainer(cfg, dev, "vectorized", **kw)
        syncs[label] = {}
        for r in (1, 2, 3, 4):
            found, n, control = sync_probe(trainer, r)
            syncs[label][r] = found
            controls.append(control)
            if r == 3 and not kw:
                states.append(_host_state(trainer))
        del trainer
    emit("obs", run="sync_probe", rounds=syncs, controls=controls)

    # serving, dense, traced: the caches cleared so the first tick fills
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    sparams = randomize(init_unet(cfg, gen, device=dev), gen)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        checkpoint.save(ckpt, {"params": sparams},
                        {"cfg": config_to_dict(cfg)})
        del sparams
        clear_caches()
        serve_trace = os.path.join(out_dir, "obs_serve_trace.jsonl")
        if os.path.exists(serve_trace):
            os.remove(serve_trace)
        m = serve_cli.main(["--ckpt", ckpt, "--requests", "16", "--slots",
                            "8", "--steps", "10", "--trace", serve_trace])
    served = summarize_trace(serve_trace)
    ticks = served["phases"].get("serve/tick", {}).get("n", 0)
    ok_bitwise = [_same_state(st, states[0]) for st in states[1:]]
    steady = syncs["default"][4]
    wall = {m_: sum(x["wall_s"] for x in v) for m_, v in runs.items()}
    peak = {m_: max(x["peak_bytes"] for x in v) for m_, v in runs.items()}
    emit("obs", cell="train (vectorized)", runs=runs,
         bitwise_equal=ok_bitwise, overlap_ratio=summary["overlap_ratio"],
         overlap_hidden_s=summary["overlap_hidden_s"],
         overlap_window_s=summary["overlap_window_s"],
         phases=phases, rounds=summary["rounds"],
         compiles=summary["compiles"], recompiles=summary["recompiles"],
         order=list(OBS_RUNS),
         pipelined_vs_stepped=wall["pipelined"] / wall["stepped"],
         peak_ratio=peak["pipelined"] / peak["stepped"],
         steady_round_syncs=steady,
         serve_ticks=ticks, serve_images=m["images"],
         serve_compiles=served["compiles"],
         serve_recompiles=served["recompiles"],
         serve_requests_per_s=m["requests_per_s"])
    require(all(ok_bitwise),
            f"obs: runs {OBS_RUNS[1:]} and the probed one against the "
            f"first: {ok_bitwise}")
    require(all(phases.get(p, 0) == 3 for p in OBS_PHASES)
            and phases.get("round/prune", 0) == 1,
            f"obs: phase counts {phases}")
    require(summary["rounds"] == 3 and summary["recompiles"] == 0
            and summary["compiles"] >= 1,
            f"obs: rounds {summary['rounds']}, compiles "
            f"{summary['compiles']}, recompiles {summary['recompiles']}")
    require(summary["overlap_ratio"] is not None
            and 0.0 <= summary["overlap_ratio"] <= 1.0,
            f"obs: overlap ratio {summary['overlap_ratio']}")
    require(peak["pipelined"] <= (1 + OBS_PEAK_SHARE) * peak["stepped"],
            f"obs: pipelined peak {peak['pipelined']} vs stepped "
            f"{peak['stepped']}")
    require(min(controls) >= 1, "obs: the sync probe missed its "
            "control's .item()")
    require(set(steady) <= set(OBS_SYNCS_ALLOWED),
            f"obs: a steady-state round synchronizes at {steady}")
    require(m["images"] == 16 and ticks == 20
            and served["compiles"] >= 1 and served["recompiles"] == 0,
            f"obs: serve {m['images']} images, {ticks} tick spans (want "
            f"20), compiles {served['compiles']}, recompiles "
            f"{served['recompiles']}")


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def make_trainer(cfg, dev, engine, precision="fp32", **kw):
    """The port's FedPhD on ``engine`` over 320 synthetic CIFAR-10-like
    images: 4 clients holding 2 classes each, batch 32, 2 edges, 3
    rounds with R_s = 2 (round 1 sparse, the prune at round 2's cloud
    aggregation).  Each call builds fresh clients from the same seeds."""
    from repro_torch.configs import FLConfig
    from repro_torch.core.hfl import FedPhD
    from repro_torch.data import (CIFAR10_LIKE, ClientData, make_dataset,
                                  shards_per_client)
    from repro_torch.fl.client import Client

    ds = dataclasses.replace(CIFAR10_LIKE, samples_per_class=32)
    images, labels = make_dataset(ds, seed=0)
    parts = shards_per_client(labels, TRAIN_CLIENTS, 2, seed=0)
    # wired as the reference's experiment/data.py:make_clients wires them
    clients = [Client(i, ClientData(images[p], labels[p],
                                    batch_size=TRAIN_BATCH, seed=i),
                      ds.num_classes) for i, p in enumerate(parts)]
    fl = FLConfig(num_clients=TRAIN_CLIENTS, num_edges=2, participation=1.0,
                  local_epochs=1, edge_agg_every=1, cloud_agg_every=1,
                  rounds=3, sparse_rounds=2, prune_ratio=0.44)
    return FedPhD(cfg.replace(precision=precision), fl, clients, device=dev,
                  lr=TRAIN_LR, engine=engine, **kw)


def train_run(cfg, dev, engine, counters, zero_counters, precision="fp32",
              **kw):
    """One training run on ``engine``, the counters set to 0 just before
    it and read just after: the trainer, its history, its kernel tallies
    (kernel -> {shape key: launches}, with the matmul's dx launches under
    "block_masked_matmul_dx" and group-L2's backward under
    "group_l2_norms_bwd"), the group-L2 launches of round 1, each
    round's local-training seconds (host clock, each ending in the
    round's loss syncs: the sequential engine's step_seconds summed over
    the round, the vectorized engine's round_seconds), the client steps
    of each round and the peak device memory.  ``kw`` goes to the
    trainer (``mesh=``)."""
    import torch

    trainer = make_trainer(cfg, dev, engine, precision, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    t0 = time.perf_counter()
    ends = [0]                           # client steps at each round's end
    batched = []                         # the round's steps of all clients
    for r in (1, 2, 3):                  # sparse; plain, pruned; compacted
        hist, _ = trainer.run(r)
        steps = [trainer.clients[c].data.steps_per_epoch
                 for c in hist[-1].selected]
        ends.append(ends[-1] + sum(steps))
        batched.append(max(steps) if engine == "vectorized" else sum(steps))
        if r == 1:
            gl2 = counters["group_l2_norms"]
            omega = (gl2.launches, gl2.bwd_launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tally = tally_of(counters)
    if engine == "sequential":
        st = trainer.step_seconds
        round_s = [sum(st[a:b]) for a, b in zip(ends, ends[1:])]
    else:
        round_s = list(trainer.round_seconds)
    return dict(trainer=trainer, hist=hist, wall=wall, tally=tally,
                launches={k: fn.launches for k, fn in counters.items()},
                gl2_bwd=counters["group_l2_norms"].bwd_launches,
                omega=omega, round_s=round_s,
                steps=[b - a for a, b in zip(ends, ends[1:])],
                batched_steps=sum(batched),
                peak=torch.cuda.max_memory_allocated(dev))


def train_phase(cfg, dev, counters, zero_counters):
    """Full-width FedPhD through sparse -> prune -> plain, one run on
    each engine (sequential, then vectorized), and every check on that
    pair; the sequential run's checks are those of the sequential-only
    phase before the vectorized engine existed.  Returns the pair's
    tallies, {"train": sequential, "train_vectorized": ...}, and its
    runs (engine -> [run]) for :func:`train_timing_phase`."""
    import numpy as np

    runs = {e: [train_run(cfg, dev, e, counters, zero_counters)]
            for e in TRAIN_ENGINES}
    seq, vec = runs["sequential"][0], runs["vectorized"][0]
    trainer, hist, launches = seq["trainer"], seq["hist"], seq["launches"]
    tally = seq["tally"]
    steps = np.asarray(trainer.step_seconds)
    sparse_steps = seq["steps"][0]       # round 1 is the sparse round
    omega_l2, omega_l2_bwd = seq["omega"]
    # the first step pays one-off start-up costs; the rates are taken
    # over the steps after it
    steady = steps[1:]
    dx = sum(tally["block_masked_matmul_dx"].values())
    hds = sorted({key[3] for key in tally["flash_attention"]})
    ends = np.cumsum([0] + seq["steps"])
    for rec in hist:
        emit("train", round=rec.round, loss=rec.loss, comm_gb=rec.comm_gb,
             comm_up_gb=rec.comm_up_gb, comm_down_gb=rec.comm_down_gb,
             params_m=rec.params_m, pruned=rec.pruned,
             selected=rec.selected)
    emit("train", run="summary", engine="sequential", model=cfg.name,
         precision="fp32",
         cut="data 320 images (32 per class), 4 clients, 3 rounds; "
             "full width and depth",
         steps=len(steps), batch=TRAIN_BATCH, wall_s=seq["wall"],
         first_step_ms=float(steps[0] * 1e3), steady_steps=len(steady),
         p50_step_ms=float(np.percentile(steady, 50) * 1e3),
         p99_step_ms=float(np.percentile(steady, 99) * 1e3),
         images_per_s=float(TRAIN_BATCH * len(steady) / steady.sum()),
         p50_step_ms_by_round=[
             float(np.percentile(steps[max(a, 1):b], 50) * 1e3)
             for a, b in zip(ends, ends[1:])],
         step_ms=[float(x * 1e3) for x in steps],
         peak_mem_bytes=seq["peak"],
         launches=launches, matmul_fwd=launches["block_masked_matmul"] - dx,
         matmul_dx=dx, attention_hd=hds, group_l2_in_round1=omega_l2,
         group_l2_bwd=seq["gl2_bwd"], sparse_steps=sparse_steps,
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
    # one group-L2 launch an Omega evaluation (forward and backward),
    # and one for the scores at R_s
    require(omega_l2 == sparse_steps and omega_l2_bwd == sparse_steps,
            f"train: {omega_l2} group-L2 launches and {omega_l2_bwd} "
            f"backward launches in round 1, want one each a step "
            f"({sparse_steps})")
    require(launches["group_l2_norms"] == sparse_steps + 1
            and seq["gl2_bwd"] == sparse_steps,
            f"train: {launches['group_l2_norms']} group-L2 launches and "
            f"{seq['gl2_bwd']} backward, want {sparse_steps + 1} and "
            f"{sparse_steps}")
    require(all(sum(t.values()) == launches[k] for k, t in tally.items()
                if k in launches),
            f"train: per-shape tallies do not add up to {launches}")
    check_vectorized(seq, vec)
    # the mesh phase holds its runs to this one, after its trainer is gone
    vec["state"] = _host_state(vec["trainer"])
    for run in (seq, vec):
        del run["trainer"]
    return {"train": tally, "train_vectorized": vec["tally"]}, runs


def train_timing_phase(cfg, dev, counters, zero_counters, runs):
    """The engines side by side: TRAIN_PAIRS - 1 more runs a side in
    turns after :func:`train_phase`'s pair (the host sets the step time
    and drifts within a call), and each engine's times as medians over
    all its runs.  These runs come after the kernel checks, so that the
    kernels are timed after the same work as before the vectorized
    engine existed."""
    import numpy as np

    for _ in range(TRAIN_PAIRS - 1):
        for e in TRAIN_ENGINES:
            run = train_run(cfg, dev, e, counters, zero_counters)
            del run["trainer"]
            runs[e].append(run)
    seq = runs["sequential"][0]
    per_engine = {}
    for e in TRAIN_ENGINES:
        rs = runs[e]
        round_s = np.asarray([r["round_s"] for r in rs])   # (runs, rounds)
        images = TRAIN_BATCH * sum(seq["steps"])
        per_engine[e] = dict(
            runs=len(rs),
            local_s_by_round_median=np.median(round_s, axis=0).tolist(),
            local_s_by_round=round_s.tolist(),
            local_s_median=float(np.median(round_s.sum(axis=1))),
            images_per_s_median=float(np.median(images
                                                / round_s.sum(axis=1))),
            peak_mem_bytes=[r["peak"] for r in rs],
            launches=rs[0]["launches"],
            launches_per_client_step={
                k: v / sum(seq["steps"]) for k, v in rs[0]["launches"].items()},
            steps=rs[0]["batched_steps"],
            launches_per_step={k: v / rs[0]["batched_steps"]
                               for k, v in rs[0]["launches"].items()})
    emit("train", run="engines", clients=TRAIN_CLIENTS,
         client_steps=sum(seq["steps"]), **per_engine,
         speedup_images_per_s=per_engine["vectorized"]["images_per_s_median"]
         / per_engine["sequential"]["images_per_s_median"])


def engine_memory_phase(cfg, rparams, gen, dev):
    """The vectorized engine's peak device memory against the round's
    client count C: one round of one sparse step (Omega on) at batch
    TRAIN_BATCH through ``make_round_engine``, for each C of
    MEMORY_CLIENTS until the first that runs out of memory.  The engine
    holds every client's activations at once, so its peak grows with C;
    each C runs unchunked (``max_clients=C``), and the line gives
    ``round_bytes``' estimate for it beside the measurement, which it
    must not fall below: ``client_chunk`` sizes the engine's chunks from
    that estimate."""
    import numpy as np
    import torch
    from repro_torch.configs import FLConfig
    from repro_torch.core.pruning import unet_groups
    from repro_torch.fl.engine import (make_round_engine, round_bytes,
                                       stack_trees)

    fcfg = cfg.replace(precision="fp32")
    groups = unet_groups(fcfg, rparams)
    edge = stack_trees([rparams])
    img = (TRAIN_BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)
    peaks, fits = {}, 0
    estimates = {C: round_bytes(fcfg, (C, 1) + img, C, edges=1)
                 for C in MEMORY_CLIENTS}
    for C in MEMORY_CLIENTS:
        # all C clients in one chunk, past what client_chunk would allow
        engine = make_round_engine(fcfg, FLConfig(), sparse=True,
                                   groups=groups, lr=TRAIN_LR,
                                   max_clients=C)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            batches = {"images": torch.rand((C, 1) + img, generator=gen,
                                            device=dev) * 2 - 1}
            draws = (torch.randint(0, cfg.diffusion_steps,
                                   (C, 1, TRAIN_BATCH), generator=gen,
                                   device=dev),
                     torch.randn((C, 1) + img, generator=gen, device=dev))
            out = engine(edge, np.zeros(C, np.int64), batches,
                         np.ones((C, 1), bool), draws,
                         np.full((1, C), 1.0 / C, np.float32))
            torch.cuda.synchronize()
        except torch.OutOfMemoryError:
            peaks[C] = None
            break
        finally:
            batches = draws = out = None
        peaks[C] = torch.cuda.max_memory_allocated(dev)
        fits = C
    torch.cuda.empty_cache()
    ran = [c for c in peaks if peaks[c] is not None]
    per_client = (peaks[ran[-1]] - peaks[ran[0]]) / (ran[-1] - ran[0]) \
        if len(ran) > 1 else None
    emit("train", run="engine_memory", batch=TRAIN_BATCH, steps=1,
         sparse=True, peak_mem_bytes_by_clients=peaks,
         estimate_bytes_by_clients=estimates,
         largest_clients_run=fits, bytes_per_client=per_client,
         total_mem_bytes=torch.cuda.get_device_properties(dev).total_memory)
    require(fits >= TRAIN_CLIENTS,
            f"engine memory: {TRAIN_CLIENTS} clients did not fit: {peaks}")
    require(all(estimates[c] >= peaks[c] for c in ran),
            f"engine memory: client_chunk's estimate "
            f"{ {c: estimates[c] for c in ran} } below the measured peak "
            f"{ {c: peaks[c] for c in ran} }")


def experiment_run(argv, dev, counters, zero_counters):
    """One in-process ``repro_torch.experiment.runner.main`` call, the
    counters set to 0 just before it and read just after: the
    experiment, its seconds, peak memory and kernel tallies (as
    :func:`train_run` keeps them)."""
    import torch
    from repro_torch.experiment import runner

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    zero_counters()
    t0 = time.perf_counter()
    exp = runner.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tally = tally_of(counters)
    return dict(exp=exp, wall=wall, tally=tally, base=base,
                launches={k: fn.launches for k, fn in counters.items()},
                peak=torch.cuda.max_memory_allocated(dev))


def nondeterminism_probe(exp, dev):
    """The ops on the U-Net's training path with no deterministic CUDA
    implementation: one sparse vectorized step of two of the
    experiment's clients (forward, Omega, backward, Adam) under
    ``torch.use_deterministic_algorithms(True)``, where such an op
    raises (from the backward's threads too, where a warning would not
    reach this thread).  Each raise is recorded and the step run again
    once the op is known: cuBLAS's raises until CUBLAS_WORKSPACE_CONFIG
    is set (set here for the probe, which silences the check but does
    not change the workspace of the handles already made), any other op
    ends the probe.  A control, ``torch.histc`` on the card, must raise.  Run
    apart from the training runs, because the mode also switches some
    ops to other algorithms.  Returns ``(raises in order, control's)``."""
    import numpy as np
    import torch
    from repro_torch.fl.engine import draw_round, stack_trees

    tr = exp.trainer
    eng = tr._engine_sparse or tr._engine_plain
    img = (EXPERIMENT_BATCH, tr.cfg.image_size, tr.cfg.image_size,
           tr.cfg.in_channels)
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    valid = np.ones((2, 1), bool)
    batches = {"images": torch.rand((2, 1) + img, generator=gen,
                                    device=dev) * 2 - 1}
    draws = draw_round(gen, valid, img, tr.cfg.diffusion_steps, dev)

    def raised(fn):
        before = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            return str(e).splitlines()[0][:240]
        finally:
            torch.use_deterministic_algorithms(before)
        return None

    control = raised(lambda: torch.histc(torch.rand(64, device=dev),
                                         bins=4))
    path, env = [], os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    try:
        for _ in range(4):
            msg = raised(lambda: eng(
                stack_trees([tr.params]), np.zeros(2, np.int64), batches,
                valid, draws, np.full((1, 2), 0.5, np.float32)))
            if msg is None:
                break
            path.append(msg)
            if "CUBLAS_WORKSPACE_CONFIG" not in msg \
                    or os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
                break
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    finally:
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    return path, control


def experiment_phase(dev, counters, zero_counters):
    """The experiment API on the card (``python -m
    repro_torch.experiment.runner``, in process): the ``paper`` preset
    (full-width CIFAR10_UNET, 20 clients of 256 cifar10-like images, 2
    edges, batch 32) for EXPERIMENT_ROUNDS rounds with the eval hook
    every round, unbroken; then the same run for one round and resumed
    from its checkpoint to the last, each into a temporary ``--out``.
    The round's 20 clients train on the vectorized engine in
    ``client_chunk``'s chunks.  Returns the unbroken run's tallies."""
    with tempfile.TemporaryDirectory() as tmp:
        return _experiment_phase(dev, counters, zero_counters, tmp)


def _experiment_phase(dev, counters, zero_counters, out_dir):
    import numpy as np
    import torch
    from repro_torch.fl.engine import client_chunk, round_bytes
    from repro_torch.tree import tree_leaves

    last = str(EXPERIMENT_ROUNDS)
    whole_dir = os.path.join(out_dir, "whole")
    back_dir = os.path.join(out_dir, "resumed")
    base = ["--preset", EXPERIMENT_PRESET, "--eval-every", "1",
            "--save-every", "0"]
    whole = experiment_run(base + ["--rounds", last, "--out", whole_dir],
                           dev, counters, zero_counters)
    exp = whole["exp"]
    tr = exp.trainer
    hist = exp.history
    C = len(hist[0].selected)
    S = max(tr.clients[c].data.steps_per_epoch
            for c in hist[0].selected) * tr.fl.local_epochs
    shape = (C, S, EXPERIMENT_BATCH, tr.cfg.image_size, tr.cfg.image_size,
             tr.cfg.in_channels)
    total = torch.cuda.get_device_properties(dev).total_memory
    k = client_chunk(tr.cfg, shape, total, edges=tr.fl.num_edges)
    estimate = round_bytes(tr.cfg, shape, k, edges=tr.fl.num_edges)
    probe, control = nondeterminism_probe(exp, dev)
    images = EXPERIMENT_BATCH * sum(tr.clients[c].data.steps_per_epoch
                                    for h in hist for c in h.selected)
    params = [p.detach().cpu() for p in tree_leaves(exp.params)]
    round_s = list(tr.round_seconds)
    tr_cfg_name = tr.cfg.name
    del exp, tr, whole["exp"]
    first = experiment_run(base + ["--rounds", "1", "--out", back_dir],
                           dev, counters, zero_counters)
    del first["exp"]
    back = experiment_run(["--resume", "--rounds", last, "--out", back_dir],
                          dev, counters, zero_counters)
    rhist = back["exp"].history
    rparams = [p.detach().cpu() for p in tree_leaves(back["exp"].params)]
    rround_s = list(back["exp"].trainer.round_seconds)
    del back["exp"]
    torch.cuda.empty_cache()

    tally = whole["tally"]
    mm_keys = set(tally["block_masked_matmul"])
    batched = {key for key in mm_keys if len(key) > 5}
    dx = tally["block_masked_matmul_dx"]
    att = sorted({key[0] for key in tally["flash_attention"]})
    l2_clients = sorted({key[2] if len(key) > 2 else 1
                         for key in tally["group_l2_norms"]})
    evals = [h.eval for h in hist]
    loss_rel = [abs(a.loss - b.loss) / abs(a.loss)
                for a, b in zip(hist, rhist)]
    diff = max(float((a - b).abs().max()) for a, b in zip(params, rparams))
    bitwise = all(torch.equal(a, b) for a, b in zip(params, rparams)) \
        and [h.loss for h in hist] == [h.loss for h in rhist]
    emit("experiment", preset=EXPERIMENT_PRESET, model=tr_cfg_name,
         rounds=len(hist), clients=C, steps_per_round=S,
         batch=EXPERIMENT_BATCH, chunk=k, chunks=-(-C // k),
         chunk_estimate_bytes=estimate, total_mem_bytes=total,
         peak_mem_bytes=whole["peak"],
         peak_mem_bytes_resumed=[first["peak"], back["peak"]],
         wall_s=whole["wall"], wall_s_per_round=whole["wall"] / len(hist),
         local_s_by_round=round_s, local_s_by_round_resumed=rround_s,
         images_per_s=images / sum(round_s),
         loss=[h.loss for h in hist], loss_resumed=[h.loss for h in rhist],
         loss_rel_err=loss_rel, is_proxy=[e and e.get("is_proxy")
                                          for e in evals],
         is_proxy_resumed=[h.eval and h.eval.get("is_proxy") for h in rhist],
         comm_gb=[h.comm_gb for h in hist], params_m=[h.params_m
                                                    for h in hist],
         max_abs_param_diff_resumed=diff, bitwise_resumed=bitwise,
         launches=whole["launches"],
         matmul_clients=sorted({key[5] for key in batched}),
         matmul_dx=sum(dx.values()), attention_bh=att,
         group_l2_clients=l2_clients,
         base_mem_bytes=[whole["base"], first["base"], back["base"]],
         nondeterministic_ops=probe, nondeterministic_control=control)
    require(len(hist) == EXPERIMENT_ROUNDS and len(rhist) == len(hist),
            f"experiment: {len(hist)} and {len(rhist)} rounds")
    require(all(np.isfinite(h.loss) for h in hist + rhist),
            "experiment: a loss is not finite")
    require(all(e is not None and np.isfinite(e["is_proxy"])
                for e in evals + [h.eval for h in rhist]),
            f"experiment: an is_proxy eval is missing or not finite: "
            f"{evals}")
    require(control is not None, "experiment: the nondeterminism probe's "
                                 "control, torch.histc on the card, did "
                                 "not raise")
    require(whole["peak"] < total and back["peak"] < total,
            f"experiment: peak {whole['peak']} / {back['peak']} bytes of "
            f"{total}")
    require(k < C and C % k == 0, f"experiment: chunk {k} of {C} clients")
    require(batched and {key[5] for key in batched} == {k}
            and all(len(key) > 5 and key[5] == k for key in dx),
            f"experiment: training matmul launches at clients "
            f"{sorted({key[5] for key in batched})} and dx keys "
            f"{sorted(dx)[:3]}, want every one at {k}")
    require(EVAL_IMAGES in att and EXPERIMENT_BATCH * k in att,
            f"experiment: attention at BH {att}, want the eval's "
            f"{EVAL_IMAGES} and the chunk's {EXPERIMENT_BATCH * k}")
    require(l2_clients == [k], f"experiment: group-L2 tables at clients "
                               f"{l2_clients}, want [{k}]")
    same = [(h.selected, h.comm_gb, h.comm_up_gb, h.comm_down_gb,
             h.params_m, sorted(h.eval)) for h in hist]
    require(same == [(h.selected, h.comm_gb, h.comm_up_gb, h.comm_down_gb,
                      h.params_m, sorted(h.eval)) for h in rhist],
            "experiment: the resumed run's selections, bytes, params_m or "
            "eval keys differ from the unbroken run's")
    require(max(loss_rel) <= TRAIN_LOSS_RTOL,
            f"experiment: resumed losses {loss_rel} relative, limit "
            f"{TRAIN_LOSS_RTOL}")
    require(diff <= TRAIN_PARAMS_ATOL,
            f"experiment: resumed params differ by {diff} (limit "
            f"{TRAIN_PARAMS_ATOL})")
    return tally


def check_vectorized(seq, vec):
    """The first vectorized run against the first sequential one: the
    same selections, bitwise bytes, params_m, pruning and prune report;
    each round's loss within TRAIN_LOSS_RTOL; the final params within
    TRAIN_PARAMS_ATOL (steps x 2 lr: Adam moves a parameter whose exact
    gradient is zero by up to lr a step, whichever way rounding noise
    points) and, for TRAIN_PARAMS_BULK[1] of the values, within
    TRAIN_PARAMS_BULK[0]; the exact launch counts of VECTORIZED_LAUNCHES,
    every matmul launch over all the clients."""
    import torch
    from repro_torch.tree import tree_leaves

    hs, hv = seq["hist"], vec["hist"]
    a, b = seq["trainer"], vec["trainer"]
    loss_rel = [abs(x.loss - y.loss) / abs(x.loss) for x, y in zip(hs, hv)]
    diffs = torch.cat([(x - y).abs().reshape(-1).float().cpu()
                       for x, y in zip(tree_leaves(a.params),
                                       tree_leaves(b.params))])
    bulk = float((diffs <= TRAIN_PARAMS_BULK[0]).float().mean())
    launches, tally = vec["launches"], vec["tally"]
    mm_keys = set(tally["block_masked_matmul"])
    emit("train", run="vectorized vs sequential", rounds=len(hv),
         loss=[r.loss for r in hv], loss_rel_err=loss_rel,
         loss_rtol=TRAIN_LOSS_RTOL, max_abs_param_diff=float(diffs.max()),
         params_atol=TRAIN_PARAMS_ATOL, params_within_bulk=bulk,
         params_bulk=TRAIN_PARAMS_BULK, launches=launches,
         group_l2_bwd=vec["gl2_bwd"], group_l2_in_round1=vec["omega"],
         matmul_dx=sum(tally["block_masked_matmul_dx"].values()),
         matmul_clients=sorted({k[5] if len(k) > 5 else 1
                                for k in mm_keys}),
         round_seconds=vec["round_s"], peak_mem_bytes=vec["peak"])
    same = [(x.selected, x.comm_gb, x.comm_up_gb, x.comm_down_gb,
             x.params_m, x.pruned, x.edge_sh) for x in hs]
    require(same == [(y.selected, y.comm_gb, y.comm_up_gb, y.comm_down_gb,
                      y.params_m, y.pruned, y.edge_sh) for y in hv],
            "train vectorized: selections, bytes, params_m or pruning "
            "differ from the sequential run")
    require(a.prune_report == b.prune_report and a.cfg == b.cfg,
            "train vectorized: the prune report differs")
    require(max(loss_rel) <= TRAIN_LOSS_RTOL,
            f"train vectorized: round losses {loss_rel} relative, limit "
            f"{TRAIN_LOSS_RTOL}")
    require(float(diffs.max()) <= TRAIN_PARAMS_ATOL
            and bulk >= TRAIN_PARAMS_BULK[1],
            f"train vectorized: params differ by up to {float(diffs.max())} "
            f"(limit {TRAIN_PARAMS_ATOL}), {bulk} within "
            f"{TRAIN_PARAMS_BULK[0]} (want {TRAIN_PARAMS_BULK[1]})")
    got = dict(launches, group_l2_norms_bwd=vec["gl2_bwd"])
    want = dict(VECTORIZED_LAUNCHES, rglru_scan=0, wkv6=0)
    require(got == want, f"train vectorized: launches {got}, want {want}")
    require(all(len(k) == 6 and k[5] == TRAIN_CLIENTS for k in mm_keys)
            and vec["omega"] == (2, 2),
            f"train vectorized: a matmul launch without the client axis "
            f"of {TRAIN_CLIENTS}, or Omega launches {vec['omega']}")
    require(all(sum(t.values()) == launches[k] for k, t in tally.items()
                if k in launches),
            f"train vectorized: per-shape tallies do not add up to "
            f"{launches}")


# ---------------------------------------------------------------------------
# phase 4a: FedPhD's hierarchy on a device mesh
# ---------------------------------------------------------------------------

def mesh_flat_round(spec, dev, counters, zero_counters):
    """One round of the flat ``spec`` through ``Experiment`` (its mesh,
    if any, from ``spec.mesh``), the counters and the collectives set to
    0 just before it: the history, the method state, kernel tallies,
    collectives and the round's local seconds."""
    import torch
    from repro_torch.experiment.run import Experiment
    from repro_torch.launch import federated

    exp = Experiment(spec, device=dev)
    torch.cuda.synchronize()
    zero_counters()
    federated.reset_collectives()
    exp.run(1)
    torch.cuda.synchronize()
    return dict(hist=[h.to_dict() for h in exp.history],
                state=method_state(exp.trainer), tally=tally_of(counters),
                collectives=dict(federated.COLLECTIVES),
                mesh=type(exp.trainer.mesh).__name__,
                local_s=list(exp.trainer.round_seconds))


def mesh_phase(cfg, dev, counters, zero_counters, vec):
    """The ``train`` cell's vectorized FedPhD on a mesh of MESH_AXES: a
    world of one rank on a real NCCL communicator, started in-process by
    ``make_spec_mesh``.  MESH_RUNS in turns (mesh, unsharded, mesh),
    each through :func:`make_trainer`, each held bitwise to ``vec`` (the
    train phase's first vectorized run): history and final params, and
    kernel tallies launch for launch.  With one rank the partial (E, C)
    contraction is the whole one and the all-reduce a copy, so nothing
    may differ.  The collectives are counted (MESH_COLLECTIVES a round),
    a further round of the last mesh run is probed for host syncs (none
    allowed, OBS_SYNCS_ALLOWED), and one MOON round on the mesh (through
    ``ExperimentSpec.mesh``) is held bitwise to the unsharded one.  The
    process group is destroyed at the end, so later phases (the sweep's
    spawned workers) run as before.  Returns the first mesh run's
    tallies."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import federated
    from repro_torch.launch.mesh import (destroy_world, make_spec_mesh,
                                         mesh_axis_sizes)

    require(not dist.is_initialized(),
            "mesh: a process group exists before the mesh phase")
    t0 = time.perf_counter()
    mesh = make_spec_mesh(MESH_AXES)
    init_s = time.perf_counter() - t0
    try:
        backend = dist.get_backend()
        runs = []
        for sharded in MESH_RUNS:
            federated.reset_collectives()
            run = train_run(cfg, dev, "vectorized", counters, zero_counters,
                            mesh=mesh if sharded else None)
            run["collectives"] = dict(federated.COLLECTIVES)
            run["state"] = _host_state(run["trainer"])
            run["sharded"] = sharded
            runs.append(run)
        # one more (plain) round of the last mesh run, its dispatch
        # probed for host syncs; it must not change the collectives' count
        trainer = runs[-1]["trainer"]
        syncs, n_syncs, control = sync_probe(trainer, 4)
        for run in runs:
            del run["trainer"]
        del trainer
        register_baseline_data()
        flat_spec = dataclasses.replace(
            baseline_spec(MESH_FLAT, "vectorized"),
            fl=dataclasses.replace(baseline_spec(MESH_FLAT, "vectorized").fl,
                                   rounds=1))
        flat = {kind: mesh_flat_round(
            flat_spec.replace(mesh=dict(MESH_AXES) if kind == "mesh"
                              else None), dev, counters, zero_counters)
            for kind in ("mesh", "unsharded")}
        torch.cuda.empty_cache()
    finally:
        destroy_world()
    rounds = len(vec["hist"])
    per_round = MESH_COLLECTIVES["fedphd"]
    for i, run in enumerate(runs):
        same = _same_state(run["state"], vec["state"])
        c = run["collectives"]
        emit("mesh", run=i + 1, sharded=run["sharded"], backend=backend,
             axes=mesh_axis_sizes(mesh), bitwise_equal=same,
             tallies_equal=run["tally"] == vec["tally"],
             round_s=run["round_s"], unsharded_first_round_s=vec["round_s"],
             wall_s=run["wall"], peak_mem_bytes=run["peak"],
             collectives=c, launches=run["launches"])
        require(same, f"mesh run {i + 1} (sharded={run['sharded']}): the "
                      f"history or final params differ from the unsharded "
                      f"vectorized run")
        require(run["tally"] == vec["tally"],
                f"mesh run {i + 1}: kernel tallies differ from the "
                f"unsharded run's")
        want = (per_round[0] * rounds, per_round[1] * rounds) \
            if run["sharded"] else (0, 0)
        require((c["all_reduce"], c["all_gather"]) == want,
                f"mesh run {i + 1}: collectives {c}, want (all_reduce, "
                f"all_gather) = {want}")
    flat_same = (flat["mesh"]["hist"] == flat["unsharded"]["hist"]
                 and all(len(a) == len(b) and all(
                     torch.equal(x, y) for x, y in zip(a, b))
                     for a, b in zip(flat["mesh"]["state"].values(),
                                     flat["unsharded"]["state"].values()))
                 and flat["mesh"]["state"].keys()
                 == flat["unsharded"]["state"].keys())
    fc = flat["mesh"]["collectives"]
    emit("mesh", run=MESH_FLAT, backend=backend, bitwise_equal=flat_same,
         tallies_equal=flat["mesh"]["tally"] == flat["unsharded"]["tally"],
         trainer_mesh=flat["mesh"]["mesh"],
         round_s=flat["mesh"]["local_s"],
         unsharded_round_s=flat["unsharded"]["local_s"], collectives=fc,
         unsharded_collectives=flat["unsharded"]["collectives"])
    emit("mesh", run="summary", backend=backend, world=1, init_s=init_s,
         sync_sites=syncs, syncs=n_syncs, sync_control=control,
         mesh_round_s=[r["round_s"] for r in runs if r["sharded"]],
         unsharded_round_s=[r["round_s"] for r in runs
                            if not r["sharded"]],
         process_group_left=dist.is_initialized())
    require(backend == "nccl", f"mesh: backend {backend!r}, want nccl")
    require(control > 0 and set(syncs) <= set(OBS_SYNCS_ALLOWED),
            f"mesh: a steady mesh round syncs the host at {syncs} "
            f"(control caught {control})")
    require(flat_same and flat["mesh"]["tally"] == flat["unsharded"]["tally"]
            and flat["mesh"]["mesh"] == "DeviceMesh",
            f"mesh: the {MESH_FLAT} round on the mesh differs from the "
            f"unsharded one")
    require((fc["all_reduce"], fc["all_gather"])
            == MESH_COLLECTIVES[MESH_FLAT],
            f"mesh: {MESH_FLAT} collectives {fc}, want "
            f"{MESH_COLLECTIVES[MESH_FLAT]}")
    require(not dist.is_initialized(), "mesh: the process group is left")
    return runs[0]["tally"]


# ---------------------------------------------------------------------------
# phase 7c: the flat baselines and centralized training
# ---------------------------------------------------------------------------

def register_baseline_data():
    """The ``train`` cell's data as a dataset the experiment API can
    name: 320 CIFAR-10-like images (32 a class), which
    ``make_clients`` splits over 4 clients of 2 classes as
    :func:`make_trainer` does."""
    from repro_torch.data import CIFAR10_LIKE
    from repro_torch.experiment.data import register_dataset
    register_dataset(BASELINE_DATASET, dataclasses.replace(
        CIFAR10_LIKE, samples_per_class=32), overwrite=True)


def baseline_spec(method, engine):
    """The ``baselines`` cell: ``method`` on full-width CIFAR10_UNET in
    fp32, the ``train`` cell's 4 clients, batch 32, BASELINE_ROUNDS
    rounds on ``engine``."""
    from repro_torch.configs import FLConfig
    from repro_torch.experiment.spec import DataSpec, ExperimentSpec
    return ExperimentSpec(
        name="baselines", method=method, model="ddpm-unet-cifar10",
        fl=FLConfig(num_clients=TRAIN_CLIENTS, local_epochs=1,
                    rounds=BASELINE_ROUNDS),
        data=DataSpec(dataset=BASELINE_DATASET, classes_per_client=2,
                      batch_size=TRAIN_BATCH),
        engine=engine, precision="fp32", lr=TRAIN_LR, seed=0)


def method_state(tr):
    """CPU copies of a flat trainer's global model and method state:
    name -> leaves."""
    from repro_torch.tree import tree_leaves
    out = {"params": tr.params}
    for name, attr in (("c_global", "c_global"),
                       ("c_local", "_c_local_stack"),
                       ("prev", "_prev_stack"), ("local", "_local_stack")):
        if getattr(tr, attr) is not None:
            out[name] = getattr(tr, attr)
    # copies: the stacks are written in place by the next round
    return {k: [x.detach().to("cpu", copy=True) for x in tree_leaves(v)]
            for k, v in out.items()}


def baseline_run(method, engine, rounds, dev, counters, zero_counters):
    """``method`` for ``rounds`` rounds of the ``baselines`` cell through
    ``Experiment``, the counters set to 0 just before it and read just
    after: the history, the method state after each round, kernel
    tallies, launches, local seconds a round and peak memory."""
    import torch
    from repro_torch.experiment.run import Experiment
    from repro_torch.tree import tree_leaves

    exp = Experiment(baseline_spec(method, engine), device=dev)
    tr = exp.trainer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    states = []
    for r in range(1, rounds + 1):
        exp.run(r)
        states.append(method_state(tr))
    torch.cuda.synchronize()
    local_s = list(tr.round_seconds) if engine == "vectorized" else [
        sum(tr.step_seconds)]
    return dict(hist=list(exp.history), states=states,
                tally=tally_of(counters), local_s=local_s,
                launches={k: fn.launches for k, fn in counters.items()},
                peak=torch.cuda.max_memory_allocated(dev), comm=tr.comm,
                images=TRAIN_BATCH * sum(
                    tr.clients[c].data.steps_per_epoch
                    for c in exp.history[0].selected),
                batched_steps=max(tr.clients[c].data.steps_per_epoch
                                  for c in exp.history[0].selected),
                shared=sum(p.numel() for k, v in tr.params.items()
                           if k in BASELINE_SHARED for p in tree_leaves(v)),
                n_params=sum(p.numel() for p in tree_leaves(tr.params)))


def state_diff(a, b, scale=None):
    """max |a - b| of each state entry of two :func:`method_state`s;
    ``scale`` multiplies the control variates' (SCAFFOLD's K lr: their
    change is (x - y) / (K lr), so this puts them in parameter units)."""
    out = {}
    for k in a:
        d = max(float((x - y).abs().max()) for x, y in zip(a[k], b[k],
                                                          strict=True))
        out[k] = d * scale if scale and k.startswith("c_") else d
    return out


def baselines_phase(dev, counters, zero_counters):
    """The five flat baselines on the card.  ``baselines``: each runs
    BASELINE_ROUNDS rounds of the cell on the vectorized engine (round 2
    reads the state round 1 wrote): finite losses, ``comm_gb`` a round
    equal to an analytic count of the bytes its method sends, local
    seconds and images/s a round, peak memory, and exactly the matmul
    and attention launches its local steps' forwards make.
    ``baselines_engines``: one round of each on the sequential engine
    against the vectorized run's first round.  ``baselines_resume``:
    ``runner --method`` for BASELINE_RESUMED, killed after round 1 and
    resumed, against the unbroken vectorized run, bit for bit.  Returns
    the tally of every launch the three made."""
    import numpy as np
    import torch
    from repro_torch.experiment import runner

    register_baseline_data()
    tally, runs = {}, {}
    for m in BASELINE_METHODS:
        run = baseline_run(m, "vectorized", BASELINE_ROUNDS, dev, counters,
                           zero_counters)
        runs[m] = run
        merge_tally(tally, run["tally"])
        hist, launches = run["hist"], run["launches"]
        grad_fw, nograd_fw = BASELINE_FORWARDS.get(m, (1, 0))
        steps = BASELINE_ROUNDS * run["batched_steps"]
        fwd, dx = U_NET_GEMMS
        want = {"block_masked_matmul":
                steps * (grad_fw * (fwd + dx) + nograd_fw * fwd),
                "flash_attention": steps * (grad_fw + nograd_fw)
                * U_NET_ATTENTION}
        mm = run["tally"]["block_masked_matmul"]
        one_client = sorted(key for key in mm if len(key) == 5)
        clients = sorted({key[5] for key in mm if len(key) > 5})
        # the bytes the method sends, counted here from the parameters:
        # fp32 up and down (FedDiffuse the shared half only), SCAFFOLD
        # its fp32 control variates both ways besides
        sent = run["shared"] if m == "feddiffuse" else run["n_params"]
        per_transfer = 4 * sent * (2 if m == "scaffold" else 1)
        C = len(hist[0].selected)
        comm = 2 * C * run["comm"].edge_cloud(per_transfer) / 1e9
        emit("baselines", method=m, engine="vectorized",
             rounds=len(hist), clients=C, batch=TRAIN_BATCH,
             loss=[h.loss for h in hist], comm_gb=[h.comm_gb for h in hist],
             comm_gb_counted=comm, params_m=[h.params_m for h in hist],
             local_s_by_round=run["local_s"],
             images_per_s_by_round=[run["images"] / s
                                    for s in run["local_s"]],
             peak_mem_bytes=run["peak"], launches=launches,
             launches_want=want, matmul_clients=clients,
             one_client_matmul_keys=len(one_client),
             global_forward_m=sorted({key[0] for key in one_client}),
             batched_steps=steps)
        require(len(hist) == BASELINE_ROUNDS
                and all(np.isfinite(h.loss) for h in hist),
                f"baselines {m}: losses {[h.loss for h in hist]}")
        require(all(h.comm_gb == comm for h in hist),
                f"baselines {m}: comm_gb {[h.comm_gb for h in hist]}, "
                f"counted {comm}")
        require(all(launches[k] == n for k, n in want.items()),
                f"baselines {m}: launches {launches}, want {want}")
        require(clients == [C], f"baselines {m}: batched matmul launches "
                                f"at clients {clients}, want [{C}]")
        # MOON's global model: one unstacked forward over all the chunk's
        # images, never C copies of it
        hw = IMAGE[0] * IMAGE[1]
        require((m == "moon") == bool(one_client) and (
            m != "moon" or (C * TRAIN_BATCH * hw, 27, 128, False,
                            "float32") in mm),
                f"baselines {m}: one-client matmul keys {one_client[:3]}")

    for m in BASELINE_METHODS:
        seq = baseline_run(m, "sequential", 1, dev, counters, zero_counters)
        merge_tally(tally, seq["tally"])
        vec = runs[m]
        a, b = vec["hist"][0], seq["hist"][0]
        rel = abs(a.loss - b.loss) / abs(b.loss)
        diff = state_diff(vec["states"][0], seq["states"][0],
                          scale=vec["batched_steps"] * TRAIN_LR)
        emit("baselines_engines", method=m, loss_vectorized=a.loss,
             loss_sequential=b.loss, loss_rel_err=rel,
             loss_rtol=TRAIN_LOSS_RTOL, max_abs_diff=diff,
             atol=TRAIN_PARAMS_ATOL, comm_gb=[a.comm_gb, b.comm_gb],
             local_s=[vec["local_s"][0], seq["local_s"][0]],
             images_per_s=[vec["images"] / vec["local_s"][0],
                           seq["images"] / seq["local_s"][0]],
             peak_mem_bytes=[vec["peak"], seq["peak"]])
        require(rel <= TRAIN_LOSS_RTOL,
                f"baselines_engines {m}: loss {rel} relative")
        require(all(d <= TRAIN_PARAMS_ATOL for d in diff.values()),
                f"baselines_engines {m}: state differs by {diff}")
        require((a.selected, a.comm_gb, a.comm_up_gb, a.comm_down_gb,
                 a.params_m) == (b.selected, b.comm_gb, b.comm_up_gb,
                                 b.comm_down_gb, b.params_m),
                f"baselines_engines {m}: selections or bytes differ")

    last = str(BASELINE_ROUNDS)
    with tempfile.TemporaryDirectory() as tmp:
        for m in BASELINE_RESUMED:
            spec_path = os.path.join(tmp, f"{m}.json")
            with open(spec_path, "w") as f:
                f.write(baseline_spec(m, "vectorized").to_json())
            out = os.path.join(tmp, m)
            zero_counters()
            t0 = time.perf_counter()
            runner.main(["--spec", spec_path, "--rounds", "1", "--out", out,
                         "--device", dev.type])
            back = runner.main(["--out", out, "--resume", "--rounds", last,
                                "--device", dev.type])
            wall = time.perf_counter() - t0
            merge_tally(tally, tally_of(counters))
            whole, state = runs[m], method_state(back.trainer)
            equal = {k: all(torch.equal(x, y) for x, y in zip(
                whole["states"][-1][k], state[k], strict=True))
                for k in state}
            losses = [h.loss for h in back.history]
            emit("baselines_resume", method=m, rounds=len(losses),
                 loss=losses, loss_unbroken=[h.loss for h in whole["hist"]],
                 bitwise=equal, wall_s=wall,
                 ckpt_bytes=os.path.getsize(os.path.join(out, "ckpt.npz")))
            require(all(equal.values())
                    and losses == [h.loss for h in whole["hist"]],
                    f"baselines_resume {m}: not bitwise: {equal}, losses "
                    f"{losses}")
            del back
    return tally


def baselines_memory_phase(dev):
    """For BASELINE_MEMORY_METHODS: the paper preset's round (20 clients,
    batch 32) cut to one step a client, so that its one round is one
    batched step a chunk, in chunks of the k ``client_chunk`` picks for
    the paper preset's 8 steps a client, with the trainer's 20-row method
    state on the card.  The round's peak, less what was allocated before
    the trainer, must not exceed ``round_bytes``' estimate for that
    round, nor the peak the card."""
    import torch
    from repro_torch.configs import CIFAR10_UNET, FLConfig
    from repro_torch.data import (CIFAR10_LIKE, ClientData, make_dataset,
                                  shards_per_client)
    from repro_torch.fl.baselines import FlatTrainer
    from repro_torch.fl.client import Client
    from repro_torch.fl.engine import (client_chunk, make_round_engine,
                                       round_bytes)
    from repro_torch.kernels.block_masked_matmul import ops as bmm

    cfg = CIFAR10_UNET.replace(precision="fp32")
    total = torch.cuda.get_device_properties(dev).total_memory
    ds = dataclasses.replace(CIFAR10_LIKE, samples_per_class=64)
    images, labels = make_dataset(ds, seed=0)
    parts = shards_per_client(labels, PAPER_CLIENTS, 2, seed=0)
    img = (TRAIN_BATCH,) + IMAGE
    for m in BASELINE_MEMORY_METHODS:
        clients = [Client(i, ClientData(images[p], labels[p],
                                        batch_size=TRAIN_BATCH, seed=i),
                          ds.num_classes) for i, p in enumerate(parts)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fl = FLConfig(num_clients=PAPER_CLIENTS, rounds=1)
        tr = FlatTrainer(m, cfg, fl, clients, lr=TRAIN_LR,
                         engine="vectorized", device=dev)
        stored = tr._stored_copies()
        k = client_chunk(cfg, (PAPER_CLIENTS, PAPER_STEPS) + img, total,
                         method=m, stored=stored)
        # one step a client would fit more clients a chunk: hold the
        # engine to the paper preset's k
        tr._round_engine = make_round_engine(cfg, fl, method=m, lr=TRAIN_LR,
                                             max_clients=k)
        shape = (PAPER_CLIENTS, 1) + img
        estimate = round_bytes(cfg, shape, k, method=m, stored=stored)
        bmm.block_masked_matmul.shapes.clear()
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        chunks = sorted({key[5] for key in bmm.block_masked_matmul.shapes
                         if len(key) > 5})
        emit("baselines_memory", method=m, clients=PAPER_CLIENTS,
             steps_per_client=1, chunk=k, chunk_clients=chunks,
             stored_copies=stored, estimate_bytes=estimate,
             peak_mem_bytes=peak, base_mem_bytes=base,
             total_mem_bytes=total, loss=tr.history[0].loss,
             round_s=seconds)
        del tr, clients
        torch.cuda.empty_cache()
        require(chunks and max(chunks) == k,
                f"baselines_memory {m}: chunks at {chunks}, want k = {k}")
        require(peak - base <= estimate,
                f"baselines_memory {m}: peak {peak} less {base} above the "
                f"estimate {estimate}")
        require(peak < total, f"baselines_memory {m}: peak {peak} of "
                              f"{total}")


def centralized_phase(dev):
    """``run_centralized`` at full width: CENTRAL_STEPS steps at batch 32
    on the ``train`` cell's 320 images with the EMA.  The EMA is
    recomputed here from every step's params, in fp32 with the formula
    written out (it must equal the returned params bit for bit) and in
    float64 (reported)."""
    import numpy as np
    import torch
    from repro_torch.configs import CIFAR10_UNET
    from repro_torch.data import CIFAR10_LIKE, make_dataset
    from repro_torch.fl import baselines
    from repro_torch.tree import tree_leaves

    images, _ = make_dataset(dataclasses.replace(CIFAR10_LIKE,
                                                 samples_per_class=32),
                             seed=0)
    mine = {}
    real_init, real_update = baselines.ema_init, baselines.ema_update

    def record_init(params):
        mine["fp32"] = [p.detach().float().clone()
                        for p in tree_leaves(params)]
        mine["fp64"] = [p.detach().double() for p in tree_leaves(params)]
        mine["updates"] = 0
        return real_init(params)

    def record_update(ema, params, decay):
        ps = tree_leaves(params)
        mine["fp32"] = [decay * e + (1.0 - decay) * p.float()
                        for e, p in zip(mine["fp32"], ps)]
        mine["fp64"] = [decay * e + (1.0 - decay) * p.double()
                        for e, p in zip(mine["fp64"], ps)]
        mine["updates"] += 1
        return real_update(ema, params, decay)

    baselines.ema_init, baselines.ema_update = record_init, record_update
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = baselines.run_centralized(
            CIFAR10_UNET.replace(precision="fp32"), images,
            steps=CENTRAL_STEPS, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
            device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        baselines.ema_init, baselines.ema_update = real_init, real_update
    got = tree_leaves(params)
    equal = all(torch.equal(a, b) for a, b in zip(got, mine["fp32"],
                                                  strict=True))
    d64 = max(float((a.double() - b).abs().max())
              for a, b in zip(got, mine["fp64"]))
    emit("centralized", steps=len(losses), batch=TRAIN_BATCH, loss=losses,
         ema_updates=mine["updates"], ema_bitwise_fp32=equal,
         ema_max_abs_diff_fp64=d64, seconds=seconds,
         images_per_s=TRAIN_BATCH * len(losses) / seconds)
    require(len(losses) == CENTRAL_STEPS and np.all(np.isfinite(losses)),
            f"centralized: losses {losses}")
    require(mine["updates"] == CENTRAL_STEPS and equal,
            f"centralized: the EMA differs from its recomputation "
            f"({mine['updates']} updates, fp64 diff {d64})")


# kernel-name fragments -> category, for the profile's device-time split
# ---------------------------------------------------------------------------
# phases 4b, 7d, 7e: bf16 training, faults, the quantized uplink
# ---------------------------------------------------------------------------

def train_bf16_phase(cfg, dev, counters, zero_counters, fp32_run):
    """``train (vectorized)`` at bf16: the same FedPhD run as the first
    vectorized fp32 run (``fp32_run``), the params cast to bf16 inside
    the loss.  Finite losses, each round's loss within BF16_LOSS_ATOL of
    the fp32 run's, the downloads exactly half the fp32 run's, the fp32
    run's launch counts with every matmul, attention and group-L2 launch
    in bf16; peak memory and images/s beside the fp32 run's.  Returns
    the run's tallies, which the kernel checks hold against the plain
    versions."""
    import numpy as np

    run = train_run(cfg, dev, "vectorized", counters, zero_counters,
                    precision="bf16")
    hist, fp = run["hist"], fp32_run["hist"]
    tally, launches = run["tally"], run["launches"]
    images = TRAIN_BATCH * sum(run["steps"])
    loss_diff = [abs(a.loss - b.loss) for a, b in zip(hist, fp)]
    dtypes = {k: sorted({key[-1] if k == "flash_attention" else key[4]
                         for key in tally[k]})
              for k in ("block_masked_matmul", "flash_attention")}
    # group-L2 launches by their members' dtype: Omega reads the bf16
    # casts, the prune's scores the fp32 params
    gl2_dtypes = {}
    for key, n in tally["group_l2_norms"].items():
        dt = "/".join(sorted({dt for _, dt in key[0]}))
        gl2_dtypes[dt] = gl2_dtypes.get(dt, 0) + n
    emit("train_bf16", engine="vectorized", precision="bf16",
         loss=[h.loss for h in hist], loss_fp32=[h.loss for h in fp],
         loss_abs_diff=loss_diff, loss_atol=BF16_LOSS_ATOL,
         comm_down_gb=[h.comm_down_gb for h in hist],
         comm_down_gb_fp32=[h.comm_down_gb for h in fp],
         comm_up_gb=[h.comm_up_gb for h in hist],
         params_m=[h.params_m for h in hist],
         local_s_by_round=run["round_s"],
         images_per_s=images / sum(run["round_s"]),
         images_per_s_fp32=images / sum(fp32_run["round_s"]),
         peak_mem_bytes=run["peak"], peak_mem_bytes_fp32=fp32_run["peak"],
         launches=dict(launches, group_l2_norms_bwd=run["gl2_bwd"]),
         kernel_dtypes=dict(dtypes, group_l2_norms=gl2_dtypes),
         matmul_shapes=len(tally["block_masked_matmul"]),
         matmul_dx_shapes=len(tally["block_masked_matmul_dx"]),
         attention_shapes=sorted(tally["flash_attention"]))
    require(all(np.isfinite(h.loss) for h in hist) and len(hist) == 3,
            f"train_bf16: losses {[h.loss for h in hist]}")
    require(max(loss_diff) <= BF16_LOSS_ATOL,
            f"train_bf16: losses {loss_diff} from the fp32 run's, limit "
            f"{BF16_LOSS_ATOL}")
    require([2 * h.comm_down_gb for h in hist]
            == [h.comm_down_gb for h in fp]
            and [h.comm_up_gb for h in hist] == [h.comm_up_gb for h in fp],
            "train_bf16: downloads not half the fp32 run's, or uploads "
            "not equal")
    got = dict(launches, group_l2_norms_bwd=run["gl2_bwd"])
    require(got == dict(VECTORIZED_LAUNCHES, rglru_scan=0, wkv6=0),
            f"train_bf16: launches {got}, want {VECTORIZED_LAUNCHES}")
    require(dtypes == {"block_masked_matmul": ["bfloat16"],
                       "flash_attention": ["bfloat16"]}
            and gl2_dtypes == {"bfloat16": 2, "float32": 1},
            f"train_bf16: kernel dtypes {dtypes}, group-L2 launches by "
            f"dtype {gl2_dtypes} (want Omega's 2 in bf16, the prune's 1 "
            f"in fp32)")
    return tally


def fl_spec(method, engine, rounds, *, fault=None, quant="none", seed=0):
    """FedPhD (or a flat method) on the ``train`` cell through the
    experiment API: full-width CIFAR10_UNET in fp32, 4 clients of 2
    classes (80 images, 2 steps a round), batch 32; FedPhD with 2 edges,
    the cloud every round and the prune at R_s = 2, as
    :func:`make_trainer`'s; ``fault`` a FaultSpec's fields."""
    from repro_torch.configs import FLConfig
    from repro_torch.experiment.registry import method_entry
    from repro_torch.experiment.spec import (CommSpec, DataSpec,
                                             ExperimentSpec, FaultSpec)
    fl = FLConfig(num_clients=TRAIN_CLIENTS, local_epochs=1, rounds=rounds)
    if method_entry(method).topology == "hierarchical":
        fl = FLConfig(num_clients=TRAIN_CLIENTS, num_edges=2,
                      participation=1.0, local_epochs=1, edge_agg_every=1,
                      cloud_agg_every=1, rounds=rounds, sparse_rounds=2,
                      prune_ratio=0.44)
    return ExperimentSpec(
        name=f"{method}-{engine}", method=method, model="ddpm-unet-cifar10",
        fl=fl, data=DataSpec(dataset=BASELINE_DATASET, classes_per_client=2,
                             batch_size=TRAIN_BATCH),
        engine=engine, precision="fp32", lr=TRAIN_LR, seed=seed,
        fault=FaultSpec(**(fault or {})), comm=CommSpec(quant=quant))


def fl_run(spec, dev, counters, zero_counters, rounds=None):
    """``spec`` for ``rounds`` rounds (default its own) through
    ``Experiment``, the counters set to 0 just before and read just
    after: the experiment, history, FedPhD's edge assignment of every
    round (the engines' argument, recorded), the parameter count before
    each round and after the last, CPU copies of the params and the
    error-feedback rows after round 1, kernel tallies and launches,
    local seconds and peak memory."""
    import torch
    from repro_torch.experiment.run import Experiment
    from repro_torch.tree import tree_leaves

    exp = Experiment(spec, device=dev)
    tr = exp.trainer
    assignments = []
    for name in ("_local_and_edge_sequential", "_local_and_edge_vectorized"):
        if hasattr(tr, name):
            def rec(r, assignment, *a, _inner=getattr(tr, name)):
                assignments.append({e: list(c)
                                    for e, c in assignment.items()})
                return _inner(r, assignment, *a)
            setattr(tr, name, rec)
    count = lambda: sum(p.numel() for p in tree_leaves(tr.params))
    n_params = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    first = {}
    for r in range(1, (rounds or spec.fl.rounds) + 1):
        n_params.append(count())
        exp.run(r)
        if r == 1:
            first = {k: [x.detach().to("cpu", copy=True)
                         for x in tree_leaves(t)]
                     for k, t in (("params", tr.params),
                                  ("err", getattr(tr, "_err_stack", None)))
                     if t is not None}
    torch.cuda.synchronize()
    n_params.append(count())
    gl2 = counters["group_l2_norms"]
    return dict(exp=exp, tr=tr, hist=list(exp.history), first=first,
                assignments=assignments, n_params=n_params,
                leaves=len(tree_leaves(tr.params)),
                tally=tally_of(counters),
                launches=dict({k: fn.launches for k, fn in counters.items()},
                              group_l2_norms_bwd=gl2.bwd_launches),
                local_s=list(tr.round_seconds) or [sum(tr.step_seconds)],
                peak=torch.cuda.max_memory_allocated(dev))


def want_launches(run, engine, hierarchical, sparse_rounds=2):
    """The launches a run must make, from its availability records: a
    client step is 101 forward and 99 dx matmul launches and 6 attention
    launches; the sequential engine runs each client's budget, the
    vectorized one max(budget) batched steps a round (the steps no
    client reaches are not run); FedPhD's sparse rounds (r < R_s,
    ``sparse_rounds``) add one group-L2 launch and one backward a step,
    the prune one group-L2 launch."""
    fwd, dx = U_NET_GEMMS
    steps = sparse = 0
    for h in run["hist"]:
        budgets = h.availability["budgets"] if h.availability else [
            run["tr"].clients[c].data.steps_per_epoch for c in h.selected]
        n = sum(budgets) if engine == "sequential" else max(budgets,
                                                            default=0)
        steps += n
        sparse += n if hierarchical and h.round < sparse_rounds else 0
    prunes = sum(h.pruned for h in run["hist"])
    return {"block_masked_matmul": steps * (fwd + dx),
            "flash_attention": steps * U_NET_ATTENTION,
            "group_l2_norms": sparse + prunes, "group_l2_norms_bwd": sparse,
            "rglru_scan": 0, "wkv6": 0}


def counted_comm(run, quant="none", flat_method=None):
    """Each round's ``(comm_gb, comm_up_gb, comm_down_gb)`` counted here
    from its availability record, FedPhD's edge assignment and the
    parameter counts, in the trainer's order of summation: the on-time
    uplink ``n + 4 L`` bytes when quantized (n parameters, L leaves),
    else ``4 n``, late uploads ``4 n``, downloads ``4 n`` to every
    arrived client; FedPhD's edges send ``4 n`` to the cloud and the
    cloud ``4 n'`` back to each edge (n' after the prune); the flat
    methods send and receive through ``edge_cloud``, SCAFFOLD ``4 n``
    more each way."""
    comm, out = run["tr"].comm, []
    L = run["leaves"]
    for i, h in enumerate(run["hist"]):
        av = h.availability
        n, n_post = run["n_params"][i], run["n_params"][i + 1]
        up_f = 4 * n
        up_q = up_f if quant == "none" else n + 4 * L
        done = set(h.selected) if av is None else \
            set(av["arrived"]) - set(av["dropped"])
        late = set() if av is None else set(av["late"])
        arrived = set(h.selected) if av is None else set(av["arrived"])
        up = down = 0.0
        if flat_method is not None:
            extra = 4 * n if flat_method == "scaffold" else 0
            if av is None:
                up = len(h.selected) * comm.edge_cloud(up_q + extra)
                down = len(h.selected) * comm.edge_cloud(4 * n + extra)
            else:
                up = len(done - late) * comm.edge_cloud(up_q + extra) \
                    + len(done & late) * comm.edge_cloud(up_f + extra)
                down = len(arrived) * comm.edge_cloud(4 * n + extra)
        else:
            asg = run["assignments"][i]
            for e, cids in asg.items():
                for c in cids:
                    if c in done:
                        up += comm.client_edge(up_f if c in late else up_q)
            for e, cids in asg.items():
                if cids:
                    down += comm.client_edge(4 * n) * len(arrived & set(cids))
            edges = [e for e, c in asg.items() if c] if i == 0 \
                else list(asg)
            for _ in edges:
                up += comm.edge_cloud(up_f)
            down += comm.edge_cloud(4 * n_post) * len(asg)
        out.append((up / 1e9 + down / 1e9, up / 1e9, down / 1e9))
    return out


def mixed_rounds(run):
    """The rounds of ``run`` in which one aggregate (a FedPhD edge, or
    the flat server) took an on-time reporter and buffered a late
    client."""
    out = []
    for i, h in enumerate(run["hist"]):
        av = h.availability
        late = set(av["late"])
        on_time = set(av["arrived"]) - set(av["dropped"]) - late
        groups = run["assignments"][i].values() if run["assignments"] \
            else [h.selected]
        if any(set(c) & on_time and set(c) & late for c in groups):
            out.append(h.round)
    return out


def tree_max_diff(a, b):
    from repro_torch.tree import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def trees_equal(a, b):
    import torch
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b),
                                                 strict=True))


def resume_run(spec, dev, counters, zero_counters, tally):
    """``runner --spec`` for one round into a temporary ``--out``, then
    ``--resume`` to the spec's last round: the resumed experiment, the
    seconds and the checkpoint's bytes; the launches go to ``tally``."""
    from repro_torch.experiment import runner
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            f.write(spec.to_json())
        out = os.path.join(tmp, "out")
        zero_counters()
        t0 = time.perf_counter()
        runner.main(["--spec", path, "--rounds", "1", "--out", out,
                     "--device", dev.type])
        back = runner.main(["--out", out, "--resume", "--rounds",
                            str(spec.fl.rounds), "--device", dev.type])
        wall = time.perf_counter() - t0
        merge_tally(tally, tally_of(counters))
        return back, wall, os.path.getsize(os.path.join(out, "ckpt.npz"))


def faults_phase(dev, counters, zero_counters):
    """Fault injection on the card (``faults``): on the ``train`` cell,
    the experiment seed FAULT_SEED, through the experiment API: FedPhD
    (SH aggregation) under FAULT_SPEC and ``fedphd-stale`` under
    FAULT_STALE for 3 rounds (sparse, the prune, compacted) and
    ``fedavg-stale`` under FAULT_STALE for 2, on each engine.  Per run:
    each round's availability, loss and bytes;
    ``comm_gb`` equal to the count of :func:`counted_comm`; exactly the
    launches of :func:`want_launches`.  Between the engines: the
    availability, selections and bytes identical, each round's loss
    within TRAIN_LOSS_RTOL, the params (and late deltas) within
    TRAIN_PARAMS_ATOL.  ``faults_resume``: ``fedphd-stale`` killed after
    round 1 and resumed through the runner, bit for bit against the
    unbroken vectorized run (history with availability, params, late
    deltas, the fault stream).  The runs must show a dropped client and
    a late one, and each staleness run a round in which one aggregate
    took an on-time reporter and buffered a late client.  Returns the
    tally of every launch."""
    import numpy as np
    from repro_torch.experiment.registry import method_entry

    register_baseline_data()
    tally, vec_runs, rounds_seen = {}, {}, []
    for method, rounds, fault in FAULT_RUNS:
        hier = method_entry(method).topology == "hierarchical"
        runs = {}
        for engine in TRAIN_ENGINES:
            run = fl_run(fl_spec(method, engine, rounds, fault=fault,
                                 seed=FAULT_SEED),
                         dev, counters, zero_counters)
            runs[engine] = run
            merge_tally(tally, run["tally"])
            hist = run["hist"]
            counted = counted_comm(run, flat_method=None if hier
                                   else method.split("-")[0])
            want = want_launches(run, engine, hier)
            mixed = mixed_rounds(run)
            emit("faults", method=method, engine=engine,
                 fault=fault, seed=FAULT_SEED, rounds=len(hist),
                 availability=[h.availability for h in hist],
                 mixed_rounds=mixed,
                 loss=[h.loss for h in hist],
                 comm_gb=[h.comm_gb for h in hist],
                 comm_gb_counted=[c[0] for c in counted],
                 comm_up_gb=[h.comm_up_gb for h in hist],
                 params_m=[h.params_m for h in hist],
                 pruned=[h.pruned for h in hist],
                 launches=run["launches"], launches_want=want,
                 local_s=run["local_s"], peak_mem_bytes=run["peak"])
            rounds_seen += [h.availability for h in hist]
            require(len(hist) == rounds
                    and all(np.isfinite(h.loss) for h in hist),
                    f"faults {method} {engine}: losses "
                    f"{[h.loss for h in hist]}")
            require([(h.comm_gb, h.comm_up_gb, h.comm_down_gb)
                     for h in hist] == counted,
                    f"faults {method} {engine}: bytes "
                    f"{[h.comm_gb for h in hist]}, counted {counted}")
            require(run["launches"] == want,
                    f"faults {method} {engine}: launches {run['launches']}"
                    f", want {want}")
            require(not hier or [h.pruned for h in hist]
                    == [False, True, False],
                    f"faults {method} {engine}: the prune round "
                    f"{[h.pruned for h in hist]}")
            require(mixed or not method.endswith("-stale"),
                    f"faults {method} {engine}: no aggregate took an "
                    f"on-time reporter and a late client")
        seq, vec = runs["sequential"], runs["vectorized"]
        vec_runs[method] = vec
        keys = ("selected", "availability", "comm_gb", "comm_up_gb",
                "comm_down_gb", "params_m")
        same = [[getattr(h, k) for k in keys] for h in seq["hist"]] == \
            [[getattr(h, k) for k in keys] for h in vec["hist"]]
        rel = [abs(a.loss - b.loss) / max(abs(a.loss), 1e-30)
               for a, b in zip(seq["hist"], vec["hist"])]
        diff = tree_max_diff(seq["tr"].params, vec["tr"].params)
        seq_late, vec_late = (r["tr"].late_buffers() for r in (seq, vec))
        late_diff = [tree_max_diff(seq_late[e], vec_late[e])
                     for e in vec_late]
        emit("faults_engines", method=method, same_records=same,
             loss_rel_err=rel, loss_rtol=TRAIN_LOSS_RTOL,
             max_abs_param_diff=diff, late_max_abs_diff=late_diff,
             params_atol=TRAIN_PARAMS_ATOL)
        require(same, f"faults_engines {method}: availability, selections "
                      f"or bytes differ")
        require(max(rel) <= TRAIN_LOSS_RTOL,
                f"faults_engines {method}: losses {rel} relative")
        require(seq_late.keys() == vec_late.keys()
                and max([diff] + late_diff) <= TRAIN_PARAMS_ATOL,
                f"faults_engines {method}: params {diff}, late deltas "
                f"{late_diff}")
        del runs, seq
    dropped = [i for i, a in enumerate(rounds_seen) if a["dropped"]]
    late = [i for i, a in enumerate(rounds_seen) if a["late"]]
    require(dropped and late, f"faults: seed {FAULT_SEED} gave no dropped "
                              f"or no late client: {rounds_seen}")

    whole = vec_runs[FAULT_RESUMED]
    back, wall, nbytes = resume_run(
        fl_spec(FAULT_RESUMED, "vectorized", 3, fault=FAULT_STALE,
                seed=FAULT_SEED), dev, counters, zero_counters, tally)
    a, b = whole["tr"], back.trainer
    a_late, b_late = a.late_buffers(), b.late_buffers()
    same_hist = [h.to_dict() for h in back.history] == \
        [h.to_dict() for h in whole["hist"]]
    equal = {"params": trees_equal(a.params, b.params),
             "late": a_late.keys() == b_late.keys() and all(
                 trees_equal(a_late[e], b_late[e]) for e in a_late),
             "fault_stream": a._faults.state() == b._faults.state()}
    emit("faults_resume", method=FAULT_RESUMED, history_equal=same_hist,
         bitwise=equal, wall_s=wall, ckpt_bytes=nbytes,
         availability=[h.availability for h in back.history])
    require(same_hist and all(equal.values()),
            f"faults_resume: history equal {same_hist}, {equal}")
    return tally


def uplink_scales(quant):
    """Wraps the sequential FedPhD's uplink round trip to record, for
    each client and leaf, the widest gap between two neighbouring codes
    (int8: the scale; fp8: 32 scales, its step in [256, 448]): the bound
    of :func:`quant_phase`'s engine check.  It is taken on the untimed
    sequential run, so that no vectorized run is timed with it.
    Returns (the list it fills, a list of leaves a client, and the
    function to undo the wrap)."""
    from repro_torch.core import hfl
    from repro_torch.fl import compress
    from repro_torch.tree import tree_leaves
    inner, scales = hfl.ef_roundtrip, []

    def wrapped(trained, err, q, *, start):
        scales.append([float(((y.float() - x.float()) + e).abs().max())
                       / compress._QMAX[q] * QUANT_STEP[q]
                       for y, x, e in zip(tree_leaves(trained),
                                          tree_leaves(start),
                                          tree_leaves(err), strict=True)])
        return inner(trained, err, q, start=start)
    hfl.ef_roundtrip = wrapped
    return scales, lambda: setattr(hfl, "ef_roundtrip", inner)


def quantizer_check(dev, params):
    """The card's quantizer against the CPU's on the same inputs, for
    int8 and fp8: ``ef_roundtrip_stacked`` of 2 clients' fp32 delta rows
    (deltas of 1e-3, error rows of 1e-4), and ``ef_roundtrip`` of one,
    in the shapes of ``params``, with two
    leaves more: exact .5 ties (int8)
    or ties between fp8 neighbours at scale 1, and deltas far beyond
    +-448.  Payloads, dequantized deltas and residuals bitwise."""
    import torch
    from repro_torch.fl.compress import ef_roundtrip, ef_roundtrip_stacked
    from repro_torch.tree import tree_map
    cpu = torch.device("cpu")
    gen = torch.Generator(dev)
    gen.manual_seed(11)
    ties = {"int8": [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.25],
            "fp8": [448.0, 1.0625, 1.1875, 17.0, 432.0, -432.0,
                    3 * 2.0 ** -10, 1e-4, -300.0]}
    out = {}
    for quant in ("int8", "fp8"):
        delta = tree_map(lambda p: torch.randn(
            (2,) + tuple(p.shape), generator=gen, device=dev) * 1e-3, params)
        delta["ties"] = torch.tensor([ties[quant]] * 2, device=dev)
        delta["over"] = torch.randn((2, 4096), generator=gen,
                                    device=dev) * 1e4
        err = tree_map(lambda d: torch.randn(
            d.shape, generator=gen, device=dev) * 1e-4, delta)
        err["ties"].zero_()
        cpu_of = lambda t: tree_map(lambda x: x.to(cpu), t)
        got = ef_roundtrip_stacked(delta, err, quant)
        want = ef_roundtrip_stacked(cpu_of(delta), cpu_of(err), quant)
        one = tree_map(lambda x: x[1], delta)
        got1 = ef_roundtrip(one, tree_map(lambda x: x[1], err), quant)
        want1 = ef_roundtrip(cpu_of(one), cpu_of(tree_map(lambda x: x[1],
                                                          err)), quant)
        out[quant] = all(trees_equal(cpu_of(g), w) for g, w in
                         zip(got + got1, want + want1))
        del delta, err, got, want, got1, want1
    emit("quant", run="quantizer card vs cpu", bitwise=out,
         leaves=len(params) + 2)
    require(all(out.values()), f"quant: the card's quantizer differs from "
                               f"the CPU's: {out}")


def quant_phase(dev, counters, zero_counters):
    """The quantized uplink with error feedback on the card
    (``quant``), on the ``train`` cell through the experiment API,
    without faults: FedPhD in int8 for 3 rounds (through the prune) and
    fp8 for 2 on the vectorized engine, and one round of each on the
    sequential engine against the vectorized run's first; SCAFFOLD in
    int8 for 2 rounds and fp8 for 1, vectorized.  Each round's bytes
    equal :func:`counted_comm`'s (the on-time uplink ``n + 4 L`` bytes,
    its ratio to the fp32 uplink ``4 n`` reported), exact launches,
    finite losses.  Sequential against vectorized: the bytes identical,
    the loss within TRAIN_LOSS_RTOL, each leaf of the params within
    TRAIN_PARAMS_ATOL plus its largest quantization bucket, and
    TRAIN_PARAMS_BULK[1] of them within TRAIN_PARAMS_BULK[0] plus it.
    ``quant_resume``: FedPhD int8 killed after round 1 and resumed,
    its params, error-feedback rows and history bit for bit.  Then the
    card's quantizer against the CPU's (:func:`quantizer_check`).
    Returns the tally of every launch."""
    import numpy as np
    import torch
    from repro_torch.experiment.registry import method_entry
    from repro_torch.tree import tree_leaves

    register_baseline_data()
    tally, whole = {}, {}
    for method, quant, rounds in QUANT_RUNS:
        hier = method_entry(method).topology == "hierarchical"
        run = fl_run(fl_spec(method, "vectorized", rounds, quant=quant),
                     dev, counters, zero_counters)
        merge_tally(tally, run["tally"])
        hist = run["hist"]
        counted = counted_comm(run, quant, None if hier else method)
        want = want_launches(run, "vectorized", hier)
        n, L = run["n_params"][0], run["leaves"]
        extra = 4 * n if method == "scaffold" else 0
        emit("quant", method=method, quant=quant, engine="vectorized",
             rounds=len(hist), loss=[h.loss for h in hist],
             comm_gb=[h.comm_gb for h in hist],
             comm_up_gb=[h.comm_up_gb for h in hist],
             comm_up_gb_counted=[c[1] for c in counted],
             uplink_bytes=n + 4 * L + extra, uplink_bytes_fp32=4 * n + extra,
             uplink_ratio=(n + 4 * L + extra) / (4 * n + extra),
             params_m=[h.params_m for h in hist],
             launches=run["launches"], launches_want=want,
             local_s=run["local_s"], peak_mem_bytes=run["peak"],
             err_rows_max_abs=float(max(
                 x.abs().max() for x in tree_leaves(run["tr"]._err_stack))))
        require(all(np.isfinite(h.loss) for h in hist)
                and len(hist) == rounds,
                f"quant {method} {quant}: losses {[h.loss for h in hist]}")
        require([(h.comm_gb, h.comm_up_gb, h.comm_down_gb)
                  for h in hist] == counted,
                f"quant {method} {quant}: bytes {[h.comm_gb for h in hist]}"
                f", counted {counted}")
        require(run["launches"] == want,
                f"quant {method} {quant}: launches {run['launches']}, "
                f"want {want}")
        if method != "fedphd":
            continue
        whole[quant] = run
        scales, undo = uplink_scales(quant)
        try:
            seq = fl_run(fl_spec(method, "sequential", rounds, quant=quant),
                         dev, counters, zero_counters, rounds=1)
        finally:
            undo()
        merge_tally(tally, seq["tally"])
        a, b = seq["hist"][0], hist[0]
        # each leaf's widest bucket over round 1's clients
        bucket = [max(leaf) for leaf in zip(*scales)]
        diffs, bulk = [], []
        for x, y, s in zip(seq["first"]["params"], run["first"]["params"],
                           bucket, strict=True):
            d = (x - y).abs()
            diffs.append(float(d.max()) - s)
            bulk.append(float((d <= TRAIN_PARAMS_BULK[0] + s).float().sum()))
        share = sum(bulk) / run["n_params"][0]
        rel = abs(a.loss - b.loss) / abs(b.loss)
        emit("quant_engines", method=method, quant=quant,
             comm_gb=[a.comm_gb, b.comm_gb], loss_rel_err=rel,
             max_abs_param_diff_over_bucket=max(diffs),
             largest_bucket=max(bucket), params_within_bucket_bulk=share,
             err_rows_max_abs_diff=max(
                 float((x - y).abs().max()) for x, y in zip(
                     seq["first"]["err"], run["first"]["err"])),
             launches_sequential=seq["launches"])
        require((a.selected, a.comm_gb, a.comm_up_gb, a.comm_down_gb)
                == (b.selected, b.comm_gb, b.comm_up_gb, b.comm_down_gb),
                f"quant_engines {quant}: selections or bytes differ")
        require(rel <= TRAIN_LOSS_RTOL,
                f"quant_engines {quant}: loss {rel} relative")
        require(max(diffs) <= TRAIN_PARAMS_ATOL
                and share >= TRAIN_PARAMS_BULK[1],
                f"quant_engines {quant}: params beyond a bucket by "
                f"{max(diffs)}, {share} within {TRAIN_PARAMS_BULK[0]} of it")
        del seq

    run = whole[QUANT_RESUMED]
    back, wall, nbytes = resume_run(
        fl_spec("fedphd", "vectorized", 3, quant=QUANT_RESUMED), dev,
        counters, zero_counters, tally)
    a, b = run["tr"], back.trainer
    same_hist = [h.to_dict() for h in back.history] == \
        [h.to_dict() for h in run["hist"]]
    equal = {"params": trees_equal(a.params, b.params),
             "err_rows": trees_equal(a._err_stack, b._err_stack)}
    err_max = max(float(x.abs().max()) for x in tree_leaves(b._err_stack))
    emit("quant_resume", method="fedphd", quant=QUANT_RESUMED,
         history_equal=same_hist, bitwise=equal, wall_s=wall,
         ckpt_bytes=nbytes, err_rows_max_abs=err_max)
    require(same_hist and all(equal.values()) and err_max > 0,
            f"quant_resume: history equal {same_hist}, {equal}, error "
            f"rows up to {err_max}")
    quantizer_check(dev, b.params)
    whole.clear()
    del back, a, b, run
    torch.cuda.empty_cache()
    return tally


def quant_memory_phase(dev):
    """FedPhD with the int8 uplink over the paper preset's round (20
    clients, 2 edges, batch 32) cut to one step a client, in chunks of
    the k ``client_chunk`` picks for the paper preset's 8 steps with the
    uplink's rows counted, the 20 error-feedback rows on the card: its
    peak, less what was allocated before the trainer, must not exceed
    ``round_bytes``' estimate nor the card.  The fp32 uplink's k is
    given beside it."""
    import torch
    from repro_torch.configs import CIFAR10_UNET
    from repro_torch.core.hfl import FedPhD
    from repro_torch.data import (CIFAR10_LIKE, ClientData, make_dataset,
                                  shards_per_client)
    from repro_torch.experiment.runner import PRESETS
    from repro_torch.fl.client import Client
    from repro_torch.fl.engine import (client_chunk, make_round_engine,
                                       round_bytes)
    from repro_torch.kernels.block_masked_matmul import ops as bmm

    cfg = CIFAR10_UNET.replace(precision="fp32")
    total = torch.cuda.get_device_properties(dev).total_memory
    ds = dataclasses.replace(CIFAR10_LIKE, samples_per_class=64)
    images, labels = make_dataset(ds, seed=0)
    parts = shards_per_client(labels, PAPER_CLIENTS, 2, seed=0)
    clients = [Client(i, ClientData(images[p], labels[p],
                                    batch_size=TRAIN_BATCH, seed=i),
                      ds.num_classes) for i, p in enumerate(parts)]
    img = (TRAIN_BATCH,) + IMAGE
    fl = dataclasses.replace(PRESETS["paper"].fl, rounds=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tr = FedPhD(cfg, fl, clients, lr=TRAIN_LR, engine="vectorized",
                quant="int8", device=dev)
    stored = tr._stored_copies()
    paper = (PAPER_CLIENTS, PAPER_STEPS) + img
    k = client_chunk(cfg, paper, total, edges=fl.num_edges, stored=stored,
                     quant=True)
    k_fp32 = client_chunk(cfg, paper, total, edges=fl.num_edges)
    # one step a client would fit more clients a chunk: hold the engine
    # to the paper preset's k
    tr._engine_sparse = make_round_engine(cfg, fl, sparse=True,
                                          groups=tr.groups, lr=TRAIN_LR,
                                          max_clients=k, quant="int8")
    estimate = round_bytes(cfg, (PAPER_CLIENTS, 1) + img, k,
                           edges=fl.num_edges, stored=stored, quant=True)
    bmm.block_masked_matmul.shapes.clear()
    t0 = time.perf_counter()
    tr.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    chunks = sorted({key[5] for key in bmm.block_masked_matmul.shapes
                     if len(key) > 5})
    emit("quant_memory", quant="int8", clients=PAPER_CLIENTS,
         steps_per_client=1, chunk=k, chunk_fp32=k_fp32,
         chunk_clients=chunks, stored_copies=stored,
         estimate_bytes=estimate, peak_mem_bytes=peak, base_mem_bytes=base,
         total_mem_bytes=total, loss=tr.history[0].loss, round_s=seconds,
         comm_up_gb=tr.history[0].comm_up_gb)
    del tr, clients
    torch.cuda.empty_cache()
    require(chunks and max(chunks) == k,
            f"quant_memory: chunks at {chunks}, want k = {k}")
    require(peak - base <= estimate,
            f"quant_memory: peak {peak} less {base} above the estimate "
            f"{estimate}")
    require(peak < total, f"quant_memory: peak {peak} of {total}")


# ---------------------------------------------------------------------------
# phase 7g: sweeps, reports and cluster execution
# ---------------------------------------------------------------------------

def sweep_grid():
    """The ``sweep`` cell: the ``train`` cell's spec (:func:`fl_spec`:
    full-width CIFAR10_UNET in fp32, 4 clients of 2 classes, 2 edges,
    batch 32, the vectorized engine) for SWEEP_ROUNDS rounds with R_s
    past them and the eval hook at the last, over SWEEP_AXES."""
    from repro_torch.experiment.sweep import SweepSpec
    base = fl_spec("fedphd", "vectorized", SWEEP_ROUNDS)
    base = base.replace(name="sweep", eval_every=SWEEP_ROUNDS,
                        fl=dataclasses.replace(
                            base.fl, sparse_rounds=SWEEP_ROUNDS + 1))
    return SweepSpec(name="sweep", base=base, axes=SWEEP_AXES,
                     group_by=tuple(SWEEP_AXES))


def sweep_worker_init(record_dir):
    """The process executor's initializer, run first in each spawned
    worker (bound to ``record_dir`` by ``functools.partial``): registers
    the cell's dataset, which a spawned worker does not see.  Then, on
    its own calls and before the run, it times the worker's CUDA context
    and the kernel library's load, and writes them to
    ``record_dir/worker-<pid>.json`` with when it started and the
    library's nvcc builds in the worker (0: it loads the parent's build;
    the run finds the library loaded)."""
    t_init = time.time()
    register_baseline_data()
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    build.library()
    t2 = time.perf_counter()
    with open(os.path.join(record_dir, f"worker-{os.getpid()}.json"),
              "w") as f:
        json.dump({"pid": os.getpid(), "t_init": t_init,
                   "cuda_context_s": t1 - t0, "library_load_s": t2 - t1,
                   "nvcc_builds": build.builds}, f)


def sweep_want(man, sparse_rounds, evals=True):
    """The launches of every run of a sweep manifest, summed, as
    :func:`want_launches` reckons them from each run's history and its
    clients (the vectorized engine), plus the eval hook's forwards
    (EVAL_STEPS U-Net forwards an eval) where ``evals``."""
    from types import SimpleNamespace
    from repro_torch.experiment.data import make_clients
    from repro_torch.experiment.registry import method_entry
    from repro_torch.experiment.spec import ExperimentSpec
    from repro_torch.fl.record import RoundRecord

    total = {}
    for entry in man["runs"].values():
        spec = ExperimentSpec.from_dict(entry["spec"])
        run = {"hist": [RoundRecord.from_dict(h) for h in entry["history"]],
               "tr": SimpleNamespace(clients=make_clients(spec)[0])}
        want = want_launches(
            run, "vectorized",
            method_entry(spec.method).topology == "hierarchical",
            sparse_rounds)
        n_evals = sum(h.eval is not None for h in run["hist"]) if evals \
            else 0
        want["block_masked_matmul"] += n_evals * EVAL_STEPS * U_NET_GEMMS[0]
        want["flash_attention"] += n_evals * EVAL_STEPS * U_NET_ATTENTION
        for k, v in want.items():
            total[k] = total.get(k, 0) + v
    return total


def sweep_phase(dev, counters, zero_counters, out_dir):
    """Sweeps on the card (``sweep``): :func:`sweep_grid`'s 4 runs
    through each executor, in temporary sweep directories (a checkpoint
    is ~0.4 GB; the manifests and reports are copied to ``out_dir``),
    each attempt checkpointing once, at its end (``save_every`` 0; the
    preempted attempt's end is round SWEEP_PREEMPT_AFTER):

    1. the runner's CLI (``--sweep --device cuda``, sequential, the eval
       hook live) killed after SWEEP_KILL_AFTER runs by ``--max-runs``,
       then the same command again, which resumes;
    2. the same CLI command unbroken in a fresh ``--out``;
    3. the k8s executor on a ``FakeCluster`` that preempts the first run
       after SWEEP_PREEMPT_AFTER rounds, with one retry;
    4. the process executor, one spawned worker, on two grid points.

    Checks: the resumed sweep's histories equal the unbroken one's
    bitwise (every key, evals included) and no run ran twice; the k8s
    and process histories equal the unbroken one's bitwise but for the
    eval (neither executor takes the hook), the preempted run retried
    once, and the k8s launches equal the grid's once (its retry trained
    from its checkpoint); the unbroken sweep's ``report.json`` has 4
    groups of n = 1 with the loss, bytes, params, wall and
    ``eval.is_proxy``; each int8 run's uplink is its none run's times
    (n + 4 L) / 4 n per upload, its downloads identical; the launches
    of sweeps 1 and 2 (counters set to 0 before each, read after) equal
    :func:`sweep_want`'s; the process worker built no kernel (nvcc 0).
    Reported: each run's wall and images/s, each sweep's wall beside the
    sum of its runs' (the executor's own overhead), the worker's
    start-up (spawn and imports to its initializer, the CUDA context,
    the library load).  Returns the unbroken sweep's tally."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.experiment import runner
    from repro_torch.experiment.cluster import FakeCluster, K8sExecutor
    from repro_torch.experiment.data import make_clients
    from repro_torch.experiment.spec import ExperimentSpec
    from repro_torch.experiment.sweep import (ProcessExecutor,
                                              manifest_status, run_sweep)
    from repro_torch.fl.comm import CommModel
    from repro_torch.models.unet import init_unet
    from repro_torch.tree import tree_leaves

    register_baseline_data()
    grid = sweep_grid()
    ids = [r.run_id for r in grid.expand()]
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    leaves = tree_leaves(init_unet(get_config(grid.base.model), gen,
                                   device=dev))
    n, L = sum(p.numel() for p in leaves), len(leaves)
    del leaves

    def strip(man):          # the histories without the evals
        return {rid: [{k: v for k, v in h.items() if k != "eval"}
                      for h in e["history"]]
                for rid, e in man["runs"].items()}

    def launches():
        return dict({k: fn.launches for k, fn in counters.items()},
                    group_l2_norms_bwd=counters["group_l2_norms"]
                    .bwd_launches)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grid.json")
        with open(path, "w") as f:
            f.write(grid.to_json())
        dirs = {k: os.path.join(tmp, k)
                for k in ("resumed", "unbroken", "k8s", "process")}
        cli = ["--sweep", path, "--device", dev.type, "--save-every", "0"]
        walls, counts, tallies, mans = {}, {}, {}, {}
        # 1-2: the CLI, killed and resumed; then unbroken
        for name, argvs in (("resumed", (["--max-runs",
                                          str(SWEEP_KILL_AFTER)], [])),
                            ("unbroken", ([],))):
            torch.cuda.synchronize()
            zero_counters()
            t0 = time.perf_counter()
            parts = [runner.main(cli + ["--out", dirs[name], *a])
                     for a in argvs]
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            counts[name] = launches()
            tallies[name] = tally_of(counters)
            mans[name] = parts[-1].manifest
            if name == "resumed":
                killed = manifest_status(parts[0].manifest)
        resumed, whole = mans["resumed"], mans["unbroken"]
        with open(os.path.join(dirs["unbroken"], "report.json")) as f:
            report = json.load(f)
        # 3: k8s on the fake cluster, the first run preempted once
        fake = FakeCluster(preempt_once={ids[0]: SWEEP_PREEMPT_AFTER})
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        k8s = run_sweep(grid, dirs["k8s"], executor=K8sExecutor(
            cluster=fake, poll_s=0.0), max_retries=1, backoff_s=0.0,
            save_every=0, raise_on_error=True, device=dev.type).manifest
        torch.cuda.synchronize()
        walls["k8s"] = time.perf_counter() - t0
        counts["k8s"] = launches()
        # 4: one spawned worker a run; the parent's cache returned first
        torch.cuda.empty_cache()
        parent_reserved = torch.cuda.memory_reserved(dev)
        records = os.path.join(tmp, "workers")
        os.makedirs(records)
        t0 = time.perf_counter()
        proc = run_sweep(grid.replace(exclude=SWEEP_PROCESS_EXCLUDE),
                         dirs["process"], executor=ProcessExecutor(
                             max_workers=1, initializer=functools.partial(
                                 sweep_worker_init, records)),
                         save_every=0, raise_on_error=True,
                         device=dev.type).manifest
        walls["process"] = time.perf_counter() - t0
        recs = []
        for fname in os.listdir(records):
            with open(os.path.join(records, fname)) as f:
                recs.append(json.load(f))
        # one worker at a time: a run's worker is the one whose
        # initializer ran between its launch (its last sweep/queue
        # span's end) and its attempt's end
        workers = {}
        for rid, e in proc["runs"].items():
            launched = max(s["t1"] for s in e["trace"]
                           if s["name"] == "sweep/queue")
            ended = max(s["t1"] for s in e["trace"]
                        if s["name"] == "sweep/attempt")
            [rec] = [r for r in recs if launched <= r["t_init"] <= ended]
            rec["spawn_import_s"] = rec["t_init"] - launched
            rec["startup_s"] = rec["spawn_import_s"] \
                + rec["cuda_context_s"] + rec["library_load_s"]
            workers[rid] = rec
        for name, d in dirs.items():
            os.makedirs(os.path.join(out_dir, name), exist_ok=True)
            for fname in ("sweep.json", "report.json", "report.md"):
                if os.path.exists(os.path.join(d, fname)):
                    shutil.copy(os.path.join(d, fname),
                                os.path.join(out_dir, name, fname))

    # each run's images and seconds (the unbroken sweep)
    for rid in ids:
        e = whole["runs"][rid]
        clients = make_clients(ExperimentSpec.from_dict(e["spec"]))[0]
        images = TRAIN_BATCH * sum(clients[c].data.steps_per_epoch
                                   for h in e["history"]
                                   for c in h["selected"])
        emit("sweep_run", run_id=rid, wall_s=e["wall_s"], images=images,
             images_per_s=images / e["wall_s"],
             loss=[h["loss"] for h in e["history"]],
             comm_gb=[h["comm_gb"] for h in e["history"]],
             is_proxy=e["history"][-1]["eval"]
             and e["history"][-1]["eval"].get("is_proxy"))

    # the int8 uplink against the none run's, upload for upload
    comm = CommModel()
    ratios, bytes_ok = {}, True
    for method in SWEEP_AXES["method"]:
        cost = comm.client_edge if method == "fedphd" else comm.edge_cloud
        full, quant = cost(4 * n), cost(n + 4 * L)
        hn = whole["runs"][f"comm.quant=none,method={method}"]["history"]
        hq = whole["runs"][f"comm.quant=int8,method={method}"]["history"]
        for a, b in zip(hn, hq, strict=True):
            k = len(b["selected"])
            want_up = a["comm_up_gb"] + k * (quant - full) / 1e9
            bytes_ok &= a["selected"] == b["selected"] \
                and a["comm_down_gb"] == b["comm_down_gb"] \
                and abs(b["comm_up_gb"] - want_up) <= 1e-9 * want_up
            other = a["comm_up_gb"] - k * full / 1e9
            ratios.setdefault(method, []).append(
                (b["comm_up_gb"] - other) / (a["comm_up_gb"] - other))

    want = sweep_want(whole, SWEEP_ROUNDS + 1)
    want_k8s = sweep_want(whole, SWEEP_ROUNDS + 1, evals=False)
    pre = k8s["runs"][ids[0]]
    outcomes = [s["attrs"]["outcome"] for s in pre["trace"]
                if s["name"] == "sweep/attempt"]
    groups = report["groups"]
    hist = lambda m: {r: e["history"] for r, e in m["runs"].items()}
    metric_keys = ("loss", "comm_gb", "params_m", "wall_s", "eval.is_proxy")
    run_walls = {name: sum(e["wall_s"] for e in m["runs"].values())
                 for name, m in (("unbroken", whole), ("k8s", k8s),
                                 ("process", proc))}
    emit("sweep", runs=len(ids), rounds=SWEEP_ROUNDS, run_ids=ids,
         killed_after=killed, wall_s=walls, runs_wall_s=run_walls,
         overhead_s={k: walls[k] - v for k, v in run_walls.items()},
         launches=counts, launches_want=want, launches_want_k8s=want_k8s,
         uplink_ratio=(n + 4 * L) / (4 * n), uplink_ratio_measured=ratios,
         report_groups=[(g["key"], g["n"], sorted(g["metrics"]))
                        for g in groups],
         preempted=fake.preempted, preempted_attempts=outcomes,
         resumed_equal=hist(resumed) == hist(whole),
         k8s_equal=strip(k8s) == strip(whole),
         process_equal=strip(proc) == {r: strip(whole)[r]
                                       for r in proc["runs"]},
         parent_reserved_bytes=parent_reserved)
    emit("sweep_process", runs=list(proc["runs"]), wall_s=walls["process"],
         run_wall_s={r: e["wall_s"] for r, e in proc["runs"].items()},
         **{k: {r: w[k] for r, w in workers.items()}
            for k in ("startup_s", "spawn_import_s", "cuda_context_s",
                      "library_load_s", "nvcc_builds")})

    require(killed["done"] == SWEEP_KILL_AFTER and all(
        e["status"] == "done" for m in (resumed, whole, k8s, proc)
        for e in m["runs"].values()),
        f"sweep: killed at {killed}, or a sweep is not complete")
    require(all(e["attempts"] == 1 for m in (resumed, whole)
                for e in m["runs"].values()),
            "sweep: a sequential run ran twice")
    require(hist(resumed) == hist(whole),
            "sweep: the resumed sweep's histories differ from the "
            "unbroken sweep's")
    require(all(h["eval"] is not None and np.isfinite(h["eval"]["is_proxy"])
                for e in whole["runs"].values() for h in e["history"][-1:]),
            "sweep: an is_proxy eval is missing or not finite")
    require(strip(k8s) == strip(whole),
            "sweep: the k8s executor's histories differ from the "
            "sequential one's")
    require(fake.preempted == [ids[0]] and outcomes == ["preempted", "done"]
            and pre["attempts"] == 2,
            f"sweep: preempted {fake.preempted}, attempts {outcomes}")
    require(counts["k8s"] == want_k8s,
            f"sweep: k8s launches {counts['k8s']}, want {want_k8s} (the "
            f"preempted run's retry must resume, not retrain round 1)")
    require(strip(proc) == {r: strip(whole)[r] for r in proc["runs"]}
            and len(proc["runs"]) == 2,
            "sweep: the process worker's histories differ from the "
            "sequential one's")
    require(all(w["nvcc_builds"] == 0 for w in workers.values()),
            f"sweep: the process worker ran nvcc: {workers}")
    require(len(groups) == 4 and all(g["n"] == 1 for g in groups)
            and all(set(metric_keys) <= set(g["metrics"]) for g in groups),
            f"sweep: report groups {[(g['key'], g['n']) for g in groups]}")
    require(bytes_ok, f"sweep: the int8 runs' bytes are not the none runs' "
                      f"at the uplink ratio: {ratios}")
    require(counts["resumed"] == want and counts["unbroken"] == want,
            f"sweep: launches {counts['resumed']} and "
            f"{counts['unbroken']}, want {want}")
    return tallies["unbroken"]


PROFILE_CATEGORIES = (("block_masked_matmul", ("bmm_kernel",
                                                "splitk_sum_kernel")),
                      ("flash_attention", ("flash_simt_kernel",
                                           "flash_tc_kernel")),
                      ("group_l2_norms", ("group_l2_partials",
                                          "group_l2_sums", "group_l2_bwd")),
                      ("rglru_scan", ("rglru_scan_tma", "rglru_scan_kernel")),
                      ("rglru_scan_bwd", ("rglru_scan_bwd",)),
                      ("wkv6", ("wkv_fwd",)),
                      ("wkv6_bwd", ("wkv_bwd",)),
                      ("library_gemm", ("gemm", "gemv", "nvjet")),
                      ("elementwise", ("elementwise",)),
                      ("reduce", ("reduce_kernel",)),
                      ("index_scatter", ("index", "scatter", "gather")))


def profiled(fn, out_path):
    """Run ``fn`` once under ``torch.profiler``; returns its device time
    by category and by kernel name, and the device's busy share of the
    run (the union of kernel intervals over the run's wall time).  The
    profiler's own host cost inflates the wall time, so the idle share
    is an upper bound.  The profiler's table goes to ``out_path``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    with open(out_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    require(kernels, "profile: the profiler recorded no device kernel")
    return dict(wall_s=wall, device_kernels=len(kernels),
                device_busy_s=busy_us / 1e6,
                device_idle_share=1.0 - busy_us / 1e6 / wall,
                device_ms_by_category={c: {"launches": n, "ms": t / 1e3}
                                       for c, (n, t) in by_cat.items()},
                top_kernels=[{"name": k[:80], "launches": n, "ms": t / 1e3}
                             for k, (n, t) in top])


def profile_phase(cfg, dev, out_dir):
    """``--profile``: one more training run on each engine under
    ``torch.profiler`` (:func:`profiled`): kernels a step are per client
    step on the sequential engine, per batched step (all the clients) on
    the vectorized one."""
    for engine in TRAIN_ENGINES:
        trainer = make_trainer(cfg, dev, engine)
        summary = profiled(trainer.run, os.path.join(
            out_dir, f"train_{engine}_profile.txt"))
        steps = len(trainer.step_seconds) if engine == "sequential" else \
            3 * max(c.data.steps_per_epoch for c in trainer.clients)
        emit("profile", run=f"train {engine}, profiled", steps=steps,
             device_kernels_per_step=summary["device_kernels"] / steps,
             **summary)


def lm_profile_phase(cfg, params, dev, out_dir, name="lm"):
    """``--profile``: one more prefill as in lm_prefill (moe_prefill for
    ``name`` "moe", dense_prefill for "dense"), and LM_PROFILE_STEPS decode steps at 8 slots
    against a fresh cache of cache_len 4096, written in place as
    ``serve_requests`` writes it, each under ``torch.profiler``
    (:func:`profiled`)."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import model

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ))).to(dev)
    prefill = build_prefill_step(cfg)
    emit("profile", run=f"{name}_prefill, profiled", batch=LM_BATCH,
         seq=LM_SEQ, **profiled(lambda: prefill(params, {"tokens": toks}),
                                os.path.join(out_dir,
                                             f"{name}_prefill_profile.txt")))
    slots = LM_SERVE["slots"]
    state = {"cache": model.init_cache(params, cfg, slots,
                                       LM_SERVE["cache_len"]),
             "toks": toks[:, :1].repeat(slots // LM_BATCH, 1).to(
                 torch.int32)}

    def steps():
        for _ in range(LM_PROFILE_STEPS):
            with torch.no_grad():           # serve_requests' step
                state["toks"] = model.decode_(
                    params, state["cache"], cfg, state["toks"]).argmax(
                    dim=-1).to(torch.int32)
            state["toks"].cpu()          # the serving loop's host sync
    steps()                              # the first step's one-off costs
    emit("profile", run=f"{name}_serve decode steps, profiled",
         slots=slots, steps=LM_PROFILE_STEPS,
         **profiled(steps, os.path.join(out_dir,
                                        f"{name}_decode_profile.txt")))


# ---------------------------------------------------------------------------
# phase 10: one loss and gradient, kernels against plain versions
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


def grad_stacked_phase(cfg, rparams, gen, dev, counters):
    """One stacked loss and gradient of GRAD_CLIENTS clients (batch
    GRAD_BATCH each, injected t and eps), as a vectorized step takes it:
    every GEMM one client-axis matmul launch, Omega one client-axis
    group-L2 launch.  Held against each client's own loss and gradient
    through the kernels' one-client launches: losses within FORWARD_TOL,
    each gradient within GRAD_TOL of the largest of any client's leaf."""
    import torch
    from repro_torch.configs import FLConfig
    from repro_torch.core.pruning import depth_lambdas, omega, unet_groups
    from repro_torch.diffusion import ddpm_loss, linear_schedule
    from repro_torch.fl.client import make_loss_fn
    from repro_torch.fl.engine import stack_trees
    from repro_torch.models.unet import apply_unet
    from repro_torch.tree import tree_leaves, tree_map

    C, B = GRAD_CLIENTS, GRAD_BATCH
    img = (C * B, cfg.image_size, cfg.image_size, cfg.in_channels)
    x0 = torch.rand(img, generator=gen, device=dev) * 2 - 1
    t = torch.randint(0, cfg.diffusion_steps, (C * B,), generator=gen,
                      device=dev)
    eps = torch.randn(img, generator=gen, device=dev)
    singles = [rparams] + [randomize(rparams, gen) for _ in range(C - 1)]
    stacked = stack_trees(singles)
    groups = unet_groups(cfg, rparams)
    fl = FLConfig()
    sched = linear_schedule(cfg.diffusion_steps, device=dev)
    for label, sparse in (("stacked dense + omega", True),
                          ("stacked dense", False)):
        loss_fn = make_loss_fn(cfg, fl, sparse=sparse, groups=groups)
        before = {k: (fn.launches, dict(fn.shapes))
                  for k, fn in counters.items()}
        p = tree_map(lambda v: v.detach().requires_grad_(), stacked)
        losses = loss_fn(p, {"images": x0}, None, clients=C, t=t, eps=eps)
        grads = torch.autograd.grad(losses.sum(), tree_leaves(p))
        torch.cuda.synchronize()
        ran = {k: fn.launches - before[k][0] for k, fn in counters.items()}
        keys = {k: {key for key, n in fn.shapes.items()
                    if n > before[k][1].get(key, 0)}
                for k, fn in counters.items()}
        lam = depth_lambdas(groups, fl.lambda0)
        want_l, want_g = [], []
        for c in range(C):
            q = tree_map(lambda v: v.detach().requires_grad_(), singles[c])
            sl = slice(c * B, (c + 1) * B)
            loss = ddpm_loss(lambda x, tt: apply_unet(q, cfg, x, tt), sched,
                             x0[sl], t=t[sl], eps=eps[sl])
            if sparse:
                loss = loss + omega(q, groups, lam)
            want_g.append(torch.autograd.grad(loss, tree_leaves(q)))
            want_l.append(float(loss.detach()))
        scale = max(float(g.abs().max()) for gs in want_g for g in gs)
        err = max(float((a[c] - gs[i]).abs().max())
                  for c, gs in enumerate(want_g) for i, a in enumerate(grads))
        losses = losses.detach()
        loss_err = max(abs(float(losses[c]) - want_l[c]) / abs(want_l[c])
                       for c in range(C))
        emit("grad", model=label, clients=C, batch=B,
             losses=losses.tolist(), losses_per_client=want_l,
             loss_rel_err=loss_err, max_abs_grad=scale,
             max_abs_grad_err=err, tol=GRAD_TOL * scale,
             kernel_launches=ran)
        mm_c = {k[5] if len(k) > 5 else None
                for k in keys["block_masked_matmul"]}
        require(ran["block_masked_matmul"] > 0 and mm_c <= {C}
                and ran["flash_attention"] > 0
                and ran["group_l2_norms"] == int(sparse),
                f"grad {label}: launches {ran}, matmul clients {mm_c}")
        require(loss_err <= FORWARD_TOL,
                f"grad {label}: losses {losses.tolist()} vs {want_l}")
        require(err <= GRAD_TOL * scale and scale > 0,
                f"grad {label}: gradient err {err} > {GRAD_TOL} x {scale}")


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
    ptxas = ptxas_summary(build.build_log or "")
    if build.build_log:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write(build.build_log)
    emit("build", seconds=time.perf_counter() - t0,
         compiled=build.build_seconds is not None, library=str(lib_path),
         kernels=len(ptxas),
         spilling=[k for k in ptxas if k["spill_stores"]],
         max_registers=max((k["registers"] for k in ptxas), default=None))

    from repro_torch import checkpoint
    from repro_torch.configs import CIFAR10_UNET
    from repro_torch.configs.base import config_to_dict
    from repro_torch.kernels.block_masked_matmul import ops as bmm
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.group_l2_norms import ops as gl2
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.kernels.wkv6 import ops as wkv
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
                "group_l2_norms": gl2.group_l2_norms,
                "rglru_scan": scan.rglru_scan, "wkv6": wkv.wkv6}

    def zero_counters():
        for fn in counters.values():
            fn.launches = 0
            fn.shapes.clear()
        bmm.block_masked_matmul.dx_shapes.clear()
        for fn in (gl2.group_l2_norms, scan.rglru_scan, wkv.wkv6):
            fn.bwd_launches = 0
            fn.bwd_shapes.clear()

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
            # the pruned run scores every group in one launch
            require(launches["group_l2_norms"] == (1 if extra else 0),
                    f"{name}: {launches['group_l2_norms']} group-L2 "
                    f"launches, want {1 if extra else 0}")

    # -- 4. the U-Net kernels' main path: training ---------------------------
    train_tallies, train_runs = train_phase(cfg, dev, counters,
                                            zero_counters)
    tallies.update(train_tallies)
    tallies["train_bf16"] = train_bf16_phase(
        cfg, dev, counters, zero_counters, train_runs["vectorized"][0])
    # -- 4a. the same cell on a one-rank NCCL mesh, and a MOON round ----
    tallies["mesh"] = mesh_phase(cfg, dev, counters, zero_counters,
                                 train_runs["vectorized"][0])

    # -- 5-7. RecurrentGemma serving: full model, then depth 5 in fp32 -------
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm_model
    lm_cfg = get_config(LM_ARCH)
    lm_gen = torch.Generator(dev)
    lm_gen.manual_seed(0)
    lm_params = lm_model.init(lm_cfg, lm_gen, device=dev)
    tallies["lm_prefill"], lm_dense_s = lm_prefill_phase(
        lm_cfg, lm_params, dev, counters, zero_counters)
    tallies["lm_serve"] = lm_serve_phase(lm_cfg, lm_params, dev, counters,
                                         zero_counters)
    # -- 6b. LM pruning: score, mask and compact the full model, prefill
    tallies["lm_prune"] = lm_prune_phase(lm_cfg, lm_params, dev, counters,
                                         zero_counters, lm_dense_s)
    if profile:
        os.makedirs(out_dir, exist_ok=True)
        lm_profile_phase(lm_cfg, lm_params, dev, out_dir)
    del lm_params
    torch.cuda.empty_cache()
    tallies["lm_consistency"] = lm_consistency_phase(
        lm_cfg.replace(num_layers=LM_DEPTH, dtype="float32",
                       param_dtype="float32"), dev, counters, zero_counters)
    torch.cuda.empty_cache()

    # -- 7h-7i. RecurrentGemma training: the step at full width, the CLI,
    # and a full-width fp32 gradient against the plain versions ----------
    tallies["lm_train"] = lm_train_phase(dev, counters, zero_counters,
                                         out_dir, profile=profile)
    lm_grad_phase(dev, counters)

    # -- 7j-7m. the MoE and MLA decoders: moonshot at full depth, prefill
    # and serving; each config's prefill against decode; moonshot training
    tallies.update(moe_phases(dev, counters, zero_counters,
                              profile_dir=out_dir if profile else None))

    # -- 7n-7q. the dense extras: command-r at full depth, prefill and
    # serving; each config's prefill against decode; gemma2 training ----
    tallies.update(dense_phases(dev, counters, zero_counters,
                                profile_dir=out_dir if profile else None))

    # -- 7r-7u. RWKV-6: rwkv6-7b at full depth, prefill and serving; its
    # prefill against decode at depth 4 on both routes; its train step --
    tallies.update(rwkv_phases(dev, counters, zero_counters,
                               profile_dir=out_dir if profile else None))

    # -- 4b. the experiment API: the paper preset, run and resumed ---------
    tallies["experiment"] = experiment_phase(dev, counters, zero_counters)

    # -- 7c. the flat baselines on both engines, resumed; centralized ------
    tallies["baselines"] = baselines_phase(dev, counters, zero_counters)
    centralized_phase(dev)

    # -- 7d-7e. faults and the quantized uplink on both trainers ---------
    tallies["faults"] = faults_phase(dev, counters, zero_counters)
    tallies["quant"] = quant_phase(dev, counters, zero_counters)

    # -- 7g. sweeps: the CLI killed and resumed, fake k8s, a process ----
    tallies["sweep"] = sweep_phase(dev, counters, zero_counters,
                                   os.path.join(out_dir, "sweep"))
    require(all(sum(tallies[MAIN_PATHS[k]][k].values()) > 0
                for k in counters),
            f"a kernel was not launched on its main path: "
            f"{ {k: tallies[MAIN_PATHS[k]][k] for k in counters} }")

    # -- 8. kernels vs plain, at the shapes the runs launched ----------------
    def launched(kernel, paths=PATHS):
        keys = set()
        for p in paths:
            keys |= set(tallies[p][kernel])
        return sorted(keys)

    os.makedirs(out_dir, exist_ok=True)
    case_log = open(os.path.join(out_dir, "kernel_cases.jsonl"), "w")
    rows = []

    def log(row):                 # one line per case, to the log only
        if row.get("key") is not None and row["kernel"] == "rglru_scan" \
                and row.get("role") == "bwd":
            row["launches"] = {"lm_train_bwd": tallies["lm_train"][
                "rglru_scan_bwd"].get(row["key"], 0)}
        elif row.get("key") is not None and row["kernel"] == "wkv6" \
                and row.get("role") == "bwd":
            row["launches"] = {"rwkv_train_bwd": tallies["rwkv_train"][
                "wkv6_bwd"].get(row["key"], 0)}
        elif row.get("key") is not None:
            row["launches"] = {p: tallies[p][row["kernel"]].get(row["key"], 0)
                               for p in PATHS}
            for p in BACKWARD_PATHS:
                if row["kernel"] == "block_masked_matmul":
                    row["launches"][f"{p}_dx"] = \
                        tallies[p]["block_masked_matmul_dx"].get(row["key"],
                                                                 0)
                if row["kernel"] == "group_l2_norms":
                    row["launches"][f"{p}_bwd"] = \
                        tallies[p]["group_l2_norms_bwd"].get(row["key"], 0)
        rows.append(row)
        if row["kernel"] == "group_l2_norms":   # the signature is the table
            row = {**row, "key": row["signature"] if row["key"] else None}
        case_log.write(json.dumps(row) + "\n")

    def other(dt):
        return "bfloat16" if dt == "float32" else "float32"

    try:
        dx_of = {p: tallies[p].get("block_masked_matmul_dx", {})
                 for p in PATHS}
        fwd_keys = [k for k in launched("block_masked_matmul")
                    if any(tallies[p]["block_masked_matmul"].get(k, 0)
                           > dx_of[p].get(k, 0) for p in PATHS)]
        dx_keys = sorted(set().union(*(dx_of[p] for p in BACKWARD_PATHS)))
        mm_keys = launched("block_masked_matmul")
        serve_mm = set(launched("block_masked_matmul", ("dense", "pruned")))
        largest = sorted(set(tallies["train"]["block_masked_matmul"])
                         - serve_mm, key=lambda k: -k[0] * k[1] * k[2])[:4]
        cases = []
        for key in fwd_keys:
            M, K, N, masked, dt, *c = key
            ratio = 0.44 if masked else None
            cases.append(((M, K, N), ratio, dt, key, "fwd",
                          c[0] if c else None))
            # serving shapes in the other dtype too; training shapes at
            # the largest few
            if key in serve_mm or key in largest:
                cases.append(((M, K, N), ratio, other(dt), None, "fwd",
                              None))
        for key in dx_keys:              # as the backward launches them
            M, K, N, masked, dt, *c = key
            cases.append(((M, K, N), 0.44 if masked else None, dt, key,
                          "dx", c[0] if c else None))
        # the client axis at the prune masks: the largest batched shape
        M, K, N, _, dt, c = max((k for k in mm_keys if len(k) > 5),
                                key=lambda k: k[0] * k[1] * k[2])
        cases += [((M, K, N), 0.44, dt, None, role, c)
                  for role in ("fwd", "dx")]
        for shape in [(8, 27, 3), (8192, 1152, 128), (2048, 2304, 256),
                      (512, 4608, 256), (1000, 999, 77)]:
            for dt in ("float32", "bfloat16"):
                for ratio in (0.0, 0.44, 0.9):
                    cases.append((shape, ratio, dt, None, "fwd", None))
        for dt in ("float32", "bfloat16"):   # ragged, unaligned, in place
            cases.append(((1000, 999, 77), 0.44, dt, None, "dx", None))
            cases.append(((1000, 999, 77), 0.44, dt, None, "dx", 3))
        mm_err = check_matmul(cases, gen, dev, log)
        emit("kernels", kernel="block_masked_matmul",
             launched_shapes=len(mm_keys),
             split_k_cases=sum(r.get("plan", {}).get("splits", 1) > 1
                               for r in rows),
             train_dx_shapes=len(dx_of["train"]),
             train_vectorized_dx_shapes=len(dx_of["train_vectorized"]),
             experiment_dx_shapes=len(dx_of["experiment"]),
             bitwise_per_client_cases=sum(
                 r.get("bitwise_per_client") is True for r in rows),
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
                          ((slots, 200, 200, 256), True, 48, dt, None),
                          # rows TMA cannot address (200 bytes), and rows
                          # it pads past hd (144 of 192)
                          ((slots, 256, 256, 100), False, 0, dt, None),
                          ((slots, 256, 256, 144), True, 0, dt, None),
                          # a ragged S, causal without and with a window
                          ((4, 1000, 1000, 256), True, 0, dt, None),
                          ((4, 1000, 1000, 256), True, 256, dt, None),
                          ((slots, 16, 16, 256), True, 0, dt, None)]
        att_err = check_attention(att_cases, gen, dev, log)
        emit("kernels", kernel="flash_attention",
             launched_shapes=len(att_keys), cases=len(att_cases),
             max_abs_err=att_err, tol_rel=TOL)

        l2_keys = launched("group_l2_norms")
        l2_err = check_group_l2(l2_keys, gen, dev, log)
        emit("kernels", kernel="group_l2_norms",
             launched_signatures=[signature_name(k) for k in l2_keys],
             max_abs_err=l2_err, tol_rel=TOL["float32"])

        scan_keys = launched("rglru_scan")
        scan_cases = []
        for key in scan_keys:
            B, S, W, dt = key
            scan_cases += [((B, S, W), (0.0, 1.0), dt, key),
                           ((B, S, W), (0.0, 1.0), other(dt), None)]
        for dt in ("float32", "bfloat16"):
            scan_cases += [((3, 1000, 300), (0.0, 1.0), dt, None),
                           ((LM_BATCH, LM_SEQ, 512), (0.999, 1.0), dt,
                            None)]
        scan_err = check_scan(scan_cases, gen, dev, log)
        emit("kernels", kernel="rglru_scan", launched_shapes=len(scan_keys),
             cases=len(scan_cases), max_abs_err=scan_err, tol_rel=TOL)
        bwd_keys = launched("rglru_scan_bwd", ("lm_train",))
        bwd_cases = [((B, S, W), (0.0, 1.0), dt, key)
                     for key in bwd_keys for B, S, W, dt in (key,)]
        for dt in ("float32", "bfloat16"):
            bwd_cases += [((3, 1000, 999), (0.0, 1.0), dt, None),
                          ((1, LM_TRAIN_SEQ, 512), (0.999, 1.0), dt, None)]
        check_scan_backward(bwd_cases, gen, dev, log)
        emit("kernels", kernel="rglru_scan_backward",
             launched_shapes=len(bwd_keys), cases=len(bwd_cases),
             bitwise_equal=True)

        wkv_keys = launched("wkv6")
        wkv_cases = [((B, S, H, K), "init", key)
                     for key in wkv_keys for B, S, H, K, _ in (key,)]
        wkv_cases += [((3, 1000, 5, 32), "fast", None),
                      ((2, 1000, 3, 64), "underflow", None)]
        wkv_err, wkv_rel = check_wkv(wkv_cases, gen, dev, log)
        emit("kernels", kernel="wkv6", launched_shapes=len(wkv_keys),
             cases=len(wkv_cases), max_abs_err=wkv_err, max_rel_err=wkv_rel,
             tol_rel=WKV_TOL)
        wkv_bwd_keys = launched("wkv6_bwd", ("rwkv_train",))
        wkv_bwd_cases = [((B, S, H, K), "init", key)
                         for key in wkv_bwd_keys for B, S, H, K, _ in (key,)]
        wkv_bwd_cases += [((3, 1000, 5, 32), "fast", None),
                          ((2, 1000, 3, 64), "underflow", None)]
        wkv_bwd_err, wkv_bwd_rel = check_wkv_backward(wkv_bwd_cases, gen,
                                                      dev, log)
        emit("kernels", kernel="wkv6_backward",
             launched_shapes=len(wkv_bwd_keys), cases=len(wkv_bwd_cases),
             max_abs_err=wkv_bwd_err, max_rel_err=wkv_bwd_rel,
             tol_rel=WKV_TOL)
    finally:
        case_log.close()

    # -- 4 (continued). the engines' timing runs, after the kernels' times -
    train_timing_phase(cfg, dev, counters, zero_counters, train_runs)
    del train_runs
    engine_memory_phase(cfg, rparams, gen, dev)
    baselines_memory_phase(dev)
    quant_memory_phase(dev)

    # -- 7f. the obs layer: traced, pipelined and stepped runs -------------
    obs_phase(cfg, dev, out_dir)

    # -- 9. full-width forward: kernels vs plain versions --------------------
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

    # -- 10. one loss and gradient: kernels vs plain versions ----------------
    grad_phase(cfg, rparams, gen, dev, counters)
    grad_stacked_phase(cfg, rparams, gen, dev, counters)
    if profile:
        profile_phase(cfg, dev, out_dir)

    kernels = []
    errs = {"block_masked_matmul": mm_err["float32"],
            "flash_attention": att_err["float32"],
            "group_l2_norms": l2_err,
            "rglru_scan": scan_err["float32"], "wkv6": wkv_err}
    for name, err in errs.items():
        paths = {p: path_totals(rows, tallies[p][name]) for p in PATHS
                 if not (p in BACKWARD_PATHS
                         and name == "block_masked_matmul")}
        extra = {}
        for p in BACKWARD_PATHS:
            if name == "block_masked_matmul":
                dx = tallies[p]["block_masked_matmul_dx"]
                fwd = {k: n - dx.get(k, 0)
                       for k, n in tallies[p][name].items()}
                f = path_totals(rows, {k: n for k, n in fwd.items() if n})
                d = path_totals(rows, dx, role="dx")
                paths[p] = {**add_totals(f, d), "fwd": f, "dx": d}
            if name == "group_l2_norms":
                extra["backward" if p == "train" else f"backward_{p}"] = \
                    path_totals(rows, tallies[p]["group_l2_norms_bwd"],
                                role="bwd")
        if name == "rglru_scan":
            extra["backward"] = {
                **path_totals(rows, tallies["lm_train"]["rglru_scan_bwd"],
                              role="bwd"), "path": "lm_train"}
        main = paths[MAIN_PATHS[name]]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name],
                        "replaces": TPU_KERNELS[name],
                        "launches": main["launches"], "max_abs_err": err,
                        **{k: main[k] for k in TIMES},
                        "bound_by": main["bound_by"],
                        "bound_share": main["bound_share"],
                        "vs_library": main["vs_library"],
                        "main_path": MAIN_PATHS[name], "paths": paths,
                        **extra})
    # the WKV backward: its own kernels (source and entry), on rwkv_train
    bwd = path_totals(rows, tallies["rwkv_train"]["wkv6_bwd"], role="bwd")
    kernels.append({"name": "wkv6_backward", "route": "cuda",
                    "source": SOURCES["wkv6"],
                    "replaces": TPU_KERNELS["wkv6"],
                    "launches": bwd["launches"], "max_abs_err": wkv_bwd_err,
                    **{k: bwd[k] for k in TIMES},
                    "bound_by": bwd["bound_by"],
                    "bound_share": bwd["bound_share"],
                    "vs_library": bwd["vs_library"],
                    "main_path": "rwkv_train", "paths": {"rwkv_train": bwd}})
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
                    help="also run the training path, one LM prefill, "
                         "8 LM decode steps and one LM train step once "
                         "more under torch.profiler "
                         "(device time by kernel, idle share; the tables "
                         "go to DIR/*_profile.txt)")
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
