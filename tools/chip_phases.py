#!/usr/bin/env python3
"""Runs single phases of ``chip_smoke.py`` on the card, for iterating on one.

  python3 tools/chip_phases.py [memory] [baselines] [centralized] [bf16]
                               [mesh] [faults] [quant] [quantmem] [obs]
                               [sweep]
                               [lmtrain] [lmprofile] [lmgrad] [moe]
                               [moeprofile] [dense] [denseprofile] [rwkv]
                               [rwkvprofile] [prune] [check]

Builds the kernels, then runs the named phases of ``chip_smoke.py`` in
the order given (default: all): ``memory`` is
``baselines_memory_phase``, ``baselines`` is ``baselines_phase`` (its
three line kinds), ``centralized`` is ``centralized_phase``, ``bf16``
one fp32 vectorized ``train_run`` and ``train_bf16_phase`` against it,
``mesh`` one fp32 vectorized ``train_run`` and ``mesh_phase`` against
it (the cell on a one-rank NCCL mesh, and a MOON round),
``faults`` is ``faults_phase``, ``quant`` is ``quant_phase``,
``quantmem`` is ``quant_memory_phase``, ``obs`` is ``obs_phase`` (its
traces in ``build/chip_phases/obs``), ``sweep`` is ``sweep_phase`` (its
manifests and reports in ``build/chip_phases/sweep``), ``lmtrain`` is
``lm_train_phase`` (the CLI's checkpoint in
``build/chip_phases/lm_train``), ``lmprofile`` the same with one more
step under ``torch.profiler`` (its table in
``build/chip_phases/lm_train_profile.txt``), ``lmgrad`` is
``lm_grad_phase``, ``moe`` is ``moe_phases`` (moonshot's full-depth
prefill and serving, the three MoE/MLA configs' prefill against decode
at depth 4, moonshot's train step), ``moeprofile`` the same with one
more moonshot prefill and 8 decode steps under ``torch.profiler``
(tables in ``build/chip_phases/moe_*_profile.txt``), ``dense`` is
``dense_phases`` (command-r-35b's full-depth prefill and serving, the
five dense-extras configs' prefill against decode, gemma2-2b's
full-depth train step), ``denseprofile`` the same with one more
command-r prefill, 8 decode steps and one more gemma2 train step under
``torch.profiler`` (tables in ``build/chip_phases/dense_*_profile.txt``),
``rwkv`` is ``rwkv_phases`` (rwkv6-7b's full-depth prefill and serving,
its prefill against decode at depth 4 on the exact and the chunked
route, its train step at 8 layers), ``rwkvprofile`` the same with one
more prefill, 8 decode steps and one more train step under
``torch.profiler`` (tables in ``build/chip_phases/rwkv_*_profile.txt``),
``prune`` is LM pruning on recurrentgemma-9b (the full bf16 model's
``lm_prefill_phase`` for the dense median, then ``lm_prune_phase``:
score, mask, compact and prefill the pruned model; then
``lm_consistency_phase`` at depth 5 in fp32, whose pruning part holds
masks against compaction and Omega's kernel route against the plain
one), and ``check`` (last) holds every matmul, attention (in its dtype and the
other), group-L2, scan and WKV (forward and backward) shape the phases
before it launched against the plain versions (``check_matmul``,
``check_attention``, ``check_group_l2``, ``check_scan``,
``check_scan_backward``, ``check_wkv``, ``check_wkv_backward``).  A failed check is printed and
the run goes on to
the next phase, where ``chip_smoke.py`` stops; the last line lists the
failures, and the exit code is 1 if there was one.  Needs one CUDA card
and nvcc.
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("memory", "baselines", "centralized", "bf16", "mesh", "faults",
          "quant",
          "quantmem", "obs", "sweep", "lmtrain", "lmprofile", "lmgrad",
          "moe", "moeprofile", "dense", "denseprofile", "rwkv",
          "rwkvprofile", "prune", "check")


def main(argv) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.block_masked_matmul import ops as bmm
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.group_l2_norms import ops as gl2
    from repro_torch.kernels.rglru_scan import ops as scan
    from repro_torch.kernels.wkv6 import ops as wkv

    which = argv or list(PHASES)
    unknown = set(which) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; "
                         f"choose from {PHASES}")
    t00 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.library()
    print(json.dumps({"build_s": time.perf_counter() - t00}), flush=True)
    counters = {"block_masked_matmul": bmm.block_masked_matmul,
                "flash_attention": fa.flash_attention_bhsd,
                "group_l2_norms": gl2.group_l2_norms,
                "rglru_scan": scan.rglru_scan, "wkv6": wkv.wkv6}

    def zero():
        for fn in counters.values():
            fn.launches = 0
            fn.shapes.clear()
        bmm.block_masked_matmul.dx_shapes.clear()
        for fn in (gl2.group_l2_norms, scan.rglru_scan, wkv.wkv6):
            fn.bwd_launches = 0
            fn.bwd_shapes.clear()

    fails = []

    def record(cond, what):
        if not cond:
            fails.append(what)
            print(f"CHECK FAILED: {what}", flush=True)
    cs.require = record

    tally = {}
    for phase in which:
        t0 = time.perf_counter()
        try:
            if phase == "memory":
                cs.baselines_memory_phase(dev)
            elif phase == "baselines":
                cs.merge_tally(tally, cs.baselines_phase(dev, counters, zero))
            elif phase == "centralized":
                cs.centralized_phase(dev)
            elif phase == "bf16":
                from repro_torch.configs import CIFAR10_UNET
                fp32 = cs.train_run(CIFAR10_UNET, dev, "vectorized",
                                    counters, zero)
                cs.merge_tally(tally, cs.train_bf16_phase(
                    CIFAR10_UNET, dev, counters, zero, fp32))
            elif phase == "mesh":
                from repro_torch.configs import CIFAR10_UNET
                fp32 = cs.train_run(CIFAR10_UNET, dev, "vectorized",
                                    counters, zero)
                fp32["state"] = cs._host_state(fp32.pop("trainer"))
                cs.merge_tally(tally, cs.mesh_phase(
                    CIFAR10_UNET, dev, counters, zero, fp32))
            elif phase == "faults":
                cs.merge_tally(tally, cs.faults_phase(dev, counters, zero))
            elif phase == "quant":
                cs.merge_tally(tally, cs.quant_phase(dev, counters, zero))
            elif phase == "quantmem":
                cs.quant_memory_phase(dev)
            elif phase == "obs":
                from repro_torch.configs import CIFAR10_UNET
                cs.obs_phase(CIFAR10_UNET, dev,
                             os.path.join(ROOT, "build", "chip_phases", "obs"))
            elif phase == "sweep":
                cs.merge_tally(tally, cs.sweep_phase(
                    dev, counters, zero,
                    os.path.join(ROOT, "build", "chip_phases", "sweep")))
            elif phase in ("lmtrain", "lmprofile"):
                cs.merge_tally(tally, cs.lm_train_phase(
                    dev, counters, zero,
                    os.path.join(ROOT, "build", "chip_phases"),
                    profile=phase == "lmprofile"))
            elif phase == "lmgrad":
                cs.lm_grad_phase(dev, counters)
            elif phase in ("moe", "moeprofile", "dense", "denseprofile",
                           "rwkv", "rwkvprofile"):
                phases = {"moe": cs.moe_phases, "dense": cs.dense_phases,
                          "rwkv": cs.rwkv_phases}[
                    phase.removesuffix("profile")]
                for t in phases(
                        dev, counters, zero,
                        profile_dir=os.path.join(ROOT, "build", "chip_phases")
                        if phase.endswith("profile") else None).values():
                    cs.merge_tally(tally, t)
            elif phase == "prune":
                from repro_torch.configs import get_config
                from repro_torch.models import model
                cfg = get_config(cs.LM_ARCH)
                gen = torch.Generator(dev)
                gen.manual_seed(0)
                params = model.init(cfg, gen, device=dev)
                t, dense_s = cs.lm_prefill_phase(cfg, params, dev, counters,
                                                 zero)
                cs.merge_tally(tally, t)
                cs.merge_tally(tally, cs.lm_prune_phase(
                    cfg, params, dev, counters, zero, dense_s))
                del params
                torch.cuda.empty_cache()
                cs.merge_tally(tally, cs.lm_consistency_phase(
                    cfg.replace(num_layers=cs.LM_DEPTH, dtype="float32",
                                param_dtype="float32"), dev, counters, zero))
                torch.cuda.empty_cache()
            elif phase == "check" and tally:
                mm, dx = tally.get("block_masked_matmul", {}), \
                    tally.get("block_masked_matmul_dx", {})
                fwd = [k for k in mm if mm[k] > dx.get(k, 0)]
                cases = [((k[0], k[1], k[2]), None, k[4], k, role,
                          k[5] if len(k) > 5 else None)
                         for role, keys in (("fwd", fwd), ("dx", list(dx)))
                         for k in keys]
                gen = torch.Generator(dev)
                gen.manual_seed(0)
                rows = []
                mm_err = cs.check_matmul(cases, gen, dev, rows.append)
                att = [((k[0], k[1], k[2], k[3]), k[4], k[5], dt,
                        k if dt == k[6] else None)
                       for k in tally.get("flash_attention", {})
                       for dt in (k[6], "bfloat16" if k[6] == "float32"
                                  else "float32")]
                att_err = cs.check_attention(att, gen, dev, rows.append)
                l2_err = cs.check_group_l2(
                    sorted(tally.get("group_l2_norms", {})), gen, dev,
                    rows.append)
                scan_cases = [((B, S, W), (0.0, 1.0), dt, k) for k in
                              tally.get("rglru_scan", {})
                              for B, S, W, dt in (k,)]
                scan_err = cs.check_scan(scan_cases, gen, dev, rows.append)
                bwd = [((B, S, W), (0.0, 1.0), dt, k) for k in
                       tally.get("rglru_scan_bwd", {}) for B, S, W, dt in (k,)]
                if bwd:
                    for dt in ("float32", "bfloat16"):
                        bwd += [((3, 1000, 999), (0.0, 1.0), dt, None),
                                ((1, cs.LM_TRAIN_SEQ, 512), (0.999, 1.0),
                                 dt, None)]
                cs.check_scan_backward(bwd, gen, dev, rows.append)
                wkv_cases = [((B, S, H, K), "init", k) for k in
                             tally.get("wkv6", {}) for B, S, H, K, _ in (k,)]
                wkv_bwd = [((B, S, H, K), "init", k) for k in
                           tally.get("wkv6_bwd", {})
                           for B, S, H, K, _ in (k,)]
                if wkv_cases:
                    extra = [((3, 1000, 5, 32), "fast", None),
                             ((2, 1000, 3, 64), "underflow", None)]
                    wkv_cases += extra
                    wkv_bwd += extra
                wkv_err = cs.check_wkv(wkv_cases, gen, dev, rows.append)
                wkv_bwd_err = cs.check_wkv_backward(wkv_bwd, gen, dev,
                                                    rows.append)
                print(json.dumps({"matmul_cases": len(cases),
                                  "matmul_err": mm_err,
                                  "attention_cases": len(att),
                                  "attention_err": att_err,
                                  "group_l2_err": l2_err,
                                  "scan_cases": len(scan_cases),
                                  "scan_err": scan_err,
                                  "scan_backward_cases": len(bwd),
                                  "wkv_cases": len(wkv_cases),
                                  "wkv_err": wkv_err,
                                  "wkv_backward_cases": len(wkv_bwd),
                                  "wkv_backward_err": wkv_bwd_err}),
                      flush=True)
                os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
                with open(os.path.join(ROOT, "chiprun_out",
                                       "phase_cases.jsonl"), "w") as f:
                    for row in rows:
                        f.write(json.dumps(row, default=str) + "\n")
        except Exception as e:               # report it, run the next phase
            traceback.print_exc()
            fails.append(f"{phase}: {e!r}")
        print(json.dumps({"phase_s": {phase: time.perf_counter() - t0}}),
              flush=True)
    print(json.dumps({"failed": fails,
                      "seconds": time.perf_counter() - t00}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
