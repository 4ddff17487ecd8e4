#!/usr/bin/env python3
"""Runs single phases of ``chip_smoke.py`` on the card, for iterating on one.

  python3 tools/chip_phases.py [memory] [baselines] [centralized] [bf16]
                               [faults] [quant] [quantmem] [obs] [check]

Builds the kernels, then runs the named phases of ``chip_smoke.py`` in
the order given (default: all): ``memory`` is
``baselines_memory_phase``, ``baselines`` is ``baselines_phase`` (its
three line kinds), ``centralized`` is ``centralized_phase``, ``bf16``
one fp32 vectorized ``train_run`` and ``train_bf16_phase`` against it,
``faults`` is ``faults_phase``, ``quant`` is ``quant_phase``,
``quantmem`` is ``quant_memory_phase``, ``obs`` is ``obs_phase`` (its
traces in ``build/chip_phases/obs``), and ``check`` (last) holds
every matmul, attention and group-L2 shape the phases before it
launched against the plain versions (``check_matmul``,
``check_attention``, ``check_group_l2``).  A failed check is printed and
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

PHASES = ("memory", "baselines", "centralized", "bf16", "faults", "quant",
          "quantmem", "obs", "check")


def main(argv) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.block_masked_matmul import ops as bmm
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.group_l2_norms import ops as gl2
    from repro_torch.kernels.rglru_scan import ops as scan

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
                "rglru_scan": scan.rglru_scan}

    def zero():
        for fn in counters.values():
            fn.launches = 0
            fn.shapes.clear()
        bmm.block_masked_matmul.dx_shapes.clear()
        gl2.group_l2_norms.bwd_launches = 0
        gl2.group_l2_norms.bwd_shapes.clear()

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
            elif phase == "check" and tally:
                mm, dx = tally["block_masked_matmul"], \
                    tally["block_masked_matmul_dx"]
                fwd = [k for k in mm if mm[k] > dx.get(k, 0)]
                cases = [((k[0], k[1], k[2]), None, k[4], k, role,
                          k[5] if len(k) > 5 else None)
                         for role, keys in (("fwd", fwd), ("dx", list(dx)))
                         for k in keys]
                gen = torch.Generator(dev)
                gen.manual_seed(0)
                rows = []
                mm_err = cs.check_matmul(cases, gen, dev, rows.append)
                att = [((k[0], k[1], k[2], k[3]), k[4], k[5], k[6], k)
                       for k in tally["flash_attention"]]
                att_err = cs.check_attention(att, gen, dev, rows.append)
                l2_err = cs.check_group_l2(
                    sorted(tally.get("group_l2_norms", {})), gen, dev,
                    rows.append)
                print(json.dumps({"matmul_cases": len(cases),
                                  "matmul_err": mm_err,
                                  "attention_cases": len(att),
                                  "attention_err": att_err,
                                  "group_l2_err": l2_err}), flush=True)
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
