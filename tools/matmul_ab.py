#!/usr/bin/env python3
"""Times the block-masked matmul kernel of two source trees in one process.

  python3 tools/matmul_ab.py OTHER_ROOT [--rounds 6] [--iters 20]

Builds ``block_masked_matmul.cu`` of this checkout ("change") and of
OTHER_ROOT ("other": another checkout of the repo, e.g. a ``git archive``
of an earlier commit) into two shared libraries with the port's nvcc
flags, and times both on the same inputs, one client, at the fp32 shapes
where the training path spends most of the kernel's time (forward, and
the backward's dx reading w.T in place), under the plan this checkout's
``ops.plan`` picks.  Each round times the two in turns, the order
flipping every round, with ``torch.matmul`` on the same operands beside
them (CUDA events over ``--iters`` launches after a warm-up).  An
earlier source whose ``bmm_launch`` has no client argument is called
without it.  Both must give the same bits.  Prints one JSON line per
shape and a summary line; needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))

KERNEL = "src/repro_torch/kernels/block_masked_matmul/csrc/block_masked_matmul.cu"
# (M, K, N, trans_b): the training run's largest fp32 launches
SHAPES = [(32768, 2304, 128, False), (32768, 1152, 128, False),
          (32768, 3456, 128, False), (32768, 2304, 256, False),
          (8192, 4608, 256, False), (8192, 2304, 256, False),
          (8192, 4608, 144, False), (8192, 3456, 256, False),
          (32768, 256, 2304, True), (32768, 128, 1152, True)]


def build_lib(root: Path, out_dir: str, name: str):
    """Compile ``root``'s kernel into ``out_dir/name.so``; return the
    library and whether its entry point takes a client count."""
    from repro_torch.kernels import build
    src = root / KERNEL
    so = os.path.join(out_dir, f"{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", str(src),
                    "-o", so], check=True, capture_output=True)
    clients = re.search(r"bmm_launch\([^)]*int C,", src.read_text()) \
        is not None
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bmm_launch.argtypes = [P] * 6 + [I] * (11 if clients else 10) + [P]
    lib.bmm_launch.restype = I
    return lib, clients


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.block_masked_matmul.ops import plan
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    stream = build.stream_handle(dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"change": build_lib(HERE, tmp, "change"),
                "other": build_lib(args.other.resolve(), tmp, "other")}
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    summary = {"change": 0.0, "other": 0.0, "library": 0.0}
    for M, K, N, trans_b in SHAPES:
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((N, K) if trans_b else (K, N), generator=gen,
                        device=dev)
        p = plan(M, K, N)
        ws = None if p.splits == 1 else torch.empty(
            (p.splits, M, N), device=dev)
        vec = int(not trans_b and N % 4 == 0 and w.data_ptr() % 16 == 0)
        ys = {k: torch.empty((M, N), device=dev) for k in libs}

        def launch(name):
            lib, clients = libs[name]
            head = (x.data_ptr(), w.data_ptr(), None, None,
                    ys[name].data_ptr(),
                    None if ws is None else ws.data_ptr())
            dims = ((1,) if clients else ()) + (M, K, N)
            err = lib.bmm_launch(*head, *dims, 0, int(trans_b), p.bm, p.bn,
                                 p.splits, p.per, vec, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        fns = {k: (lambda k=k: launch(k)) for k in libs}
        wt = w.t() if trans_b else w
        fns["library"] = lambda: torch.matmul(x, wt)
        times = {k: [] for k in fns}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        for r in range(args.rounds):
            order = ("change", "other", "library") if r % 2 == 0 \
                else ("other", "change", "library")
            for k in order:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(args.iters):
                    fns[k]()
                b.record()
                b.synchronize()
                times[k].append(a.elapsed_time(b) / args.iters)
        med = {k: statistics.median(v) for k, v in times.items()}
        for k in summary:
            summary[k] += med[k]
        same = torch.equal(ys["change"], ys["other"])
        print(json.dumps({"shape": [M, K, N], "trans_b": trans_b,
                          "plan": p._asdict(), "ms_median": med,
                          "ms": times, "change_over_other":
                          med["change"] / med["other"],
                          "bitwise_equal": same}), flush=True)
        if not same:
            print(f"{M}x{K}x{N}: the two kernels disagree", file=sys.stderr)
            return 1
    print(json.dumps({"summary_ms": summary, "change_over_other":
                      summary["change"] / summary["other"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
