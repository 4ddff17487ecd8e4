"""CLI: serve sampling requests from a checkpoint on the port's kernels.

  PYTHONPATH=src python -m repro_torch.serve --ckpt out/ckpt --requests 16 \
      --slots 8 --steps 10 --prune-ratio 0.44 --out samples/

The flags are ``python -m repro.serve``'s, without ``--backend`` and
with ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  Prints requests/s, p50/p99 per-step latency, the host
caches' entries built (``compiles``) and the dense-vs-masked analytic
MACs; ``--metrics`` writes them as the shared JSON envelope.
``--trace [PATH]`` (or ``$FEDPHD_OBS=1``) records a ``serve/tick`` span
a tick, by default to ``<ckpt>.serve.trace.jsonl``, and adds the trace's
summary to the metrics.  Exits nonzero if fewer images than requested
were served.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.experiment.cli import (add_obs_flags, make_cli_tracer,
                                        write_metrics)
from repro_torch.experiment.resolve import PRECISIONS
from repro_torch.metrics.flops import unet_macs
from repro_torch.obs.metrics import summarize_trace
from repro_torch.serve.artifact import load_serving_artifact, masks_for_ratio
from repro_torch.serve.server import DiffusionServer, Request


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the metrics it reports."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--ckpt", required=True, help="checkpoint path")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10, help="DDIM steps")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="0 = deterministic DDIM; 1 ~ DDPM ancestral")
    ap.add_argument("--prune-ratio", type=float, default=0.0,
                    help="serve through masks at this ratio (0 = dense)")
    ap.add_argument("--criterion", default="l2", choices=("l2", "random"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for req<rid>.npy images")
    ap.add_argument("--precision", default=None, choices=PRECISIONS,
                    help="compute precision (default: $FEDPHD_PRECISION, "
                         "else fp32)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--metrics", default=None,
                    help="write the run's metrics as JSON to this path")
    add_obs_flags(ap)
    args = ap.parse_args(argv)

    params, cfg, _ = load_serving_artifact(args.ckpt, device=args.device)
    masks = None
    if args.prune_ratio > 0:
        masks = masks_for_ratio(params, cfg, args.prune_ratio,
                                criterion=args.criterion)
    dense_macs = unet_macs(params, cfg.image_size)
    macs = unet_macs(params, cfg.image_size, masks=masks)
    # --trace > $FEDPHD_OBS > off; by default next to the checkpoint
    tracer = make_cli_tracer(args.trace,
                             default_path=args.ckpt + ".serve.trace.jsonl")
    server = DiffusionServer(params, cfg, slots=args.slots,
                             num_steps=args.steps, eta=args.eta, masks=masks,
                             precision=args.precision or "",
                             tracer=tracer if tracer.enabled else None,
                             device=args.device)
    reqs = [Request(rid=r, seed=args.seed + r) for r in range(args.requests)]
    res = server.run(reqs)

    p50 = res.latency_percentile(50) * 1e3
    p99 = res.latency_percentile(99) * 1e3
    print(f"model={cfg.name} device={server.device} "
          f"precision={server.precision} "
          f"prune_ratio={args.prune_ratio} steps={args.steps} "
          f"slots={args.slots}")
    print(f"MACs/forward: {macs / 1e6:.1f}M"
          + (f" (dense {dense_macs / 1e6:.1f}M, "
             f"{macs / dense_macs:.2f}x)" if masks is not None else ""))
    print(f"{len(res.images)}/{args.requests} images in {res.seconds:.2f}s "
          f"({res.requests_per_s:.2f} req/s); per-step latency "
          f"p50={p50:.1f}ms p99={p99:.1f}ms; "
          f"compiles={server.compile_count()}")
    for f in res.faults:
        print(f"fault: {f}")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for rid, img in res.images.items():
            np.save(os.path.join(args.out, f"req{rid}.npy"), img)
        print(f"wrote {len(res.images)} images to {args.out}")
    metrics = {
        "requests": args.requests,
        "images": len(res.images),
        "requests_per_s": res.requests_per_s,
        "p50_step_ms": p50,
        "p99_step_ms": p99,
        "compiles": server.compile_count(),
        "precision": server.precision,
        "device": str(server.device),
        "macs_per_forward": macs,
        "dense_macs_per_forward": dense_macs,
        "faults": res.faults,
    }
    if tracer.enabled:
        tracer.close()
        ts = summarize_trace(tracer.path)
        metrics.update(trace=tracer.path, ticks=ts["phases"].get(
            "serve/tick", {}).get("n", 0), recompiles=ts["recompiles"])
        print(f"trace -> {tracer.path} (ticks={metrics['ticks']} "
              f"recompiles={ts['recompiles']})")
    if args.metrics:
        write_metrics(args.metrics, "serve", metrics)
        print(f"wrote metrics to {args.metrics}")
    if len(res.images) != args.requests:
        raise SystemExit(f"served {len(res.images)}/{args.requests} requests")
    return metrics


if __name__ == "__main__":
    main()
