"""Training launcher (``repro/launch/train.py``): real train steps of a
decoder LM on the reduced (smoke) variant of an architecture, one batch
from the seed trained for ``--steps`` steps, as the reference runs it
without ``--full``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 10
  (``--device cpu`` without a card: the kernels' plain versions)

``--full`` and ``--multi-pod`` train the full-size config on the
production mesh.  The mesh (:mod:`repro_torch.launch.mesh`) and its
layout rules (:mod:`repro_torch.launch.sharding`) exist, but the layers
do not yet run tensor-parallel, and expert parallelism is missing
(ROADMAP A.13), so they raise.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import checkpoint
from repro_torch.configs import list_archs, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_opt_init, build_train_step
from repro_torch.models import model
from repro_torch.tree import tree_leaves


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma2-2b",
                    choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full-size config on the production mesh "
                         "(needs tensor-parallel layers and expert "
                         "parallelism: ROADMAP A.13)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default=None, help="save final params here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.full or args.multi_pod:
        raise NotImplementedError(
            "--full and --multi-pod need tensor-parallel execution of the "
            "layers (the sharding rules of repro_torch.launch.sharding "
            "applied in every layer kind) and expert parallelism, which "
            "are not ported yet (ROADMAP A.13, launch/)")

    dev = resolve_device(args.device)
    cfg = smoke_variant(args.arch)
    shape = InputShape("cli", args.seq, args.batch, "train")
    gen = torch.Generator(dev)
    gen.manual_seed(args.seed)
    print(f"arch={cfg.name}  device={dev}")
    params = model.init(cfg, gen, device=dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"params: {n / 1e6:.2f}M")

    # the reference's smoke run: no remat (ApplyOptions(remat=False))
    step_fn = build_train_step(cfg, lr=args.lr, remat=False)
    opt = build_opt_init(cfg)(params)
    batch = model.make_inputs(cfg, shape, gen)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        params, opt, loss = step_fn(params, opt, batch, i)
        losses.append(float(loss))
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tok = args.batch * args.seq * args.steps
    print(f"{args.steps} steps in {dt:.1f}s ({tok / dt:.0f} tok/s); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if args.ckpt:
        checkpoint.save(args.ckpt, params,
                        {"arch": cfg.name, "steps": args.steps,
                         "final_loss": losses[-1]})
        print(f"saved {args.ckpt}")
    return {"arch": cfg.name, "params": n, "losses": losses, "seconds": dt,
            "tok_per_s": tok / dt}


if __name__ == "__main__":
    main()
