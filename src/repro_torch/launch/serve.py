"""Serving launcher: continuous-batching decode loop
(``repro/launch/serve.py``).

A batch of independent request slots shares one serve step; a finished
request (max tokens) hands its slot to the next queued one.  Each
request's seed token is a function of its request id only, drawn from
the same numpy stream as the reference's, and a refilled slot's cache
rows are blended back to fresh state (``model.reset_cache_slots``)
before its first step, so a request's output does not depend on the
slot that serves it or on what ran there before.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
  (on the reference's smoke variant; ``--device cpu`` without a card)
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import model


def seed_token(cfg, seed: int, rid: int) -> int:
    """Deterministic per-request seed token: a function of the request
    id only (not the slot it lands in or the slot's history)."""
    return int(np.random.default_rng((seed, rid)).integers(0, cfg.vocab_size))


def serve_requests(params, cfg, *, slots: int, requests: int,
                   max_tokens: int, cache_len: int,
                   seed: int = 0) -> Dict[str, object]:
    """Run ``requests`` generation requests through ``slots`` continuous-
    batching slots on the params' device; returns per-request token
    lists, throughput, and ``step_seconds``: the host clock of each
    decode step, ending at the host copy of its tokens (which waits for
    the device)."""
    device = params["embed"].device
    serve = build_serve_step(cfg)
    fresh = model.init_cache(params, cfg, slots, cache_len)
    cache = fresh

    slot_req: List[Optional[int]] = [r if r < requests else None
                                     for r in range(slots)]
    slot_len = [0] * slots
    toks = torch.tensor([seed_token(cfg, seed, r) for r in range(slots)],
                        dtype=torch.int32, device=device)[:, None]
    next_req = min(slots, requests)
    done = 0
    outputs: Dict[int, List[int]] = {i: [] for i in range(requests)}
    step_seconds: List[float] = []

    t0 = time.perf_counter()
    generated = 0
    while done < requests:
        ts = time.perf_counter()
        toks, cache = serve(params, cache, toks)
        host = toks.cpu().numpy()
        step_seconds.append(time.perf_counter() - ts)
        generated += slots
        reset = np.zeros((slots,), bool)
        new_toks = host[:, 0].copy()
        for s in range(slots):
            rid = slot_req[s]
            if rid is None:
                continue
            outputs[rid].append(int(host[s, 0]))
            slot_len[s] += 1
            if slot_len[s] >= max_tokens:
                done += 1
                nxt = next_req if next_req < requests else None
                next_req += 1
                slot_req[s] = nxt
                slot_len[s] = 0
                # refill: fresh cache rows + the new request's seed token
                reset[s] = True
                new_toks[s] = seed_token(cfg, seed, nxt) \
                    if nxt is not None else 0
        if reset.any():
            cache = model.reset_cache_slots(
                cache, fresh, torch.from_numpy(reset).to(device))
            toks = torch.from_numpy(new_toks.astype(np.int32)).to(
                device)[:, None]
    dt = time.perf_counter() - t0
    return {"outputs": outputs, "seconds": dt, "generated": generated,
            "tok_per_s": generated / dt if dt > 0 else float("inf"),
            "step_seconds": step_seconds}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="recurrentgemma-9b",
                    choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4, help="serving slots")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_variant(args.arch)
    gen = torch.Generator(dev)
    gen.manual_seed(args.seed)
    params = model.init(cfg, gen, device=dev)
    res = serve_requests(params, cfg, slots=args.batch,
                         requests=args.requests, max_tokens=args.max_tokens,
                         cache_len=args.cache_len, seed=args.seed)
    print(f"arch={cfg.name} device={dev}  {args.requests} requests x "
          f"{args.max_tokens} tokens, {args.batch} slots: "
          f"{res['seconds']:.1f}s ({res['tok_per_s']:.0f} tok/s incl. "
          f"refills)")
    for rid in range(min(args.requests, 4)):
        print(f"  req{rid}: {res['outputs'][rid][:12]}...")
    return res


if __name__ == "__main__":
    main()
