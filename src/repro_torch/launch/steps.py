"""Step builders (``repro/launch/steps.py``): prefill and greedy decode.

Each builder closes over a ModelConfig and returns a plain function that
runs eagerly under ``torch.no_grad`` (there is no ``jit`` to hand it
to); what runs where follows the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model


def build_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> last-token logits (B, V)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, cfg, batch)
    return prefill_step


def build_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens) -> (next_tokens (B, 1) int32,
    new cache): one greedy token against the decode cache."""
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode(params, cache, cfg, tokens)
        return logits.argmax(dim=-1).to(torch.int32), new_cache
    return serve_step
