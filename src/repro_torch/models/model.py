"""Model interface (``repro/models/model.py``): ``init`` and
``loss_fn`` dispatch on ``cfg.arch_type`` (the U-Net's DDPM loss, a
transformer's chunked cross-entropy plus its MoE aux loss: decoder,
encdec or vlm); a transformer serves through ``prefill``, ``init_cache``, ``decode`` and
``reset_cache_slots`` (and ``decode_`` and ``reset_cache_slots_``,
which write into the cache they are given); ``input_specs`` and
``make_inputs`` give a shape's inputs."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.diffusion.ddpm import ddpm_loss
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.models import transformer as tfm
from repro_torch.models.common import dtype_of
from repro_torch.models.unet import Params, apply_unet, init_unet


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    if cfg.arch_type == "unet":
        return init_unet(cfg, generator, device=device)
    return tfm.init_params(cfg, generator, device=device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None, *,
            masks: Optional[Dict[str, torch.Tensor]] = None,
            clients: Optional[int] = None,
            t: Optional[torch.Tensor] = None,
            eps: Optional[torch.Tensor] = None,
            remat: bool = True) -> torch.Tensor:
    """A U-Net's DDPM epsilon loss of one batch (``batch["images"]``),
    with t and eps drawn from ``generator`` unless given.  Training runs
    the U-Net without dropout, as the reference's loss does
    (``apply_unet(train=False)``).  ``masks``: the sparse-phase prune
    masks (PruneGroup name -> 0/1 row), applied as masked GEMMs.
    ``clients=C``: stacked params and C batches one after another; the
    result is the (C,) per-client losses.

    A transformer's loss is :func:`transformer.chunked_xent` of the
    forward over ``batch`` (``tokens``; a VLM's ``image_embeds``, an
    encdec model's ``frames``) against ``batch["labels"]`` (-1 ignored),
    with ``remat`` (the reference's default ``ApplyOptions.remat=True``),
    plus the MoE layers' load-balance aux loss (0 without MoE layers).
    RWKV layers are not ported yet (ROADMAP A.13) and raise."""
    if cfg.arch_type != "unet":
        hidden, aux = tfm.forward(params, cfg, batch, remat=remat)
        return tfm.chunked_xent(params, cfg, hidden, batch["labels"],
                                remat=remat) + aux
    x0 = batch["images"]
    schedule = linear_schedule(cfg.diffusion_steps, device=x0.device)
    return ddpm_loss(lambda x_t, tt: apply_unet(params, cfg, x_t, tt,
                                                masks=masks,
                                                clients=clients),
                     schedule, x0, generator, t=t, eps=eps, clients=clients)


def prefill(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward; the last position's logits (B, V)."""
    hidden, _ = tfm.forward(params, cfg, batch)
    return tfm.logits_from_hidden(params, cfg, hidden[:, -1:, :])[:, 0, :]


def init_cache(params: Params, cfg: ModelConfig, batch: int, seq_len: int):
    """The decode cache; an encdec model's ``enc_out`` is zeros
    (B, encoder_seq_len, d) in the activation dtype, as the reference
    serves it (a caller that has run the encoder passes its output to
    :func:`transformer.init_cache` instead)."""
    enc_out = None
    if cfg.arch_type == "encdec":
        enc_out = torch.zeros((batch, cfg.encoder_seq_len, cfg.d_model),
                              dtype=dtype_of(cfg.dtype),
                              device=params["embed"].device)
    return tfm.init_cache(params, cfg, batch, seq_len, enc_out=enc_out)


def decode(params: Params, cache, cfg: ModelConfig, tokens: torch.Tensor):
    """(logits, new cache); ``cache`` is left as it was."""
    return tfm.decode_step(params, cache, cfg, tokens)


def decode_(params: Params, cache, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Logits of one decode step that writes into ``cache`` in place."""
    return tfm.decode_step_(params, cache, cfg, tokens)


def reset_cache_slots(cache, fresh, reset: torch.Tensor):
    """Per-slot cache reset for continuous-batching refill (see
    :func:`repro_torch.models.transformer.reset_cache_slots`)."""
    return tfm.reset_cache_slots(cache, fresh, reset)


def reset_cache_slots_(cache, fresh, reset: torch.Tensor):
    """:func:`reset_cache_slots` written into ``cache`` in place; ``fresh``
    may hold one slot."""
    return tfm.reset_cache_slots_(cache, fresh, reset)


class InputSpec(NamedTuple):
    """A model input's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct`` stand-in)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, InputSpec]:
    """Shape and dtype of every model input of ``shape``, as the
    reference's ``input_specs`` gives them: a U-Net's images and labels;
    a transformer's ``tokens`` (one per row when decoding) and, in
    training, ``labels`` (B, S); a VLM's ``image_embeds``
    (B, N_img, d) take the first N_img of the S positions, and an
    encdec model's ``frames`` are (B, Se, d), both in the activation
    dtype (the modality frontends are stubs)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.arch_type == "unet":
        return {"images": InputSpec((B, cfg.image_size, cfg.image_size,
                                     cfg.in_channels), torch.float32),
                "labels": InputSpec((B,), i32)}
    tfm.stack_plan(cfg)              # raises for what is not ported
    if shape.mode == "decode":
        return {"tokens": InputSpec((B, 1), i32)}
    act = dtype_of(cfg.dtype)
    specs = {}
    s_text = S
    if cfg.arch_type == "vlm":
        s_text = S - cfg.num_image_tokens
        specs["image_embeds"] = InputSpec(
            (B, cfg.num_image_tokens, cfg.d_model), act)
    if cfg.arch_type == "encdec":
        specs["frames"] = InputSpec((B, cfg.encoder_seq_len, cfg.d_model),
                                    act)
    specs["tokens"] = InputSpec((B, s_text), i32)
    if shape.mode == "train":
        specs["labels"] = InputSpec((B, S), i32)
    return specs


def make_inputs(cfg: ModelConfig, shape: InputShape,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random inputs matching :func:`input_specs`, drawn from
    ``generator`` on its device: integers uniform in [0, vocab) (a
    U-Net's labels in [0, num_classes)), floats standard normal cast to
    their dtype.  The port cannot reproduce the reference's
    ``jax.random`` draws: the same seed gives other numbers."""
    out = {}
    device = generator.device
    for k, (shp, dt) in input_specs(cfg, shape).items():
        if dt == torch.int32:
            hi = cfg.vocab_size if cfg.arch_type != "unet" \
                else max(cfg.num_classes, 1)
            out[k] = torch.randint(0, max(hi, 2), shp, generator=generator,
                                   device=device, dtype=torch.int32)
        else:
            out[k] = torch.randn(shp, generator=generator,
                                 device=device).to(dt)
    return out
