"""Proxy-FID and proxy-IS (``repro/metrics/fid.py``): a fixed
random-feature CNN stands in for Inception-v3, which needs pretrained
weights.  Its scores rank generative models consistently for relative
comparison and are not comparable to Inception-FID.

The reference draws the CNN from ``jax.random.PRNGKey(42)``, a stream
the port cannot draw, so its weights are data here:
``fid_features.npz`` beside this module, written from the reference by
``tools/export_fid_features.py`` and read with numpy, for 3 input
channels (the only count a registered config uses).  The convs run as
``F.conv2d`` with the reference's ``"SAME"`` padding (asymmetric at
stride 2); the statistics are the reference's numpy code.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

FEATURES_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fid_features.npz")
FEATURE_CHANNELS = 3


@lru_cache(maxsize=4)
def _feature_params(channels: int = 3) -> Dict[str, np.ndarray]:
    """The CNN's weights: ``c1``, ``c2``, ``c3`` (HWIO) and ``head``."""
    if channels != FEATURE_CHANNELS:
        raise ValueError(
            f"the proxy feature CNN ships for {FEATURE_CHANNELS} input "
            f"channels, not {channels}: write its weights with "
            f"tools/export_fid_features.py --channels {channels} (it runs "
            f"the JAX package on the CPU)")
    with np.load(FEATURES_NPZ) as z:
        return {k: z[k] for k in ("c1", "c2", "c3", "head")}


def _same_pads(size: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding of one axis: (before, after), with the
    odd element after (at 32 -> 16, k = 3: (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int):
    """x NCHW, w OIHW, padded as XLA's ``"SAME"`` pads."""
    kh, kw = w.shape[2:]
    top, bottom = _same_pads(x.shape[2], kh, stride)
    left, right = _same_pads(x.shape[3], kw, stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _features(x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) in [-1, 1] -> (B, 64)."""
    p = _feature_params(x.shape[-1])
    h = x.permute(0, 3, 1, 2)
    for name in ("c1", "c2", "c3"):
        w = torch.from_numpy(p[name]).to(x.device).permute(3, 2, 0, 1)
        h = F.relu(_conv_same(h, w, 2))
    return h.mean(dim=(2, 3))


@torch.no_grad()
def features(x: np.ndarray, batch: int = 256) -> np.ndarray:
    """(N, H, W, C) images in [-1, 1] -> (N, 64) float32 features, on
    the CPU."""
    out = []
    for i in range(0, len(x), batch):
        xb = torch.as_tensor(np.asarray(x[i:i + batch], np.float32))
        out.append(_features(xb).numpy())
    return np.concatenate(out)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Matrix square root of a symmetric PSD matrix via eigendecomposition."""
    w, v = np.linalg.eigh((a + a.T) / 2)
    w = np.maximum(w, 0.0)
    return (v * np.sqrt(w)) @ v.T


def frechet_distance(mu1, sig1, mu2, sig2) -> float:
    diff = mu1 - mu2
    s1h = _sqrtm_psd(sig1)
    covmean = _sqrtm_psd(s1h @ sig2 @ s1h)
    return float(diff @ diff + np.trace(sig1) + np.trace(sig2)
                 - 2.0 * np.trace(covmean))


def fid_proxy(real: np.ndarray, fake: np.ndarray) -> float:
    """Proxy-FID between two image sets (both (N, H, W, C) in [-1, 1])."""
    fr = features(real)
    ff = features(fake)
    mu1, mu2 = fr.mean(0), ff.mean(0)
    s1 = np.cov(fr, rowvar=False) + 1e-6 * np.eye(fr.shape[1])
    s2 = np.cov(ff, rowvar=False) + 1e-6 * np.eye(ff.shape[1])
    return frechet_distance(mu1, s1, mu2, s2)


def inception_score_proxy(fake: np.ndarray, splits: int = 4) -> float:
    """Proxy-IS: exp(E_x KL(p(y|x) || p(y))) with the fixed random head."""
    p = _feature_params(fake.shape[-1])
    f = features(fake)
    logits = f @ np.asarray(p["head"])
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    scores = []
    for part in np.array_split(probs, splits):
        py = part.mean(0, keepdims=True)
        kl = (part * (np.log(part + 1e-10) - np.log(py + 1e-10))).sum(-1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores))
