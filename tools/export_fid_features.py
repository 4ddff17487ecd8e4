#!/usr/bin/env python3
"""Writes the proxy-FID/IS feature CNN's weights for the PyTorch port.

  JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/export_fid_features.py \
      [--out src/repro_torch/metrics/fid_features.npz] [--channels 3]

The JAX package draws its fixed random-feature CNN from
``jax.random.PRNGKey(42)`` (``src/repro/metrics/fid.py:_feature_params``),
a stream the port cannot draw.  This script evaluates
``_feature_params(channels)`` on the CPU and saves its four arrays
(``c1``, ``c2``, ``c3`` in HWIO, ``head`` (64, 10)) as float32 in an
npz, which ``repro_torch.metrics.fid`` reads with numpy.  The committed
file is for ``channels = 3``, the only channel count a registered
config uses.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, os.pardir, "src", "repro_torch", "metrics",
                           "fid_features.npz")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--channels", type=int, default=3)
    args = ap.parse_args()
    from repro.metrics.fid import _feature_params
    p = _feature_params(args.channels)
    arrays = {k: np.asarray(v, np.float32) for k, v in p.items()}
    np.savez(args.out, **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"wrote {os.path.normpath(args.out)}: "
          f"{ {k: a.shape for k, a in arrays.items()} }, {n} floats")


if __name__ == "__main__":
    main()
