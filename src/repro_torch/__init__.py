"""PyTorch/CUDA port of the FedPhD reproduction (serving path).

Mirrors the layout of the JAX package ``repro`` module for module and
imports nothing of it (nor JAX).  Every GEMM, attention block and group
reduction on the serving path runs a hand-written Hopper kernel on CUDA
tensors (``repro_torch.kernels``); CPU tensors take the kernels' plain
PyTorch versions.  Entry points run on ``cuda`` unless given
``device="cpu"``.

  python -m repro_torch.serve --ckpt <ckpt> --requests 16 --slots 8
"""
