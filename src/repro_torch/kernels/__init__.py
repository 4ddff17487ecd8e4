"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the
reference.  Each subpackage holds ``csrc/*.cu``, a wrapper that
dispatches on the tensor's device (CUDA: launch and count; CPU: the
plain PyTorch version) and that plain version.  :mod:`.build` compiles
the sources at first use."""
