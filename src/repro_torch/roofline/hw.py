"""H100 SXM5 80GB hardware constants (per card), the roofline
denominators.  Framework-free, so ``chip_smoke.py`` imports it before
torch.

Every number is NVIDIA's for an H100 SXM5 80GB at its 700 W limit; a
card set to a lower power limit reaches less under load.  The rates are
dense (no structured sparsity)."""

# H100 SXM5 80GB, 700 W (NVIDIA H100 Tensor Core GPU datasheet): FP32 on
# the CUDA cores, BF16 on the tensor cores, FLOP/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# H100 SXM5 80GB, 700 W (datasheet): HBM3, bytes/s
PEAK_BYTES = 3.35e12
# H100 SXM5 80GB, 700 W (datasheet: "NVLink 900GB/s", both directions
# of 18 fourth-generation links): one direction, bytes/s a card, the
# rate a ring collective moves each card's share at inside one node
NVLINK_BW = 450e9
# H100 SXM5 80GB, 700 W in a DGX H100-style node (NVIDIA DGX H100
# datasheet: one ConnectX-7 400 Gb/s InfiniBand NDR port a card), one
# direction, bytes/s a card across nodes; assumed, as the reference
# assumes its inter-pod rate
NET_BW = 400e9 / 8
