"""The paper's own model: DDPM U-Net (Ho et al. 2020), 35.7M params.

Used with CIFAR-10-like 32x32 data and CelebA-like 64x64 data (§V-A:
"we employ the same U-Net architecture as in [1], where the dense model
comprises 35.7 million parameters").
"""
from repro_torch.configs.base import ModelConfig

CIFAR10_UNET = ModelConfig(
    name="ddpm-unet-cifar10",
    arch_type="unet",
    source="arXiv:2006.11239 (Ho et al.); FedPhD §V-A",
    image_size=32,
    in_channels=3,
    base_channels=128,
    channel_mults=(1, 2, 2, 2),
    num_res_blocks=2,
    attn_resolutions=(16,),
    num_classes=0,               # unconditional; labels used only for FL partition
    dropout=0.1,
    diffusion_steps=1000,
    dtype="float32",
    param_dtype="float32",
)

CELEBA_UNET = CIFAR10_UNET.replace(
    name="ddpm-unet-celeba",
    image_size=64,               # same net, 2x input size -> 4x MACs (Table IV)
)

# Reduced variant for CPU smoke tests.
SMOKE_UNET = ModelConfig(
    name="ddpm-unet-smoke",
    arch_type="unet",
    source="reduced for CPU",
    image_size=16,
    in_channels=3,
    base_channels=32,
    channel_mults=(1, 2),
    num_res_blocks=1,
    attn_resolutions=(8,),
    num_classes=0,
    dropout=0.0,
    diffusion_steps=100,
    dtype="float32",
    param_dtype="float32",
)
