"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet,
dense rates without sparsity, at the full 700 W power limit): the yardstick
every roofline share and MFU of this benchmark is read against."""

HBM_BYTES_PER_S = 3.35e12       # HBM3
BF16_FLOPS_PER_S = 989e12       # tensor cores, dense bf16
