"""Published peaks of the one card the benchmark measures on.

NVIDIA H100 Tensor Core GPU data sheet, SXM part (the 80 GB HBM3 card
that ``torch.cuda.get_device_name()`` names "NVIDIA H100 80GB HBM3"),
dense rates without sparsity, at the full 700 W power limit.  No ceiling
is calibrated on the card itself: on any other card the benchmark fails.
"""

from __future__ import annotations

CARD = "NVIDIA H100 80GB HBM3"

BF16_FLOP_S = 989e12  # bf16 / fp16 tensor cores, dense
TF32_FLOP_S = 495e12  # TF32 tensor cores, dense
FP32_FLOP_S = 67e12  # fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12  # HBM3
MEMORY_BYTES = 80e9

#: the chunk kernels' FMAs by operand type, (bf16 x bf16, bf16 x fp32, fp32
#: x fp32), each at the card's fastest rate that keeps fp32 accuracy: bf16
#: tensor cores; an fp32 operand split into three bf16 parts (989 / 3); both
#: operands split into TF32 high and low parts (495 / 3)
CHUNK_RATES = (BF16_FLOP_S, BF16_FLOP_S / 3, TF32_FLOP_S / 3)
