"""The plain reference the benchmark holds the port against.

Plain PyTorch and NumPy in float32 (TF32 off), written from the published
descriptions: MobileNetV2 (Sandler et al. 2018) and VGG16 (Simonyan and
Zisserman 2014) backbones, the Faster R-CNN RPN head, anchors, box
decoding, greedy NMS, target assignment, the losses and SGD with momentum.
It imports nothing of the port, of ``tpurpn`` or of JAX, and takes no
weights, tables or scales the program has made: the harness hands both
sides the same raw inputs (frames, the weight file, seeded leaves, draws).

``quant="fp8"`` computes every convolution on operands rounded to
float8 e4m3 with one scale a tensor: the control, one precision below the
bf16 the configurations state.
"""

import torch


def strict_f32() -> None:
    """Matmuls and convolutions in true f32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
