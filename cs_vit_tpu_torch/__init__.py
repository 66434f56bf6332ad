"""PyTorch/CUDA port of ``cs_vit_tpu`` for NVIDIA Hopper (H100).

The package mirrors the layout of ``cs_vit_tpu`` module for module, so each
module's JAX counterpart sits at the same relative path. It imports ``torch``
and never ``jax``, ``flax`` or ``cs_vit_tpu``; what it needs from pure-numpy
modules there (constants, MANO assets) it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; asking
for ``cuda`` on a machine without a card raises instead of moving to the CPU.
The SwinV2 block's kernels (``ops/csrc/fused_block.cu``) are built with
``nvcc`` at first use; on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""
