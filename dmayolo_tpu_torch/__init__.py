"""PyTorch/CUDA port of dmayolo_tpu for NVIDIA Hopper.

The JAX package `dmayolo_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find.  Public functions keep
the JAX layouts (images (B, H, W, 3), raw head outputs (B, ny, nx, na, no));
inside, feature maps are NCHW tensors in `channels_last` memory.

Entry points run on CUDA unless the caller passes `device="cpu"`.  Kernel
wrappers (`core.nms_kernel`, `nn.conv3x3`) launch their hand-written CUDA
kernel for a CUDA tensor and use their plain PyTorch version only for a CPU
tensor.
"""
