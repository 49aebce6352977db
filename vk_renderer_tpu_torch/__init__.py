"""vk_renderer_tpu_torch — the PyTorch/CUDA port of vk_renderer_tpu.

The JAX package ``vk_renderer_tpu`` (JAX/XLA/Pallas on a TPU) is the
reference; this package renders the same frames with PyTorch on an NVIDIA
Hopper GPU, mirroring its layout and public names:

- ``scene/`` and ``utils/``: the NumPy host loaders (glTF, KTX, texture
  heap, camera, GLM math) — no JAX anywhere, so the package imports on a
  machine without it,
- ``ops/``: setup, binning, records, interpolation, texturing, shading,
  skybox and post as plain torch functions on tensors; the two Pallas
  raster kernels become hand-written CUDA kernels (``csrc/raster.cu``,
  bound in ``ops/raster_kernels.py``) beside plain PyTorch versions that
  the CPU path runs,
- ``graph/``: the frame graph and the host driver.

Execution is eager; every function works on the device of its tensors.
"""

import torch

# The JAX package pins every contraction to Precision.HIGHEST
# (vk_renderer_tpu/ops/common.py:24-27): bf16/TF32 clip coordinates
# quantize screen positions.  Keep float32 matrix products and
# convolutions in full float32 on the GPU as well.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
