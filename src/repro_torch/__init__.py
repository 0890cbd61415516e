"""PyTorch / CUDA port of the distributed principal subspace analysis system.

A second package beside the JAX reference (``repro``): the same module
layout and names, plain functions on tensors, and a hand-written Hopper
(``sm_90a``) CUDA kernel wherever the reference has a Pallas kernel on the
ported path.

* Every entry point takes an explicit ``device``. It defaults to CUDA; with
  no card present and no ``device="cpu"`` from the caller it raises instead
  of running on the CPU (``_device.resolve_device``).
* The reference computes in float32 throughout, so TF32 is switched off for
  both matmuls and cuDNN here, at import: TF32 keeps about three decimal
  digits and would move every trace the tests pin.
* Nothing here imports JAX or the reference package.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
