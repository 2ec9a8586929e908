"""PyTorch / CUDA port of ``dmcf_tpu`` for one NVIDIA H100.

A second package beside the JAX reference: same module names, same
semantics, same parameter tree (``interop.params_from_flax`` loads a flax
param tree by module path).  The K-list continuous convolution runs as a
hand-written CUDA kernel (``kernels/cconv_klist.py``, source in
``csrc/cconv_klist.cu``) on CUDA tensors and as its plain PyTorch twin on
CPU tensors.  Nothing here imports JAX or ``dmcf_tpu``.

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
requested but absent; tests pass ``device="cpu"``.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  Raises (never falls back
    to the CPU) when a CUDA device is requested and none is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return device
