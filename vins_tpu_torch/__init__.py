"""vins_tpu_torch — the PyTorch/CUDA port of the vins_tpu VIO engine.

The package mirrors vins_tpu/ module for module. Plain tensor math is
PyTorch; the Pallas kernels of vins_tpu/ops/klt_pallas.py (the fused
pyramidal LK and its one-level entry, the patch NCC, and the BRIEF patch
read) are CUDA C++ kernels in csrc/klt.cu and csrc/brief.cu, built with
nvcc at first CUDA use (never at import). A CPU tensor takes each
kernel's plain PyTorch version; a CUDA tensor launches the kernel or
raises. Entry points run on the first CUDA card unless given a device.

Importing this package imports neither jax nor anything of vins_tpu.
"""

import torch as _torch

# The estimator solves small conditioned least-squares systems that break
# at reduced matmul precision (vins_tpu/__init__.py forces "highest" for
# the same reason): keep every float32 matmul and convolution in full fp32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (VinsConfig, CameraConfig, ImuConfig, SolverConfig,  # noqa: E402
                     FrontendConfig, LoopConfig, WindowConfig, MeshConfig,
                     default_config, euroc_config)

__all__ = [
    "VinsConfig", "CameraConfig", "ImuConfig", "SolverConfig",
    "FrontendConfig", "LoopConfig", "WindowConfig", "MeshConfig",
    "default_config", "euroc_config",
]
