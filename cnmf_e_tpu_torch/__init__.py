"""cnmf_e_tpu_torch — CNMF-E in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

A port of :mod:`cnmf_e_tpu` (JAX/Pallas), which stays beside it as the
reference. The layout mirrors the JAX package module for module
(``cnmf_e_tpu_torch/ops/hals.py`` <-> ``cnmf_e_tpu/ops/hals.py``). This
package imports ``torch`` and never ``jax``, and nothing of the JAX
package: it keeps its own copies of the pure-numpy modules it needs
(``config``, ``utils.simulate``, ``utils.metrics``) and finds connected
components with scipy.

Device policy: the entry points (``CNMFE``, ``convert.state_from_numpy``,
``convert.step_state_from_numpy``) put their tensors on the card unless
the caller passes ``device="cpu"``; every other function works on the
device of the tensors it is given. The kernel wrappers launch their CUDA
kernel for CUDA tensors and run the plain PyTorch version for CPU
tensors; nothing falls back from one to the other.
"""

import torch

from cnmf_e_tpu_torch.config import (BackgroundParams, CNMFEParams,
                                     DeconvParams, InitParams, MergeParams,
                                     SpatialParams, TemporalParams)

__version__ = "0.1.0"

# FP32 first: cuDNN convolutions (filter_movie) default to TF32, which keeps
# about three decimal digits; the reference runs every product in full f32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def __getattr__(name):
    if name == "CNMFE":
        from cnmf_e_tpu_torch.models.pipeline import CNMFE
        return CNMFE
    raise AttributeError(name)


__all__ = [
    "CNMFEParams", "DeconvParams", "InitParams", "BackgroundParams",
    "MergeParams", "SpatialParams", "TemporalParams", "CNMFE",
    "__version__",
]
