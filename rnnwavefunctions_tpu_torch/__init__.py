"""RNN wavefunctions trained by Variational Monte Carlo, in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``rnnwavefunctions_tpu`` (JAX/Pallas), which stays the reference
it is held against.  Module paths mirror that package.  This package imports
no JAX.
"""

import torch

from .hamiltonians.j1j2 import J1J2
from .hamiltonians.tfim1d import TFIM1D
from .hamiltonians.tfim2d import TFIM2D
from .models.crnn_u1 import CRNNU1
from .models.mdrnn2d import MDRNN2D
from .models.prnn1d import PRNN1D
from .models.prnn_snake2d import PRNNSnake2D
from .vmc.trainer import TrainConfig, TrainState, VMCTrainer

__version__ = "0.1.0"

# Full float32 everywhere: the JAX reference runs full f32, and TF32 would
# keep only ~3 decimal digits in any matmul or convolution left to cuBLAS or
# cuDNN.  (Both flags are no-ops on a CPU-only build.)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "CRNNU1", "J1J2", "MDRNN2D", "PRNN1D", "PRNNSnake2D", "TFIM1D", "TFIM2D", "TrainConfig",
    "TrainState", "VMCTrainer",
]
