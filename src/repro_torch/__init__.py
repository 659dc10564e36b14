"""PyTorch twin of the ``repro`` fleet scoring path, for one NVIDIA H100.

The package mirrors ``repro``'s layout (``core/``, ``forecast/``,
``timeseries/``, ``obs/``, ``flows/``, ``kernels/``) and module names. It
imports ``torch`` and numpy only: the modules it shares with ``repro`` are
its own copies. Entry points take an explicit ``device`` (default
``"cuda"``); the CPU runs only when a caller asks for it.
"""
import torch

# The JAX reference computes in full float32. TF32 keeps about three
# decimal digits, so both switches are pinned off rather than left to the
# library defaults (cuDNN's is on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
