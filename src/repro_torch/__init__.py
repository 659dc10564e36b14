"""PyTorch twin of ``repro`` for one NVIDIA H100: the fleet scoring path
and the language-model serving path.

The package mirrors ``repro``'s layout (``core/``, ``forecast/``,
``timeseries/``, ``obs/``, ``flows/``, ``configs/``, ``arch/``,
``serve/``, ``launch/``, ``kernels/``) and module names. It imports
``torch`` and numpy only: the modules it shares with ``repro`` are its own
copies. Entry points take an explicit ``device`` (default ``"cuda"``), or
run where the tensors they are given lie; the CPU runs only when a caller
asks for it.
"""
import torch

# The JAX reference computes in full float32. TF32 keeps about three
# decimal digits, so both switches are pinned off rather than left to the
# library defaults (cuDNN's is on).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# bf16 GEMMs accumulate in f32 in the reference (XLA's dots with f32
# accumulation). cuBLAS may otherwise round split-K partial sums to bf16
# (PyTorch's default is True), so that is pinned off too.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
