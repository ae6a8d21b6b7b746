"""nnstreamer_tpu_torch — the PyTorch/CUDA port of nnstreamer_tpu.

Typed tensor streams flowing through a declarative pipeline of elements,
with pluggable NN backends, running on an NVIDIA GPU through PyTorch and
hand-written CUDA kernels (``csrc/``). The package mirrors the layout of
``nnstreamer_tpu`` module for module and imports none of it; it needs
neither JAX nor any of its companions.
"""
__version__ = "0.1.0"

from .core import (  # noqa: F401
    Buffer,
    Caps,
    DataType,
    TensorFormat,
    TensorSpec,
    TensorsInfo,
)
