"""pypic_tpu_torch — the PyTorch/CUDA port of pypic_tpu for NVIDIA Hopper.

A 1D electrostatic particle-in-cell code. Plain tensor work is PyTorch;
each Pallas kernel of ``pypic_tpu`` on a ported path is a CUDA C++ kernel
under ``csrc/``, built with nvcc at first use and bound with ctypes. The
module layout mirrors ``pypic_tpu``: the counterpart of ``pypic_tpu/X.py``
is ``pypic_tpu_torch/X.py``. ``pypic_tpu`` stays the reference the port is
tested against.
"""

__version__ = "0.1.0"

from . import constants, engines  # noqa: F401
from .grid import GridSpec, PERIODIC, DIRICHLET_DIRICHLET, DIRICHLET_NEUMANN  # noqa: F401
