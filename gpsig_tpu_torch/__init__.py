"""gpsig-tpu on PyTorch and CUDA: signature-kernel sparse GPs on NVIDIA
Hopper.

The port of the ``gpsig_tpu`` JAX package, which stays as its reference.
This first slice serves: an SVGP with inducing tensors predicts through
``serving.Predictor``, and its Kzz and Kzx covariances run as hand-written
CUDA kernels (``ops/inducing_cuda.py``, ``csrc/``).  The package imports
torch and never jax.
"""

from . import config, params  # noqa: F401
from . import ops  # noqa: F401
from . import convert, inducing, kernels, likelihoods, linalg  # noqa: F401
from . import models, serving, utils  # noqa: F401
from .inducing import InducingTensors  # noqa: F401
from .models import SVGP  # noqa: F401

__version__ = "0.1.0"
