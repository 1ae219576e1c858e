"""gpsig-tpu on PyTorch and CUDA: signature-kernel sparse GPs on NVIDIA
Hopper.

The port of the ``gpsig_tpu`` JAX package, which stays as its reference.
It serves and trains an SVGP with inducing tensors or inducing sequences:
``serving.Predictor`` answers prediction requests, and
``training.optimize`` minimizes ``SVGP.loss`` with ``training.nadam``;
``SignatureKernel.K`` gives signature Grams between sequences.  The
covariances and their gradients run as hand-written CUDA kernels
(``ops/inducing_cuda.py``, ``ops/signature_cuda.py``, ``csrc/``).  Modules are built on the card unless told otherwise
(``config.default_device``).  The package imports torch and never jax.
"""

from . import config, params  # noqa: F401
from . import ops  # noqa: F401
from . import convert, inducing, kernels, likelihoods, linalg  # noqa: F401
from . import models, serving, training, utils  # noqa: F401
from .inducing import InducingSequences, InducingTensors  # noqa: F401
from .models import SVGP  # noqa: F401

__version__ = "0.1.0"
