"""gpsig-tpu on PyTorch and CUDA: signature-kernel sparse GPs on NVIDIA
Hopper.

The port of the ``gpsig_tpu`` JAX package, which stays as its reference.
It serves and trains an SVGP with inducing tensors or inducing sequences:
``serving.Predictor`` answers prediction requests, and
``training.optimize`` minimizes ``SVGP.loss`` with ``training.nadam``;
``recipes.train_gpsig_classifier`` runs the reference's 4-phase classifier
recipe on a dataset (``datasets``, ``metrics``, ``checkpoint``);
``SignatureKernel.K`` gives signature Grams between sequences over any of
the 11 bases (``SignatureRBF``, ``SignatureLinear``, ``SignatureMatern12``,
``SignatureCosine``, ``SignaturePoly``, ``SignatureMix``,
``SignatureMatern32``, ``SignatureMatern52``, ``SignatureSpectral``).  For
rbf, linear and matern12 the covariances and their gradients run as
hand-written CUDA kernels (``ops/inducing_cuda.py``,
``ops/signature_cuda.py``, ``csrc/``); the other bases run as torch ops,
as the JAX package runs them through XLA.  Modules
are built on the card unless told otherwise (``config.default_device``).
The package imports torch and never jax.
"""

from . import config, params  # noqa: F401
from . import ops  # noqa: F401
from . import convert, inducing, kernels, likelihoods, linalg  # noqa: F401
from . import models, serving, training, utils  # noqa: F401
from . import checkpoint, datasets, mean_functions, metrics  # noqa: F401
from . import preprocessing  # noqa: F401
from . import recipes  # noqa: F401
from .inducing import InducingSequences, InducingTensors  # noqa: F401
from .kernels import (  # noqa: F401
    SignatureCosine, SignatureExponential, SignatureGauss, SignatureKernel,
    SignatureLaplace, SignatureLinear, SignatureMatern12, SignatureMatern32,
    SignatureMatern52, SignatureMix, SignaturePoly, SignatureRBF,
    SignatureSpectral)
from .models import SVGP  # noqa: F401

__version__ = "0.1.0"
