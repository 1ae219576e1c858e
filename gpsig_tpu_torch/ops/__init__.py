from . import base_kernels, gram, inducing_cuda, signature  # noqa: F401
