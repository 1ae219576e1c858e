from .svgp import SVGP  # noqa: F401
