from .init_heuristics import (  # noqa: F401
    suggest_initial_inducing_sequences,
    suggest_initial_inducing_tensors,
    suggest_initial_lengthscales,
)
