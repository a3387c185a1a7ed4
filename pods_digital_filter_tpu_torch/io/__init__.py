"""File formats of the PODFS model: numpy copies of the JAX package's
``io/`` writers.  This package ``__init__`` imports nothing."""
