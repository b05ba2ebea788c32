"""The LM stack's models (the port of ``repro.models``): shared layers,
the dense transformer, MoE and Mamba-2 blocks, and ``build_model`` for
all six families; ``convert`` carries params from and to the JAX
package's layout."""
from .api import Model, build_model  # noqa: F401

__all__ = ["Model", "build_model"]
