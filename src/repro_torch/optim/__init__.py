"""The optimizer of the LM stack's training path (the port of
``repro.optim``)."""
from .adamw import AdamW, OptState  # noqa: F401

__all__ = ["AdamW", "OptState"]
