"""The LM stack's training loop (the port of ``repro.train``)."""
from .loop import TrainConfig, Trainer, compress_grads  # noqa: F401

__all__ = ["TrainConfig", "Trainer", "compress_grads"]
