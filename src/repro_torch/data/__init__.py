"""The LM stack's data pipeline (the port of ``repro.data``)."""
from .pipeline import DataSpec, SyntheticLM  # noqa: F401

__all__ = ["DataSpec", "SyntheticLM"]
