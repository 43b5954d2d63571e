"""Deterministic synthetic data pipeline (port of ``repro.data``)."""

from repro_torch.data.pipeline import DataState, SyntheticLM

__all__ = ["SyntheticLM", "DataState"]
