"""Deterministic CIFAR-like synthetic images: a re-export of
``data/pipeline.py::SyntheticImages`` for the serving slice's imports."""
from repro_torch.data.pipeline import SyntheticImages  # noqa: F401
