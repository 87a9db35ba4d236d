"""Deterministic synthetic input data for the port (``data/pipeline.py``)."""
