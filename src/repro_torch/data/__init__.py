"""Synthetic input data for the port."""
