"""Synthetic data generators (numpy, seeded)."""
from .pipeline import pumadyn_like
