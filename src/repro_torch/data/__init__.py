"""Synthetic paper datasets (numpy, same seeds as the JAX package)."""

from .synthetic import flight_features, hospital_features, hospital_tables

__all__ = ["flight_features", "hospital_features", "hospital_tables"]
