"""Synthetic paper datasets (numpy, same seeds as the JAX package) and the
deterministic LM token stream."""

from .lm_data import PrefetchIterator, TokenStream
from .synthetic import flight_features, hospital_features, hospital_tables

__all__ = ["flight_features", "hospital_features", "hospital_tables",
           "TokenStream", "PrefetchIterator"]
