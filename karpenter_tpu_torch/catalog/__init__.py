"""Synthetic instance-type catalog (the port's copy of the generator)."""

from .generator import (DEFAULT_ZONES, GeneratorConfig, generate_catalog,
                        small_catalog)

__all__ = ["DEFAULT_ZONES", "GeneratorConfig", "generate_catalog",
           "small_catalog"]
