"""Instance-type catalog: the port's copies of the generator and of the
provider (pricing, ICE marks, overlays, the epoch the facade keys on)."""

from .generator import (DEFAULT_ZONES, GeneratorConfig, generate_catalog,
                        small_catalog)
from .pricing import PricingProvider
from .provider import CatalogProvider
from .unavailable import UnavailableOfferings

__all__ = ["DEFAULT_ZONES", "GeneratorConfig", "generate_catalog",
           "small_catalog", "PricingProvider", "CatalogProvider",
           "UnavailableOfferings"]
