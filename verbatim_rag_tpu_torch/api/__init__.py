"""HTTP service layer (aiohttp)."""

from .config import APIConfig
from .service import APIService, ValidationError

__all__ = ["APIConfig", "APIService", "ValidationError"]
