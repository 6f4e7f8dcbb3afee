"""Public API of the port: the runner and its endpoints."""
from .runner import Adapter3DRunner

__all__ = ["Adapter3DRunner"]
