"""Public API of the port: the runner and its endpoints, and the JSON
server in front of them."""
from .runner import Adapter3DRunner
from .server import ApiServer

__all__ = ["Adapter3DRunner", "ApiServer"]
