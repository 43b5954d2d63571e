"""Serving entry points (port of ``repro.runtime``; the trainer comes with
the training slice)."""

from repro_torch.runtime.server import Request, Server, ServerConfig

__all__ = ["Request", "Server", "ServerConfig"]
