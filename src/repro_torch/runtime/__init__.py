"""Serving and training entry points (port of ``repro.runtime``)."""

from repro_torch.runtime.server import Request, Server, ServerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["Request", "Server", "ServerConfig", "Trainer", "TrainerConfig"]
