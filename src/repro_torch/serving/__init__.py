"""Serving layer of the port: engine, lifecycle, API."""
from repro_torch.serving.api import InferenceServer, RequestHandle, ServerConfig
from repro_torch.serving.engine import Engine, EngineConfig, EngineStats
from repro_torch.serving.request import Phase, Request

__all__ = ["InferenceServer", "RequestHandle", "ServerConfig", "Engine",
           "EngineConfig", "EngineStats", "Phase", "Request"]
