"""Serving layer of the port: engine, lifecycle, API, gateway, simulator."""
from repro_torch.serving.api import InferenceServer, RequestHandle, ServerConfig
from repro_torch.serving.engine import Engine, EngineConfig, EngineStats
from repro_torch.serving.gateway import (EngineReplicaPool, HTTPGateway,
                                         PoolHandle, ReplicaDead)
from repro_torch.serving.lifecycle import (AdmissionQueue, RequestLifecycle,
                                           TierPlacer)
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.simulator import (ServingSimulator, SimConfig,
                                           SimResult, compare_schedulers)

__all__ = ["InferenceServer", "RequestHandle", "ServerConfig", "Engine",
           "EngineConfig", "EngineStats", "EngineReplicaPool", "HTTPGateway",
           "PoolHandle", "ReplicaDead", "AdmissionQueue", "RequestLifecycle",
           "TierPlacer", "Phase", "Request", "ServingSimulator", "SimConfig",
           "SimResult", "compare_schedulers"]
