"""Serving: micro-batching engines and the HTTP front-end."""

from consolver_torch.serve.engine import (
    EditInferenceEngine,
    EditRequest,
    EngineShutDown,
    GenerationRequest,
    InferenceEngine,
    ReplicaGroup,
    RequestExpired,
    make_replicas,
)
from consolver_torch.serve.http import ServeServer, make_server

__all__ = [
    "EditInferenceEngine",
    "EditRequest",
    "EngineShutDown",
    "GenerationRequest",
    "InferenceEngine",
    "ReplicaGroup",
    "RequestExpired",
    "ServeServer",
    "make_replicas",
    "make_server",
]
