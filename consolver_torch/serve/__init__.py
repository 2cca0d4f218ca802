"""Serving: micro-batching engines and the HTTP front-end."""

from consolver_torch.serve.engine import (
    EditInferenceEngine,
    EditRequest,
    EngineShutDown,
    GenerationRequest,
    InferenceEngine,
    ReplicaGroup,
    RequestExpired,
    SD3InferenceEngine,
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
    "SD3InferenceEngine",
    "ServeServer",
    "make_replicas",
    "make_server",
]
