"""Serving stack of the PyTorch port: the REST job server with render
coalescing, the OpenRouter chat adapter and LoRA training over REST.

Port of `acestep_tpu/serving/`: the endpoint surface, job lifecycle and
persistence model are the JAX package's, stdlib-only (http.server +
threads). One process owns the CUDA device; worker threads serialize
generation through the handlers while HTTP threads stay responsive.
"""

from acestep_torch.serving.jobstore import JobRecord, JobStore, LocalResultCache
from acestep_torch.serving.schemas import GenerateMusicRequest
from acestep_torch.serving.server import AppState, create_server, main

__all__ = [
    "JobRecord",
    "JobStore",
    "LocalResultCache",
    "GenerateMusicRequest",
    "AppState",
    "create_server",
    "main",
]
