"""ACE-Step PyTorch/CUDA port: the JAX package `acestep_tpu` rebuilt on
PyTorch, with its Pallas TPU kernels rewritten as hand-written CUDA kernels
for Hopper (`acestep_torch/csrc/`).

This package imports no JAX and nothing of `acestep_tpu`; the JAX package
is the reference it is tested against. Entry points run on the CUDA device
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

# Lazy top-level API (imports stay cheap; torch loads on first use):
#   from acestep_torch import AceStepHandler, generate_music, ...
_LAZY = {
    "AceStepHandler": ("acestep_torch.pipeline.handler", "AceStepHandler"),
    "generate_music": ("acestep_torch.inference", "generate_music"),
    "GenerationParams": ("acestep_torch.inference", "GenerationParams"),
    "GenerationConfig": ("acestep_torch.inference", "GenerationConfig"),
    "GenerationResult": ("acestep_torch.inference", "GenerationResult"),
    "DiTConfig": ("acestep_torch.config", "DiTConfig"),
    "VAEConfig": ("acestep_torch.config", "VAEConfig"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'acestep_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
