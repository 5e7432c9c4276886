"""Config registry of the port: ``get_config(name)`` / ``ARCHS``, the JAX
package's architectures and the paper's own model, in the JAX order."""

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCHS = [
    "xlstm-350m",
    "hymba-1.5b",
    "musicgen-medium",
    "internvl2-76b",
    "granite-3-2b",
    "command-r-35b",
    "qwen1.5-0.5b",
    "qwen2-72b",
    "dbrx-132b",
    "mixtral-8x22b",
    "bitnet-0.73b",   # the paper's own model
]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown config {name!r}; the port has {ARCHS}")
    mod_name = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
