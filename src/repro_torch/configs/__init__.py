"""Config registry of the port: ``get_config(name)``."""

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCHS = ["bitnet-0.73b", "qwen1.5-0.5b"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown config {name!r}; the port has {ARCHS}")
    mod_name = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
