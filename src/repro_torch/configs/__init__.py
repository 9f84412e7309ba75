"""Configuration presets of the port: the paper's per-accelerator defaults
and the LM architectures (``configs/base.py`` and one module per arch)."""
from repro_torch.configs.base import ARCH_REGISTRY, ArchConfig, get_arch, list_archs
from repro_torch.configs.graphsim import default_config

__all__ = ["ARCH_REGISTRY", "ArchConfig", "default_config", "get_arch", "list_archs"]
