"""Configuration presets of the port: the paper's per-accelerator defaults."""
from repro_torch.configs.graphsim import default_config

__all__ = ["default_config"]
