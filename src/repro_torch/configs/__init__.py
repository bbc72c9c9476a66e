"""Configurations of the port: the model architectures (``archs``,
``base``) and the Bohm experiment workloads (``bohm_workloads``)."""
from repro_torch.configs.archs import ALL_ARCHS, get_config, reduced_config
from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                      SSMConfig)

__all__ = [
    "ALL_ARCHS", "get_config", "reduced_config",
    "MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig",
]
