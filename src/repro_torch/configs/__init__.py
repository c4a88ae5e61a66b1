from repro_torch.configs.base import (ARCH_IDS, ArchConfig, MLAConfig,
                                      MoEConfig, MambaConfig, XLSTMConfig,
                                      get_config, get_reduced)

__all__ = ["ARCH_IDS", "ArchConfig", "MLAConfig", "MoEConfig", "MambaConfig",
           "XLSTMConfig", "get_config", "get_reduced"]
