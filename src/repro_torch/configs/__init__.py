from repro_torch.configs.base import (MLAConfig, ModelConfig,  # noqa: F401
                                     MoEConfig, QuokaConfig, RWKVConfig,
                                     SSMConfig, get_config)
