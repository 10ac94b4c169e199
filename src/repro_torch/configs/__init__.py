from repro_torch.configs.base import (EncoderConfig,  # noqa: F401
                                     FrontendConfig, MLAConfig, ModelConfig,
                                     MoEConfig, QuokaConfig, RWKVConfig,
                                     SSMConfig, get_config)
