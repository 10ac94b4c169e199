from repro_torch.configs.base import (ModelConfig, QuokaConfig,  # noqa: F401
                                     get_config)
