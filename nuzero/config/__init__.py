from nuzero.config.schemas import (
    CheckpointConfig,
    LearningConfig,
    RunningConfig,
    TrainingConfig,
    load_search_config,
    load_training_config,
)
from nuzero.config.yaml_io import (
    insert_in_all_configs,
    load_yaml,
    remove_from_all_configs,
    save_yaml,
)

__all__ = [
    "CheckpointConfig",
    "LearningConfig",
    "RunningConfig",
    "TrainingConfig",
    "insert_in_all_configs",
    "load_search_config",
    "load_training_config",
    "load_yaml",
    "remove_from_all_configs",
    "save_yaml",
]
