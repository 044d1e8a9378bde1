from .checkpoint import (
    load_manifest,
    load_models,
    load_trainer_state,
    save_models,
    save_trainer_state,
)

__all__ = [
    "load_manifest", "load_models", "load_trainer_state", "save_models",
    "save_trainer_state",
]
