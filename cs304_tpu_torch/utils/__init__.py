from .checkpoint import load_manifest, load_models, save_models

__all__ = ["load_manifest", "load_models", "save_models"]
