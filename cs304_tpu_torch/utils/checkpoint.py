"""Model checkpoints in the ``cs304_tpu.npz.v1`` format: one directory per
label holding ``params.npz`` (means (S, D), covariances (S, D, D), log_a
(S, S), float32) plus a ``manifest.json`` for the collection. Checkpoints
written by the JAX package load here unchanged, and the other way round.
A GMM model stores its mixture weights (S, K) beside them, with means
(S, K, D) and covariances (S, K, D, D), and loads as a GMMWordHMM.

Resumable trainer state (ContinuousTrainer.save_state / resume) is one
``trainer_state.npz`` per folder, the port's own format (the JAX package
writes Orbax state, which this module does not read).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List

import numpy as np

from ..models.hmm import WordHMM

_PARAMS = "params.npz"
_MANIFEST = "manifest.json"
_TRAINER_STATE = "trainer_state.npz"
FORMAT = "cs304_tpu.npz.v1"


def save_model(model, parent_folder: str) -> str:
    """Save one word model (Gaussian or GMM) under <parent>/<label>/params.npz;
    a GMM model also stores its mixture weights."""
    folder = os.path.join(parent_folder, model.label)
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, _PARAMS)
    arrays = {
        "means": np.asarray(model.means, np.float32),
        "covariances": np.asarray(model.covariances, np.float32),
        "log_a": np.asarray(model.log_a, np.float32),
    }
    weights = getattr(model, "weights", None)
    if weights is not None:
        arrays["weights"] = np.asarray(weights, np.float32)
    np.savez(path, **arrays)
    return path


def load_model(model_folder: str):
    """Load one word model; the label is the folder name. A WordHMM, or a
    GMMWordHMM when the npz holds mixture weights."""
    label = os.path.basename(os.path.normpath(model_folder))
    with np.load(os.path.join(model_folder, _PARAMS)) as z:
        if "weights" in z:
            from ..models.gmm_hmm import GMMWordHMM

            return GMMWordHMM(label=label, means=z["means"],
                              covariances=z["covariances"], weights=z["weights"],
                              log_a=z["log_a"])
        return WordHMM(
            label=label,
            means=z["means"],
            covariances=z["covariances"],
            log_a=z["log_a"],
        )


def save_models(
    models: Dict[str, WordHMM] | Iterable[WordHMM], folder: str,
    frontend: Dict | None = None, tier: str | None = None,
    provenance: Dict | None = None,
) -> None:
    """Save a model collection and its manifest."""
    if isinstance(models, dict):
        models = list(models.values())
    models = list(models)
    os.makedirs(folder, exist_ok=True)
    for m in models:
        save_model(m, folder)
    manifest = {"labels": sorted(m.label for m in models), "format": FORMAT}
    if frontend:
        manifest["frontend"] = dict(frontend)
    if tier:
        manifest["unit_tier"] = tier
    if provenance:
        manifest["provenance"] = dict(provenance)
    with open(os.path.join(folder, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def load_manifest(folder: str) -> Dict:
    """Checkpoint manifest dict, or {} for a manifest-less tree."""
    path = os.path.join(folder, _MANIFEST)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_models(folder: str, labels: List[str] | None = None) -> Dict[str, WordHMM]:
    """Load all (or the selected) models of a checkpoint directory, in
    sorted subfolder order."""
    if not folder or not os.path.isdir(folder):
        raise FileNotFoundError(f"checkpoint directory {folder!r} does not exist")
    fmt = load_manifest(folder).get("format", FORMAT)
    if fmt != FORMAT:
        raise ValueError(f"unsupported checkpoint format {fmt!r} (want {FORMAT})")
    out: Dict[str, WordHMM] = {}
    for name in sorted(os.listdir(folder)):
        sub = os.path.join(folder, name)
        if not os.path.exists(os.path.join(sub, _PARAMS)):
            continue
        if labels is not None and name not in labels:
            continue
        out[name] = load_model(sub)
    if not out:
        raise FileNotFoundError(
            f"no model checkpoints under {folder!r} (expected <label>/{_PARAMS})"
        )
    if labels is not None:
        missing = set(labels) - set(out)
        if missing:
            raise FileNotFoundError(f"models not found in {folder}: {sorted(missing)}")
    return out


def save_trainer_state(state: Dict[str, np.ndarray], folder: str) -> str:
    """Write a dict of arrays to <folder>/trainer_state.npz (through a
    temporary file, so an interrupted save leaves the previous state)."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, _TRAINER_STATE)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: np.asarray(v) for k, v in state.items()})
    os.replace(tmp, path)
    return path


def load_trainer_state(folder: str) -> Dict[str, np.ndarray]:
    """The dict written by save_trainer_state."""
    path = os.path.join(folder, _TRAINER_STATE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no trainer state at {path!r}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
