"""Model checkpoints in the ``cs304_tpu.npz.v1`` format: one directory per
label holding ``params.npz`` (means (S, D), covariances (S, D, D), log_a
(S, S), float32) plus a ``manifest.json`` for the collection. Checkpoints
written by the JAX package load here unchanged, and the other way round.
Only single-Gaussian models are ported; a GMM checkpoint (mixture weights in
the npz) raises.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List

import numpy as np

from ..models.hmm import WordHMM

_PARAMS = "params.npz"
_MANIFEST = "manifest.json"
FORMAT = "cs304_tpu.npz.v1"


def save_model(model: WordHMM, parent_folder: str) -> str:
    """Save one word model under <parent>/<label>/params.npz."""
    folder = os.path.join(parent_folder, model.label)
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, _PARAMS)
    np.savez(
        path,
        means=np.asarray(model.means, np.float32),
        covariances=np.asarray(model.covariances, np.float32),
        log_a=np.asarray(model.log_a, np.float32),
    )
    return path


def load_model(model_folder: str) -> WordHMM:
    """Load one word model; the label is the folder name."""
    label = os.path.basename(os.path.normpath(model_folder))
    with np.load(os.path.join(model_folder, _PARAMS)) as z:
        if "weights" in z:
            raise NotImplementedError(
                f"{model_folder} holds a GMM model; GMM models are not ported "
                "yet (ROADMAP Queue 1, slice 3: models/gmm_hmm.py)"
            )
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
