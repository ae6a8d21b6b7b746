"""Model registry: ``registry://name[@version]`` model-URI resolution (L2).

Reference analog: ``gst/nnstreamer/ml_agent.c`` (``mlagent://`` URIs resolved
through the Tizen ML-Agent D-Bus model database to a concrete file path).
Here: a JSON registry file — no daemon; the same file nnstreamer_tpu
reads — located via the usual 3-level config priority (``NNS_TPU_MODEL_REGISTRY`` env > ``[common]
model_registry`` ini key > ``~/.nnstreamer_tpu/models.json``):

    {
      "mobilenet": {"path": "/models/mnv2.tflite", "framework": "tflite"},
      "scaler": {
        "active": "2",
        "versions": {"1": {"path": "/m/v1.so"}, "2": {"path": "/m/v2.so"}}
      }
    }

``registry://scaler`` resolves the active version; ``registry://scaler@1``
pins one. The optional ``framework`` key feeds ``framework=auto``.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

from .config import get_config

SCHEME = "registry://"

# -- process-local registry overlay -------------------------------------------
# In-process publishers (nnstreamer_tpu's service layer publishes its
# versioned model slots this way) register here so a launch line can say
# ``model=registry://myslot`` with no registry FILE on disk; local entries
# shadow same-named file entries. Entries use the
# identical {"versions": ..., "active": ...} schema as the JSON file.
_local: Dict[str, dict] = {}
_local_lock = threading.Lock()


def register_local_model(name: str, entry: dict) -> None:
    """Publish/replace an in-process registry entry (file-schema dict)."""
    with _local_lock:
        _local[name] = entry


def unregister_local_model(name: str) -> None:
    with _local_lock:
        _local.pop(name, None)


def local_model_names() -> Tuple[str, ...]:
    with _local_lock:
        return tuple(sorted(_local))


def registry_path() -> str:
    env = os.environ.get("NNS_TPU_MODEL_REGISTRY")
    if env:
        return env
    conf = get_config().get("common", "model_registry", "")
    if conf:
        return conf
    return os.path.expanduser("~/.nnstreamer_tpu/models.json")


def is_registry_uri(model: str) -> bool:
    return model.startswith(SCHEME)


def resolve(model: str) -> Tuple[str, Optional[str]]:
    """``registry://name[@version]`` → (path, framework_hint|None).

    Raises KeyError for unknown names/versions, FileNotFoundError when the
    registry file itself is missing.
    """
    if not is_registry_uri(model):
        return model, None
    ref = model[len(SCHEME):]
    name, _, version = ref.partition("@")
    with _local_lock:
        local_entry = _local.get(name)
    if local_entry is not None:
        entry = local_entry
    else:
        path = registry_path()
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"model registry {path} not found (set NNS_TPU_MODEL_REGISTRY "
                "or [common] model_registry)"
            )
        with open(path) as fh:
            reg = json.load(fh)
        if name not in reg:
            raise KeyError(f"model '{name}' not in registry {path} "
                           f"(known: {sorted(reg)})")
        entry = reg[name]
    if isinstance(entry, str):  # shorthand: "name": "/path/to/model"
        entry = {"path": entry}
    if not isinstance(entry, dict):
        raise ValueError(
            f"model '{name}': registry entry must be a path string or an "
            f"object, got {type(entry).__name__}"
        )
    if "versions" in entry:
        if not isinstance(entry["versions"], dict):
            raise ValueError(f"model '{name}': 'versions' must be an object")
        ver = version or str(entry.get("active", ""))
        if not ver:
            raise KeyError(f"model '{name}': no version given and no 'active'")
        if ver not in entry["versions"]:
            raise KeyError(f"model '{name}' has no version '{ver}' "
                           f"(known: {sorted(entry['versions'])})")
        picked = entry["versions"][ver]
        if isinstance(picked, str):
            picked = {"path": picked}
        if not isinstance(picked, dict):
            raise ValueError(
                f"model '{name}' version '{ver}': entry must be a path "
                f"string or an object"
            )
        entry = {**{k: v for k, v in entry.items() if k != "versions"},
                 **picked}
    elif version:
        raise KeyError(f"model '{name}' is unversioned; cannot pin @{version}")
    if "path" not in entry:
        raise KeyError(f"model '{name}': registry entry has no 'path'")
    return entry["path"], entry.get("framework")
