"""Config system (L2).

Reference analog: ``gst/nnstreamer/nnstreamer_conf.c`` + ``nnstreamer.ini`` —
3-level priority **env var > ini file > hardcoded default**
(nnstreamer_conf.h:26-29). Keys use section/key ini addressing; the env
override for ``[sec] key`` is ``NNS_TPU_<SEC>_<KEY>`` (uppercased). The ini
path itself comes from ``NNS_TPU_CONF`` (reference ``NNSTREAMER_CONF``),
falling back to ``/etc/nnstreamer_tpu.ini``.

The port reads the same ini file and environment as nnstreamer_tpu.
Notable keys:
  * ``[filter] framework_priority_<ext>`` — auto framework detection by model
    file extension (reference ``framework_priority_tflite`` etc.; the port's
    defaults are ``py`` → python and ``so`` → custom, its backends that
    load a model file);
  * ``[common] subplugin_modules_<kind>`` — extra python modules scanned for
    subplugins (reference subplugin dirs);
  * ``[filter-aliases]`` and ``[element-restriction]``.
"""
from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

from ..utils.log import logger

_DEFAULTS: Dict[str, Dict[str, str]] = {
    "common": {
        "enable_envvar": "true",
    },
    "filter": {
        # model-extension -> backend priority (comma-separated, first wins)
        "framework_priority_py": "python",
        "framework_priority_tflite": "tflite",
        "framework_priority_so": "custom",
        # exported programs (torch.export.save): backends/pt2_backend.py;
        # the reference's StableHLO files name its typed error
        "framework_priority_pt2": "torch-export",
        "framework_priority_jaxexport": "stablehlo",
        "framework_priority_stablehlo": "stablehlo",
        "framework_priority_hlo": "stablehlo",
        # model path that is a directory containing saved_model.pb
        "framework_priority_savedmodel": "tensorflow",
    },
    "tensorflow": {
        "signature": "serving_default",
    },
}

DEFAULT_CONF_PATHS = ("/etc/nnstreamer_tpu.ini",)


class Config:
    def __init__(self, path: Optional[str] = None):
        self._ini = configparser.ConfigParser()
        self._path = path or os.environ.get("NNS_TPU_CONF")
        paths = [self._path] if self._path else list(DEFAULT_CONF_PATHS)
        loaded = self._ini.read([p for p in paths if p])
        if loaded:
            logger.info("loaded config from %s", loaded)

    def get(self, section: str, key: str, default: Optional[str] = None) -> Optional[str]:
        env_ok = True
        if not (section == "common" and key == "enable_envvar"):
            env_ok = self.get_bool("common", "enable_envvar", True)
        if env_ok:
            env_key = f"NNS_TPU_{section.upper()}_{key.upper()}"
            if env_key in os.environ:
                return os.environ[env_key]
        if self._ini.has_option(section, key):
            return self._ini.get(section, key)
        hard = _DEFAULTS.get(section, {}).get(key)
        return hard if hard is not None else default

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        v = self.get(section, key)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def get_list(self, section: str, key: str) -> List[str]:
        v = self.get(section, key, "")
        return [p.strip() for p in v.split(",") if p.strip()]

    def filter_alias(self, framework: str) -> str:
        """Resolve a filter-framework alias (reference ``[filter-aliases]``
        in nnstreamer.ini, e.g. ``trix-engine=<real subplugin>``); returns
        the input unchanged when no alias is configured."""
        return self.get("filter-aliases", framework) or framework

    def framework_priority(self, model_path: str) -> List[str]:
        """Backend candidates for a model file, by extension (reference
        ``gst_tensor_filter_detect_framework``, tensor_filter_common.c:1218)."""
        if os.path.isdir(model_path) and os.path.exists(
            os.path.join(model_path, "saved_model.pb")
        ):
            return self.get_list("filter", "framework_priority_savedmodel")
        ext = os.path.splitext(model_path)[1].lstrip(".").lower()
        if not ext:
            return []
        return self.get_list("filter", f"framework_priority_{ext}")


_config: Optional[Config] = None
_lock = threading.Lock()


def get_config() -> Config:
    global _config
    with _lock:
        if _config is None:
            _config = Config()
        return _config


def reset_config(path: Optional[str] = None) -> Config:
    """Reload (tests use this to point at a temp ini)."""
    global _config
    with _lock:
        _config = Config(path)
        return _config
