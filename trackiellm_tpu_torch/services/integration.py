"""Plugin system: dynamic module loading + bridge interface.

Parity target: the Rust ``integration`` crate — PluginManager loading
dynamic .so plugins via libloading with a bridge interface (reference:
src/integration/src/lib.rs:12-22). The Python-native equivalent loads
plugin modules from a directory via importlib; each plugin exposes
``register(api) -> dict`` and may hook the module-command registry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys
from typing import Any, Dict, List, Optional

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("services.integration")


@dataclasses.dataclass
class PluginInfo:
    name: str
    path: str
    version: str
    module: Any
    exports: Dict[str, Any]


class PluginManager:
    """Loads ``*.py`` plugins from a directory. A plugin must define
    ``register(api) -> dict`` (its exports); optional ``PLUGIN_NAME`` /
    ``PLUGIN_VERSION`` metadata."""

    def __init__(self, api: Optional[Dict[str, Any]] = None):
        self.api = api or {}
        self._plugins: Dict[str, PluginInfo] = {}

    def load_directory(self, directory: str) -> List[PluginInfo]:
        loaded = []
        if not os.path.isdir(directory):
            return loaded
        for fname in sorted(os.listdir(directory)):
            if fname.endswith(".py") and not fname.startswith("_"):
                try:
                    loaded.append(self.load_file(
                        os.path.join(directory, fname)))
                except TrackieError as e:
                    log.warning("plugin %s failed to load: %s", fname, e)
        return loaded

    def load_file(self, path: str) -> PluginInfo:
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(
            f"trackie_plugin_{name}", path)
        if spec is None or spec.loader is None:
            raise TrackieError(ErrorCode.FFI_ERROR, f"cannot load {path}")
        module = importlib.util.module_from_spec(spec)
        try:
            sys.modules[spec.name] = module
            spec.loader.exec_module(module)
        except Exception as e:
            sys.modules.pop(spec.name, None)
            raise TrackieError(ErrorCode.FFI_ERROR,
                               f"plugin {name} raised on import: {e}") from e
        register = getattr(module, "register", None)
        if not callable(register):
            raise TrackieError(ErrorCode.FFI_ERROR,
                               f"plugin {name} has no register(api)")
        exports = register(self.api) or {}
        info = PluginInfo(
            name=getattr(module, "PLUGIN_NAME", name),
            path=path,
            version=getattr(module, "PLUGIN_VERSION", "0.0.0"),
            module=module,
            exports=exports,
        )
        self._plugins[info.name] = info
        log.info("loaded plugin %s v%s", info.name, info.version)
        return info

    def get(self, name: str) -> Optional[PluginInfo]:
        return self._plugins.get(name)

    def call(self, plugin: str, export: str, *args, **kwargs) -> Any:
        info = self._plugins.get(plugin)
        if info is None or export not in info.exports:
            raise TrackieError(ErrorCode.NOT_FOUND, f"{plugin}.{export}")
        return info.exports[export](*args, **kwargs)

    @property
    def plugins(self) -> List[str]:
        return list(self._plugins)
