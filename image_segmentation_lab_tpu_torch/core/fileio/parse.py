"""Config parsing (counterpart of ``image_segmentation_lab_tpu/core/fileio/
parse.py``).

Config files are executable Python modules: the module is imported and every
top-level name that is not a dunder, a module or a function becomes a config
key, so the port reads the same ``configs/`` files as the JAX package.
"""

from __future__ import annotations

import importlib.util
import shutil
import sys
import types
import uuid
from pathlib import Path
from typing import Any, Dict, Optional


def load_python_config(filename) -> Dict[str, Any]:
    """Import ``filename`` as a python module and scrape its top-level dict."""
    filename = Path(filename)
    if not filename.is_file():
        raise FileNotFoundError(f"Config file not found: {filename}")
    # unique module name so repeated loads of same-named files don't collide
    mod_name = f"_isl_torch_cfg_{filename.stem}_{uuid.uuid4().hex[:8]}"
    spec = importlib.util.spec_from_file_location(mod_name, str(filename))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(mod_name, None)
    return {
        name: value
        for name, value in vars(mod).items()
        if not name.startswith("__")
        and not isinstance(value, (types.ModuleType, types.FunctionType))
    }


def parse_and_backup_config(filename,
                            backup_dir=None,
                            metadata: Optional[dict] = None) -> Dict[str, Any]:
    """Parse a python config module, optionally copying it into
    ``backup_dir`` and recording ``<kind>_config`` in ``metadata`` (kind: the
    directory right after ``configs/``, else the parent directory name)."""
    filename = Path(filename)
    if backup_dir is not None:
        backup_dir = Path(backup_dir)
        backup_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(str(filename), str(backup_dir))
        parts = filename.parts
        if "configs" in parts[:-1]:
            kind = parts[parts.index("configs") + 1]
            if kind == filename.name:  # config directly under configs/
                kind = filename.parent.name
        else:
            kind = filename.parent.name
        if isinstance(metadata, dict):
            metadata[kind + "_config"] = str(backup_dir / filename.name)
    return load_python_config(filename)


def require_config_key(cfg: Dict[str, Any], key: str, path) -> Any:
    """Pop ``cfg[key]`` or exit with a message naming the file."""
    if key not in cfg:
        raise SystemExit(
            f"config {path} has no top-level `{key} = dict(...)` — is it "
            f"the right kind of config for this flag?")
    return cfg.pop(key)
