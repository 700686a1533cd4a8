"""Registry kernel (counterpart of ``image_segmentation_lab_tpu/registry``).

A registry maps string type-names from the ``dict(type=...)`` configs to
factories.  The JAX package caches registries globally by name
(``RegisterManager``); the port keeps instances of its own so both packages
can be imported into one process without duplicate-key errors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Register:
    """A single string→factory registry namespace."""

    def __init__(self, name: str):
        self._name = name
        self._storage: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def register(self, name: Optional[str] = None, *,
                 aliases: tuple = ()) -> Callable:
        """Decorator registering ``obj`` under ``name`` (default: its
        ``__name__``) and each alias; a duplicate key raises ``KeyError``."""

        def decorator(obj: Any) -> Any:
            keys = (name if name is not None else obj.__name__, *aliases)
            # validate every key before storing any: a duplicate must not
            # leave the registry partially mutated
            for k in keys:
                if k in self._storage:
                    raise KeyError(
                        f"'{k}' is already registered in registry "
                        f"'{self._name}'")
            for k in keys:
                self._storage[k] = obj
            return obj

        return decorator

    def get(self, name: str) -> Any:
        try:
            return self._storage[name]
        except KeyError:
            raise KeyError(
                f"'{name}' is not registered in registry '{self._name}'. "
                f"Available: {sorted(self._storage)}") from None
