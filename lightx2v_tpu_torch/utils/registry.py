"""Registries mapping config strings to implementations (the same keys as
``lightx2v_tpu.utils.registry``, so run configs work unchanged)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Union


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._table: Dict[str, Any] = {}

    def register(self, key: Union[str, Iterable[str]], obj: Optional[Any] = None):
        """Use as decorator ``@REG.register("name")`` or call ``REG.register("name", fn)``."""
        keys = [key] if isinstance(key, str) else list(key)

        def _do(o):
            for k in keys:
                if k in self._table:
                    raise KeyError(f"{self.name}: duplicate key {k!r}")
                self._table[k] = o
            return o

        if obj is not None:
            return _do(obj)
        return _do

    def __getitem__(self, key: str) -> Any:
        if key not in self._table:
            raise KeyError(f"{self.name}: unknown key {key!r}; available: {sorted(self._table)}")
        return self._table[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self._table.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._table

    def keys(self):
        return self._table.keys()


MM_REGISTER = Registry("mm")
ATTN_REGISTER = Registry("attention")
RUNNER_REGISTER = Registry("runner")
SCHEDULER_REGISTER = Registry("scheduler")
