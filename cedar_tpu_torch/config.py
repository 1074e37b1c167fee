"""Cedar-compatible JSON configuration.

Mirrors the behavior of the reference's config wrapper
(reference: include/cedar/config.h:12-110, src/config.cc): a JSON document
addressed with dotted paths, `get(path, default)` semantics, programmatic
`set`, and extraction of nested sub-configs (used for the recursive
`cg-config` of redistributed coarse solvers and the `plane-config` of
embedded 2D plane solvers).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Iterable


class Config:
    """A dotted-path view over a JSON-style nested dict.

    ``Config("config.json")`` loads from a file if it exists (mirroring the
    reference solver's default of reading ``config.json`` from the working
    directory, include/cedar/multilevel.h:51); ``Config({...})`` wraps a dict;
    ``Config()`` is empty (all gets return their defaults).
    """

    def __init__(self, src: str | dict | None = None):
        if src is None:
            self._root: dict = {}
        elif isinstance(src, str):
            if os.path.exists(src):
                with open(src) as f:
                    self._root = json.load(f)
            else:
                self._root = {}
        elif isinstance(src, dict):
            self._root = copy.deepcopy(src)
        elif isinstance(src, Config):
            self._root = copy.deepcopy(src._root)
        else:
            raise TypeError(f"cannot build Config from {type(src)}")

    # -- dotted path helpers -------------------------------------------------
    @staticmethod
    def _split(path: str) -> list[str]:
        return [p for p in path.split(".") if p]

    def _lookup(self, path: str):
        node: Any = self._root
        for part in self._split(path):
            if not isinstance(node, dict) or part not in node:
                return None, False
            node = node[part]
        return node, True

    # -- public API ----------------------------------------------------------
    def get(self, path: str, default: Any = None) -> Any:
        val, ok = self._lookup(path)
        return val if ok else default

    def getvec(self, path: str, default: Iterable | None = None) -> list:
        val, ok = self._lookup(path)
        if not ok:
            return list(default) if default is not None else []
        if not isinstance(val, list):
            return [val]
        return list(val)

    def getnvec(self, path: str) -> list:
        """Nested vector (list of lists), e.g. redist.search.path."""
        return self.get(path, [])

    def set(self, path: str, value: Any) -> None:
        parts = self._split(path)
        node = self._root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def setvec(self, path: str, value: Iterable) -> None:
        self.set(path, list(value))

    def getconf(self, path: str) -> "Config | None":
        """Extract a nested sub-config (reference: config.h `getconf`).

        ``getconf("")`` returns a copy of the whole config (the reference uses
        this when no ``cg-config`` is present so the inner solver inherits the
        outer settings, src/multilevel_settings.cc:55-57).
        """
        if path == "":
            return Config(self._root)
        val, ok = self._lookup(path)
        if not ok or not isinstance(val, dict):
            return None
        return Config(val)

    def to_dict(self) -> dict:
        return copy.deepcopy(self._root)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            json.dump(self._root, f, indent=2)

    def __repr__(self) -> str:
        return f"Config({json.dumps(self._root, indent=2)})"
