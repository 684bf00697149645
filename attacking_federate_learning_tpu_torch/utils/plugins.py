"""Tiny name->factory registry (the JAX package's ``utils/plugins.py``
``Registry``, copied: the port imports nothing of the JAX package).

The reference dispatches defenses through a module-level dict
(reference defences.py:73-75); this generalizes that seam so new plugins
register by name.  (The JAX copy's decorator form of ``register`` has no
caller in the port and is left out.)
"""

from __future__ import annotations


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries = {}

    def register(self, name: str, obj):
        self._entries[name] = obj
        return obj

    def __getitem__(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"Unknown {self.kind} {name!r}; available: {sorted(self._entries)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return sorted(self._entries)
