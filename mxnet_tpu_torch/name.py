"""Symbol naming scopes.

Port of ``mxnet_tpu/name.py`` (upstream ``python/mxnet/name.py``).

``NameManager`` assigns automatic names (``hint%d``) to anonymous
symbols; ``Prefix`` prepends a scope prefix.  Managers nest as context
managers; ``current()`` returns the innermost active one (a default
module-level manager when none is active) — the same contract the
reference's thread-local ``NameManager.current`` provides."""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["NameManager", "Prefix", "current"]

_STACK = threading.local()


def _stack():
    if not hasattr(_STACK, "v"):
        _STACK.v = []
    return _STACK.v


class NameManager:
    """Automatic ``hint%d`` naming for anonymous symbols."""

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        hint = hint.lower()
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *args):
        _stack().pop()


class Prefix(NameManager):
    """NameManager that prepends ``prefix`` to every auto name
    (reference: ``mx.name.Prefix``)."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


_DEFAULT = NameManager()


def current() -> NameManager:
    s = _stack()
    return s[-1] if s else _DEFAULT
