"""Foundation: the framework's error type and its name registry.

Port of ``mxnet_tpu/base.py`` (``MXNetError``, ``Registry``), the parts
the NDArray core and Gluon use.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["MXNetError", "NotPorted", "Registry", "numeric_types",
           "not_ported"]

numeric_types = (float, int)


class MXNetError(RuntimeError):
    """Framework-level error, as the reference's ``MXNetError``."""


class NotPorted(NotImplementedError, AttributeError):
    """A part of the reference the port does not have yet.  It is also an
    ``AttributeError``, so ``hasattr`` on a namespace that raises it for
    a missing name answers False."""


def not_ported(what, reference):
    """The error for a part of the reference that the port does not have
    yet; ``reference`` names its counterpart."""
    return NotPorted(
        "%s is not ported to mxnet_tpu_torch yet (reference: %s)"
        % (what, reference))


class Registry:
    """Name -> object registry (reference ``Registry``): optimizers and
    initializers register here and are created by name."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None,
                 aliases: Optional[List[str]] = None):
        def _reg(obj):
            self._entries[(name or obj.__name__).lower()] = obj
            for a in aliases or []:
                self._entries[a.lower()] = obj
            return obj
        return _reg

    def find(self, name: str) -> Any:
        key = name.lower()
        if key not in self._entries:
            raise MXNetError("Cannot find %s %r. Registered: %s"
                             % (self.kind, name, sorted(self._entries)))
        return self._entries[key]

    def create(self, name: str, *args, **kwargs) -> Any:
        return self.find(name)(*args, **kwargs)
