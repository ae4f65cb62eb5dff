"""Symbol attribute scopes.

Port of ``mxnet_tpu/attribute.py`` (upstream
``python/mxnet/attribute.py``).

``with AttrScope(ctx_group='dev1'):`` attaches attributes to every
symbol created inside the scope — the reference's mechanism for
``group2ctx`` manual model parallelism (SURVEY.md §2.4 row 3) and for
tagging subgraphs.  Scopes nest; inner scopes override outer keys."""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current"]

_STACK = threading.local()


def _stack():
    if not hasattr(_STACK, "v"):
        _STACK.v = []
    return _STACK.v


class AttrScope:
    """Attach attributes to all symbols created within the scope."""

    def __init__(self, **kwargs):
        self._attrs = {k: str(v) for k, v in kwargs.items()}

    def get(self, attr: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        """Merged attrs: every enclosing scope (outer→inner), then the
        explicit ``attr`` dict."""
        out: Dict[str, str] = {}
        for scope in _stack():
            out.update(scope._attrs)
        if attr:
            out.update({k: str(v) for k, v in attr.items()})
        return out

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *args):
        _stack().pop()


_DEFAULT = AttrScope()


def current() -> AttrScope:
    s = _stack()
    return s[-1] if s else _DEFAULT
