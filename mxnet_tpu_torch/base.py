"""Foundation: the framework's error type and its name registry.

Port of ``mxnet_tpu/base.py``: ``MXNetError``, the named ``Registry``
families, the environment readers and the declarative ``Parameter``
struct of ``ParamSpec`` fields.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

__all__ = ["MXNetError", "NotPorted", "Registry", "Parameter", "ParamSpec",
           "env_flag", "env_int", "string_types", "numeric_types",
           "integer_types", "not_ported"]

string_types = (str,)
numeric_types = (float, int)
integer_types = (int,)


def env_flag(name: str, default: bool = False) -> bool:
    """The environment variable ``name`` as a flag: unset is
    ``default``; ``0``, ``false``, ``off`` and empty are False."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "off", "")


def env_int(name: str, default: int) -> int:
    """The environment variable ``name`` as an int (``default`` when it
    is unset or not a number)."""
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


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
    initializers register here and are created by name; ``Registry.get``
    finds (or makes) the registry of a kind."""

    _registries: Dict[str, "Registry"] = {}

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}
        Registry._registries[kind] = self

    @classmethod
    def get(cls, kind: str) -> "Registry":
        if kind not in cls._registries:
            cls(kind)
        return cls._registries[kind]

    def list(self) -> List[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._entries

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


class ParamSpec:
    """One declared field of a :class:`Parameter` struct."""

    __slots__ = ("name", "type", "default", "required", "doc", "choices")

    def __init__(self, name, type=None, default=None, required=False, doc="",
                 choices=None):
        self.name = name
        self.type = type
        self.default = default
        self.required = required
        self.doc = doc
        self.choices = choices

    def validate(self, value):
        if self.choices is not None and value not in self.choices:
            raise MXNetError("Parameter %s=%r not in allowed choices %s"
                             % (self.name, value, self.choices))
        return value


class Parameter:
    """A declarative parameter struct (reference ``dmlc::Parameter``):
    subclasses declare :class:`ParamSpec` class attributes, and
    ``init(**kwargs)`` validates the values and fills the defaults."""

    @classmethod
    def fields(cls) -> Dict[str, ParamSpec]:
        out = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, ParamSpec):
                    out[k] = v
        return out

    @classmethod
    def init(cls, **kwargs) -> Dict[str, Any]:
        out = {}
        for name, spec in cls.fields().items():
            if name in kwargs:
                out[name] = spec.validate(kwargs.pop(name))
            elif spec.required:
                raise MXNetError("Required parameter %s missing" % name)
            else:
                out[name] = spec.default
        if kwargs:
            raise MXNetError("Unknown parameters: %s" % sorted(kwargs))
        return out


def classproperty(f):
    """A read-only property of the class: ``f(cls)``."""
    class _ClassProperty:
        def __get__(self, obj, owner):
            return f(owner)
    return _ClassProperty()
