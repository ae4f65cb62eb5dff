"""Checkpoint save/load helpers.

Port of ``mxnet_tpu/model.py`` (upstream ``python/mxnet/model.py``
``save_checkpoint``/``load_checkpoint``): ``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:``/``aux:`` keys, in the reference's
formats, so a checkpoint written by either package loads in the other.
Loaded arrays are on the CPU; ``Module.init_params`` copies them to its
context.
"""
from __future__ import annotations

from . import ndarray as nd

__all__ = ["save_checkpoint", "load_params", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)


def load_params(fname):
    """Split a saved dict into (arg_params, aux_params)."""
    save_dict = nd.load(fname)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Returns (symbol, arg_params, aux_params)."""
    from . import symbol as sym
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params("%s-%04d.params" % (prefix, epoch))
    return symbol, arg_params, aux_params
