"""Port parity: numpy arrays as op operands.  Every case of
``tests/_torch_port.py``'s ``OP_SPECS`` (but the variadic ones, whose
inputs go as one list) with its inputs after the first given as numpy
arrays, through the port and the reference on the CPU: the outputs
within the case's family tolerance (``TOL``).  Where the reference's op
refuses numpy operands (its optimizer updates write into their state
inputs), the port is held to its own run on NDArrays, exactly."""
import pytest

import mxnet_tpu_torch as P
from _torch_port import (OP_SPECS, TOL, assert_close, canon, op_inputs,
                         ref_dtype, reference as R)


def _numpy_later(spec):
    """Whether the case has an input after its first to give as numpy:
    not a variadic one (its inputs go as one list of arrays)."""
    return len(spec.inputs) > 1 and not spec.variadic and spec.ref


# the _np_* ops are not in ``nd`` in either package: ``mx.np`` makes
# arrays of its operands before it calls them
_LATER = [(fam, i) for fam, specs in sorted(OP_SPECS.items())
          if fam != "_np_ops"
          for i, s in enumerate(specs) if _numpy_later(s)]


def _call(mx, spec, arrays, kw):
    xs = [mx.nd.array(arrays[0], dtype=arrays[0].dtype, **kw)] + \
        [a.copy() for a in arrays[1:]]
    res = getattr(mx.nd, spec.name)(*xs, **spec.attrs)
    return [o.asnumpy() for o in (res if isinstance(res, (list, tuple))
                                  else [res])]


@pytest.mark.parametrize("fam,i", _LATER,
                         ids=["%s-%d" % x for x in _LATER])
def test_op_specs_with_numpy_later_inputs(fam, i):
    spec = OP_SPECS[fam][i]
    arrays = op_inputs(spec, seed=0)
    got = _call(P, spec, arrays, {"ctx": P.cpu()})
    try:
        want = _call(R, spec, arrays, {})
    except Exception:
        want = None
    if want is None:
        xs = [P.nd.array(a, dtype=a.dtype, ctx=P.cpu()) for a in arrays]
        res = getattr(P.nd, spec.name)(*xs, **spec.attrs)
        for k, (g, w) in enumerate(zip(got, [o.asnumpy() for o in (
                res if isinstance(res, (list, tuple)) else [res])])):
            assert_close(g, w, (0.0, 0.0), "%r output %d" % (spec, k))
        return
    assert len(got) == len(want), spec
    for k, (g, w) in enumerate(zip(canon(spec, got), canon(spec, want))):
        assert ref_dtype(g.dtype) == w.dtype, (spec, k, g.dtype, w.dtype)
        assert_close(g, w.astype(g.dtype), TOL[spec.fam],
                     "%r output %d" % (spec, k))
