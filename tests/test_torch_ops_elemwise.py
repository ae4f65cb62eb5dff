"""The elementwise and creation ops of the port's op library
(``mxnet_tpu_torch/ops/elemwise.py``, ``creation_ops.py``) against
the reference's, and the op library's coverage.

Each case of ``tests/_torch_port.py``'s ``OP_SPECS[...]`` for
``elemwise`` and ``creation_ops`` goes through the reference (``mxnet_tpu.nd``) and the port
(``mxnet_tpu_torch.nd`` on ``mx.cpu()``) from the same numpy inputs:
outputs, their dtypes (the reference's JAX runs without x64, so a 64-bit
port result is held against its 32-bit one), the inputs after the call
(mutated states) and the gradients of the float inputs through each
package's autograd with the same head gradient, within the case's
family limit (``_torch_port.TOL``; gradients
``GRAD_FACTOR`` times it).  Every differentiable case's gradient is
also held against float64 central differences of the port's plain op
(``torch.autograd.gradcheck``), and every alias the reference registers
runs the op's first case under that name in both packages.

The ``cuda`` cases (skipped without a card) run each case through the
port on the card and on the CPU (TF32 off) within ``CARD_TOL``.
"""
import pytest

import _torch_port as T
from _torch_port import cuda_device  # noqa: F401

SPECS = T.OP_SPECS["elemwise"] + T.OP_SPECS["creation_ops"]
FD = [s for s in SPECS if T.fd_case(s)]
ALIASES = T.alias_cases(SPECS)


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_against_reference(spec):
    T.check_against_reference(spec)


@pytest.mark.parametrize("spec", FD, ids=repr)
def test_gradient_against_finite_differences(spec):
    T.check_finite_differences(spec)


@pytest.mark.parametrize("spec,alias", ALIASES,
                         ids=[a for _, a in ALIASES])
def test_alias_against_reference(spec, alias):
    T.check_against_reference(spec, name=alias)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_card_against_cpu(spec, cuda_device):
    T.check_on_card(spec)


def test_every_reference_op_is_ported_and_held():
    """Every op name the reference registers, outside the modules this
    slice defers (``_torch_port.DEFERRED_MODULES``, each with its
    reason) and the ``Custom`` op (``tests/test_torch_custom_op.py``),
    is registered in the port, and its op has a case in
    ``OP_SPECS``/``RANDOM_SPECS``."""
    from mxnet_tpu.ops import registry as ref_registry
    from mxnet_tpu_torch.ops import registry as port_registry
    held = T.held_op_names()
    missing, unheld = [], []
    for name, op in sorted(ref_registry._OPS.items()):
        module = op.impl.__module__.split(".")[-1]
        if module in T.DEFERRED_MODULES or name == "Custom":
            continue
        if not port_registry.op_exists(name):
            missing.append((module, name))
        elif port_registry.get_op(name).name not in held:
            unheld.append((module, name))
    assert not missing, missing
    assert not unheld, unheld


def test_deferred_modules_are_not_ported_yet():
    """No reference op module is deferred any more
    (``_torch_port.DEFERRED_MODULES`` is empty): the last two, the INT8
    ops and the ``_np_*`` ops (``ROADMAP.md`` A.9), are registered, the
    first in ``nd`` and ``nd.contrib`` as in the reference, the second in
    the registry only (``mx.np`` calls them), as in the reference."""
    import mxnet_tpu_torch as P
    from mxnet_tpu_torch.ops import registry as reg
    assert T.DEFERRED_MODULES == {}
    for name in ("_contrib_dequantize", "_contrib_quantize", "quantize"):
        assert callable(getattr(P.nd, name))
    assert callable(P.nd.contrib.quantized_conv)
    assert reg.op_exists("_np_sum")
    with pytest.raises(NotImplementedError, match="not ported"):
        getattr(P.nd, "_np_sum")
