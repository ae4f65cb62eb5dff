"""``mx.np``'s ``_np_*`` operators against the reference on the CPU.

Each case of ``tests/_torch_port.py``'s ``OP_SPECS["_np_ops"]`` runs
through both registries' ``invoke`` (neither package puts the ``_np_*``
ops in ``nd``) on the same seeded numpy inputs: outputs, their dtypes
(the reference's, which are jnp's without x64: int32 sums and indices,
float32 means), the inputs after the call and the gradients of a
random head, within the family's limit of ``TOL`` (exact for integer,
bool and index results; float sums, transcendental functions and
LAPACK within 1e-5 to 1e-4 relative); the port's differentiable cases
also against float64 finite differences.  The ``cuda`` case holds the
card against the CPU within ``CARD_TOL``.
"""
import pytest

import _torch_port as T
from _torch_port import cuda_device  # noqa: F401

SPECS = T.OP_SPECS["_np_ops"]
# finite differences run in float64: a case that casts to float32
# (``dtype=``) would lose half the digits
FD = [sp for sp in SPECS if "dtype" not in sp.attrs and T.fd_case(sp)]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_against_reference(spec):
    T.check_against_reference(spec)


@pytest.mark.parametrize("spec", FD, ids=repr)
def test_finite_differences(spec):
    T.check_finite_differences(spec)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_card_against_cpu(spec, cuda_device):
    T.check_on_card(spec)


def test_every_np_op_has_a_case():
    from mxnet_tpu_torch.ops import registry as reg
    names = {n for n in reg.list_ops() if n.startswith("_np_")}
    assert len(names) == 146
    assert names == {sp.name for sp in SPECS}


def test_the_registries_hold_the_same_names():
    """Every op name of the reference's registry is in the port's and
    no other: 586 names, the quantization and ``_np_*`` ops among
    them."""
    from mxnet_tpu.ops import registry as ref
    from mxnet_tpu_torch.ops import registry as reg
    assert set(reg.list_ops()) == set(ref.list_ops())
    assert len(reg.list_ops()) == 586
