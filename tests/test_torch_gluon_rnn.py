"""The port's ``gluon.rnn`` (``mxnet_tpu_torch/gluon/rnn/``) against the
reference's (``mxnet_tpu/gluon/rnn/``), on the CPU.

Weights go from the reference's block to the port's by structural name
(``convert.set_block_params``), or through the reference's
``save_parameters`` file.  Limits (f32): outputs within 1e-6 + 1e-5 x
|ref|, gradients (with one random head gradient) within 4e-6 + 4e-5 x
|ref|: the recurrence's matmuls, tanh and sigmoid in each package's own
order over 5 steps (measured worst: 0.10 of the limit, 1.4e-6
absolute).

- the fused layers ``RNN``/``LSTM``/``GRU`` in TNC and NTC, with and
  without initial states, op by op and hybridized, the input width
  deferred or given, outputs, states and gradients;
- every cell's ``unroll`` (``merge_outputs`` True and False,
  ``valid_length``), the stacked, residual, bidirectional, dropout and
  zoneout cells, a hybridized cell equal to the same cell op by op;
- cells equal to the fused layer whose flat vector packs their
  ``i2h``/``h2h`` weights and biases (2 layers stacked, one layer
  bidirectional), within 1e-5 (the cell adds its two biased projections,
  the fused op the projection and then each bias; measured worst
  1.5e-7);
- a reference ``save_parameters`` file loaded by the port;
- the twin of ``tests/test_api_longtail.py:151``
  (``VariationalDropoutCell``'s mask fixed per sequence).

The ``cuda`` tests (skipped without a card) hold each layer on the card
against the CPU and its hybridized CUDA graphs bit for bit against the
same layer run op by op.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as P
from mxnet_tpu_torch.convert import set_block_params
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=4e-5, atol=4e-6)
TN, N, I, H = 5, 3, 4, 6


def kw(mx, ctx=None):
    return {"ctx": ctx or P.cpu()} if mx is P else {}


def arr(mx, a, ctx=None):
    return mx.nd.array(np.asarray(a, np.float32), **kw(mx, ctx))


def weights_of(block):
    return {k: v.data().asnumpy()
            for k, v in block._collect_params_with_prefix().items()}


def port_twin(ref_block, make, ctx=None):
    """The port's block from ``make(P)`` with ``ref_block``'s weights."""
    block = make(P)
    set_block_params(block, weights_of(ref_block), ctx=ctx or P.cpu())
    return block


def layer(kind, layout, input_size, bi=False, L=2):
    def make(mx):
        cls = {"lstm": mx.gluon.rnn.LSTM, "gru": mx.gluon.rnn.GRU,
               "rnn_relu": mx.gluon.rnn.RNN, "rnn_tanh": mx.gluon.rnn.RNN}
        extra = {"activation": kind[4:]} if kind.startswith("rnn") else {}
        return cls[kind](H, L, layout=layout, bidirectional=bi,
                         input_size=input_size, **extra)
    return make


def run_layer(mx, net, x_np, states_np, heads, ctx=None):
    """(outputs, gradients of x, the states and the parameters)."""
    x = arr(mx, x_np, ctx)
    x.attach_grad()
    args = [x]
    states = None
    if states_np is not None:
        states = [arr(mx, s, ctx) for s in states_np]
        for s in states:
            s.attach_grad()
        args.append(states)
    with mx.autograd.record():
        res = net(*args)
        outs = [res[0]] + list(res[1]) if states is not None else [res]
        loss = sum((o * arr(mx, h, ctx)).sum() for o, h in zip(outs, heads))
    loss.backward()
    grads = [x.grad] + ([s.grad for s in states] if states else [])
    grads += [p.grad() for p in net.collect_params().values()]
    return [o.asnumpy() for o in outs], [g.asnumpy() for g in grads]


LAYER_CASES = [("lstm", "TNC", True, False, True), ("lstm", "NTC", False,
                                                     True, True),
               ("gru", "NTC", True, True, False), ("gru", "TNC", False,
                                                   False, True),
               ("rnn_relu", "TNC", True, True, True),
               ("rnn_tanh", "NTC", False, False, False)]


def layer_inputs(kind, layout, with_states, bi, seed=0):
    rng = np.random.RandomState(seed)
    D = 2 if bi else 1
    shape = (TN, N, I) if layout == "TNC" else (N, TN, I)
    x = rng.randn(*shape).astype(np.float32)
    n_states = 2 if kind == "lstm" else 1
    states = [rng.randn(2 * D, N, H).astype(np.float32) * 0.5
              for _ in range(n_states)] if with_states else None
    out_shape = (TN, N, H * D) if layout == "TNC" else (N, TN, H * D)
    heads = [rng.randn(*out_shape).astype(np.float32)] + \
        ([rng.randn(2 * D, N, H).astype(np.float32)
          for _ in range(n_states)] if with_states else [])
    return x, states, heads


@pytest.mark.parametrize("kind,layout,with_states,hybridize,bi",
                         LAYER_CASES)
def test_layer_matches_the_reference(kind, layout, with_states, hybridize,
                                     bi):
    x, states, heads = layer_inputs(kind, layout, with_states, bi)
    make = layer(kind, layout, 0 if hybridize else I, bi)
    ref = make(R)
    ref.initialize(R.initializer.Uniform(0.5))
    ref(arr(R, x))                          # finish deferred shapes
    port = port_twin(ref, make)
    for net in (ref, port):
        if hybridize:
            net.hybridize()
    r_outs, r_grads = run_layer(R, ref, x, states, heads)
    p_outs, p_grads = run_layer(P, port, x, states, heads)
    assert len(p_outs) == len(r_outs)
    for p, r in zip(p_outs, r_outs):
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, **OUT_TOL)
    for p, r in zip(p_grads, r_grads):
        np.testing.assert_allclose(p, r, **GRAD_TOL)


def test_layer_defers_its_input_width_and_begins_on_the_input_device():
    net = P.gluon.rnn.LSTM(H, 2, input_size=0)
    assert net.parameters.shape == (0,)
    net.initialize(P.initializer.Uniform(0.1), ctx=P.cpu())
    states = net.begin_state(N, ctx=P.cpu())
    assert [s.shape for s in states] == [(2, N, H)] * 2
    out, new = net(arr(P, np.ones((TN, N, I))), states)
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    assert net.parameters.shape == (rnn_param_size("lstm", 2, I, H),)
    assert out.shape == (TN, N, H) and len(new) == 2
    assert out.context == P.cpu()
    assert repr(net) == "LSTM(4 -> 6, TNC)"


def cell_makers(mx):
    rnn = mx.gluon.rnn

    def stacked():
        seq = rnn.SequentialRNNCell()
        seq.add(rnn.LSTMCell(H, input_size=I))
        seq.add(rnn.ResidualCell(rnn.GRUCell(H, input_size=H)))
        seq.add(rnn.DropoutCell(0.0))
        return seq

    return {"rnn": lambda: rnn.RNNCell(H, input_size=I),
            "rnn_relu": lambda: rnn.RNNCell(H, activation="relu"),
            "lstm": lambda: rnn.LSTMCell(H, input_size=I),
            "gru": lambda: rnn.GRUCell(H),
            "stacked": stacked,
            "bidirectional": lambda: rnn.BidirectionalCell(
                rnn.LSTMCell(H, input_size=I), rnn.GRUCell(H, input_size=I)),
            "zoneout_off": lambda: rnn.ZoneoutCell(rnn.LSTMCell(H))}


def run_unroll(mx, cell, x_np, layout, merge, valid, heads):
    x = arr(mx, x_np)
    x.attach_grad()
    vl = None if valid is None else arr(mx, valid)
    with mx.autograd.record():
        out, states = cell.unroll(TN, x, layout=layout, merge_outputs=merge,
                                  valid_length=vl)
        outs = list(out) if merge is False else [out]
        loss = sum((o * arr(mx, h)).sum() for o, h in zip(outs, heads))
        loss = loss + sum(s.sum() for s in states)
    loss.backward()
    grads = [x.grad] + [p.grad() for p in cell.collect_params().values()]
    return ([o.asnumpy() for o in outs + list(states)],
            [g.asnumpy() for g in grads])


UNROLL_CASES = [("rnn", "NTC", None), ("rnn_relu", "TNC", False),
                ("lstm", "NTC", True), ("gru", "TNC", None),
                ("stacked", "NTC", False), ("bidirectional", "TNC", None),
                ("bidirectional", "NTC", None), ("zoneout_off", "NTC", None)]


def cell_pair(name, x, layout):
    """The reference's cell (weights drawn, shapes finished) and the
    port's twin."""
    ref = cell_makers(R)[name]()
    ref.initialize(R.initializer.Uniform(0.5))
    ref.unroll(TN, arr(R, x), layout=layout)      # finish deferred shapes
    return ref, port_twin(ref, lambda mx: cell_makers(mx)[name]())


@pytest.mark.parametrize("name,layout,merge", UNROLL_CASES)
def test_cell_unroll_matches_the_reference(name, layout, merge):
    valid = None
    rng = np.random.RandomState(1)
    x = rng.randn(*((N, TN, I) if layout == "NTC" else (TN, N, I))) \
        .astype(np.float32)
    ref, port = cell_pair(name, x, layout)
    D = 2 if name == "bidirectional" else 1
    step = (N, H * D)
    out_shape = (N, TN, H * D) if layout == "NTC" else (TN, N, H * D)
    heads = [rng.randn(*step).astype(np.float32) for _ in range(TN)] \
        if merge is False else [rng.randn(*out_shape).astype(np.float32)]
    r_outs, r_grads = run_unroll(R, ref, x, layout, merge, valid, heads)
    p_outs, p_grads = run_unroll(P, port, x, layout, merge, valid, heads)
    assert len(p_outs) == len(r_outs)
    for p, r in zip(p_outs, r_outs):
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, **OUT_TOL)
    for p, r in zip(p_grads, r_grads):
        np.testing.assert_allclose(p, r, **GRAD_TOL)


@pytest.mark.parametrize("name,merge", [("lstm", None), ("gru", False),
                                        ("stacked", None)])
def test_unroll_valid_length(name, merge):
    """``valid_length`` [5, 3, 1]: outputs past each sequence's end are
    zeros and its states are those of its last valid step.  The
    reference's ``unroll`` cannot run with ``valid_length`` (ROADMAP
    §C), so the expectation is the reference's cell stepped one input
    at a time."""
    valid = [5, 3, 1]
    x = np.random.RandomState(6).randn(N, TN, I).astype(np.float32)
    ref, port = cell_pair(name, x, "NTC")
    states = ref.begin_state(N)
    outs, per_step = [], []
    for t in range(TN):
        o, states = ref(arr(R, x[:, t]), states)
        outs.append(o.asnumpy())
        per_step.append([s.asnumpy() for s in states])
    steps = np.arange(TN)[:, None, None]
    want_out = np.where(steps < np.array(valid)[None, :, None],
                        np.stack(outs), 0.0)
    want_states = [np.stack([per_step[v - 1][k][b]
                             for b, v in enumerate(valid)])
                   for k in range(len(states))]
    out, got_states = port.unroll(TN, arr(P, x), layout="NTC",
                                  merge_outputs=merge,
                                  valid_length=arr(P, valid))
    got = np.stack([o.asnumpy() for o in out]) if merge is False \
        else np.swapaxes(out.asnumpy(), 0, 1)
    np.testing.assert_allclose(got, want_out, **OUT_TOL)
    for g, w in zip(got_states, want_states):
        np.testing.assert_allclose(g.asnumpy(), w, **OUT_TOL)


def test_hybridized_cell_equals_op_by_op():
    rng = np.random.RandomState(2)
    x = arr(P, rng.randn(N, TN, I))
    cells = []
    for hybrid in (False, True):
        cell = P.gluon.rnn.LSTMCell(H, input_size=I)
        cell.initialize(P.initializer.Uniform(0.3), ctx=P.cpu())
        if cells:
            set_block_params(cell, weights_of(cells[0]))
        if hybrid:
            cell.hybridize()
        cells.append(cell)
    a, b = [c.unroll(TN, x)[0].asnumpy() for c in cells]
    np.testing.assert_array_equal(a, b)


def test_random_modifier_cells():
    """Dropout and zoneout at rate 0.5: each output element is 0 or
    twice the base cell's (dropout), or the base cell's new or previous
    output (zoneout); the base cell alone is refused once wrapped."""
    rnn = P.gluon.rnn
    x = arr(P, np.random.RandomState(3).randn(N, I))
    base = rnn.LSTMCell(H, input_size=I)
    base.initialize(P.initializer.Uniform(0.3), ctx=P.cpu())
    states = base.begin_state(N, ctx=P.cpu())
    want, _ = base(x, states)
    drop = rnn.DropoutCell(base, 0.5)
    with pytest.raises(AssertionError):
        base.begin_state(N, ctx=P.cpu())
    with P.autograd.train_mode():
        got, _ = drop(x, drop.begin_state(N, ctx=P.cpu()))
    g, w = got.asnumpy(), want.asnumpy()
    assert np.all((g == 0) | np.isclose(g, 2 * w))
    assert (g == 0).any() and (g != 0).any()

    zone = rnn.ZoneoutCell(rnn.GRUCell(H, input_size=I),
                           zoneout_outputs=0.5, zoneout_states=0.5)
    zone.initialize(P.initializer.Uniform(0.3), ctx=P.cpu())
    st = zone.begin_state(N, ctx=P.cpu())
    o1, st = zone(x, st)
    o2, _ = zone(x, st)
    new, _ = zone.base_cell(x, st)
    assert np.all(np.isclose(o2.asnumpy(), new.asnumpy())
                  | np.isclose(o2.asnumpy(), o1.asnumpy()))
    with pytest.raises(P.base.MXNetError):
        rnn.BidirectionalCell(rnn.RNNCell(H), rnn.RNNCell(H))(x, [])


PACK_CASES = [("lstm", 2, False), ("gru", 2, False), ("rnn_tanh", 2, False),
              ("lstm", 1, True), ("gru", 1, True), ("rnn_relu", 1, True)]


def cell_of(mode, input_size):
    rnn = P.gluon.rnn
    if mode == "lstm":
        return rnn.LSTMCell(H, input_size=input_size)
    if mode == "gru":
        return rnn.GRUCell(H, input_size=input_size)
    return rnn.RNNCell(H, activation=mode[4:], input_size=input_size)


def packed(cells_by_layer):
    """The fused layer's flat vector from cells [[l0d0, l0d1], ...]:
    every weight (W then R), then every bias (bW then bR)."""
    def values(*names):
        return [getattr(c, k).data().asnumpy().ravel()
                for layer_ in cells_by_layer for c in layer_ for k in names]
    return np.concatenate(values("i2h_weight", "h2h_weight")
                          + values("i2h_bias", "h2h_bias"))


def check_cells_against_fused(mode, L, bi, ctx):
    rng = np.random.RandomState(4)
    x = arr(P, rng.randn(TN, N, I), ctx)
    if bi:
        l, r = cell_of(mode, I), cell_of(mode, I)
        net = P.gluon.rnn.BidirectionalCell(l, r)
        layers = [[l, r]]
    else:
        net = P.gluon.rnn.SequentialRNNCell()
        layers = []
        for k in range(L):
            c = cell_of(mode, I if k == 0 else H)
            net.add(c)
            layers.append([c])
    net.initialize(P.initializer.Uniform(0.5), ctx=ctx)
    fused = layer(mode, "TNC", I, bi, L)(P)
    fused.initialize(ctx=ctx)
    fused.parameters.set_data(P.nd.array(packed(layers), ctx=ctx))
    want_out, want_states = net.unroll(TN, x, layout="TNC")
    got_out, got_states = fused(x, fused.begin_state(N, ctx=ctx))
    np.testing.assert_allclose(got_out.asnumpy(), want_out.asnumpy(),
                               rtol=1e-5, atol=1e-5)
    # the fused op's states are stacked (layer, direction); a cell's are
    # [h] or [h, c] per cell in order
    per = 2 if mode == "lstm" else 1
    for k, s in enumerate(got_states):
        want = np.stack([want_states[j * per + k].asnumpy()
                         for j in range(len(want_states) // per)])
        np.testing.assert_allclose(s.asnumpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,L,bi", PACK_CASES)
def test_cells_equal_the_fused_layer_with_packed_weights(mode, L, bi):
    check_cells_against_fused(mode, L, bi, P.cpu())


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    def make(mx):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.rnn.LSTM(H, 2, bidirectional=True),
                mx.gluon.rnn.GRU(5, layout="TNC"))
        return net
    x = np.random.RandomState(5).randn(TN, N, I).astype(np.float32)
    ref = make(R)
    ref.initialize(R.initializer.Uniform(0.4))
    want = ref(arr(R, x)).asnumpy()
    fname = str(tmp_path / "rnn.params")
    ref.save_parameters(fname)
    port = make(P)
    port.initialize(ctx=P.cpu())
    port.load_parameters(fname, ctx=P.cpu())
    np.testing.assert_allclose(port(arr(P, x)).asnumpy(), want, **OUT_TOL)
    again = make(P)                      # a block never run: deferred
    again.load_parameters(fname, ctx=P.cpu())
    np.testing.assert_allclose(again(arr(P, x)).asnumpy(), want, **OUT_TOL)


def test_variational_dropout_cell_mask_is_fixed_per_sequence():
    """Twin of tests/test_api_longtail.py:151."""
    rnn = P.gluon.rnn
    cell = rnn.VariationalDropoutCell(rnn.RNNCell(8), drop_outputs=0.5)
    cell.initialize(ctx=P.cpu())
    x = arr(P, np.ones((4, 6)))
    st = cell.begin_state(batch_size=4, ctx=P.cpu())
    with P.autograd.record():
        o1, st = cell(x, st)
        o2, st = cell(x, st)
    z1 = o1.asnumpy() == 0
    z2 = o2.asnumpy() == 0
    assert z1.any()
    assert (z1 == z2).all()
    cell.reset()
    o3, _ = cell(x, cell.begin_state(batch_size=4, ctx=P.cpu()))
    assert not (o3.asnumpy() == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,layout,with_states,hybridize,bi",
                         LAYER_CASES)
def test_layer_card_against_cpu(kind, layout, with_states, hybridize, bi,
                                cuda_device):
    """A layer on the card (hybridized: its CUDA graphs) against the same
    weights on the CPU, and the hybridized layer bit for bit against the
    same layer run op by op on the card."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    x, states, heads = layer_inputs(kind, layout, with_states, bi)
    make = layer(kind, layout, I, bi)
    cpu = make(P)
    cpu.initialize(P.initializer.Uniform(0.5), ctx=P.cpu())
    res = {}
    for name, ctx, hyb in (("cpu", P.cpu(), False),
                           ("card", P.gpu(0), False),
                           ("card hybridized", P.gpu(0), hybridize)):
        net = cpu if name == "cpu" else port_twin(cpu, make, ctx)
        if hyb:
            net.hybridize()
        for _ in range(2):                 # the second call replays
            res[name] = run_layer(P, net, x, states, heads, ctx)
    for k in (0, 1):
        for g, h, c in zip(res["card"][k], res["card hybridized"][k],
                           res["cpu"][k]):
            np.testing.assert_array_equal(g, h)
            np.testing.assert_allclose(g, c, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,L,bi", PACK_CASES)
def test_cells_equal_the_fused_layer_on_the_card(mode, L, bi, cuda_device):
    check_cells_against_fused(mode, L, bi, P.gpu(0))
