"""The fused ``RNN`` op (LSTM, GRU, vanilla; multi-layer, bidirectional).

Port of ``mxnet_tpu/ops/rnn_op.py``: the reference's cuDNN-canonical
flat packing (per layer, per direction, W then R; then every bias, bW
then bR; gates LSTM ``[i, f, c, o]``, GRU ``[r, z, n]``), so a
checkpoint of either package loads into the other.  Each layer and
direction projects the whole input with one matmul, then runs the
recurrence one step at a time (the reference's ``lax.scan``); the
reverse direction runs on the flipped sequence.  Inverted dropout
applies between layers only, in training.  The steps are torch ops, so
autograd differentiates the loop and a hybridized block captures it
into its CUDA graph.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


def _unpack_params(params, mode, num_layers, input_size, H, D):
    """Views of the flat parameter vector: per-layer, per-direction
    ``(W, R)`` and ``(bW, bR)``."""
    G = _GATES[mode]
    offset = 0

    def take(n, *shape):
        nonlocal offset
        v = params[offset:offset + n].view(*shape)
        offset += n
        return v

    weights = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        weights.append([(take(G * H * in_sz, G * H, in_sz),
                         take(G * H * H, G * H, H)) for _ in range(D)])
    biases = [[(take(G * H, G * H), take(G * H, G * H)) for _ in range(D)]
              for _ in range(num_layers)]
    return weights, biases


def rnn_param_size(mode, num_layers, input_size, H, bidirectional=False):
    """The packed parameter count (what ``gluon.rnn`` allocates)."""
    G = _GATES[mode]
    D = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        size += D * (G * H * in_sz + G * H * H + 2 * G * H)
    return size


def _cell_step(mode, x_proj, h, c, R, bR):
    """One time step from the hoisted input projection ``x_proj``:
    (h, c) after it."""
    if mode == "lstm":
        gates = x_proj + torch.matmul(h, R.t()) + bR
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new
    if mode == "gru":
        xr, xz, xn = x_proj.chunk(3, dim=-1)
        hr, hz, hn = (torch.matmul(h, R.t()) + bR).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    v = x_proj + torch.matmul(h, R.t()) + bR
    return (torch.tanh(v) if mode == "rnn_tanh" else torch.relu(v)), c


def _run_direction(mode, data, h0, c0, W, R, bW, bR, reverse):
    """One direction of one layer over ``data`` (T, N, I): (outputs
    (T, N, H), h_T, c_T)."""
    x = torch.flip(data, (0,)) if reverse else data
    x_proj = torch.matmul(x, W.t()) + bW
    h, c = h0, c0
    outs = []
    for t in range(x_proj.shape[0]):
        h, c = _cell_step(mode, x_proj[t], h, c, R, bR)
        outs.append(h)
    out = torch.stack(outs, 0)
    if reverse:
        out = torch.flip(out, (0,))
    return out, h, c


@register("RNN", num_outputs=-1, needs_rng=True, training_aware=True)
def rnn(gen, data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, sequence_length=None,
        use_sequence_length=False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, _training=False, **kw):
    """``data`` (T, N, I) through ``num_layers`` layers of ``mode``:
    (outputs, h_N) and, for ``lstm``, c_N.  As the reference
    (``rnn_op.py:106``): the states come back whatever
    ``state_outputs`` says, and ``sequence_length``,
    ``use_sequence_length`` and the ``lstm_state_clip_*`` bounds are
    accepted and ignored; ``projection_size`` raises.  The dropout mask
    (rate ``p``, between layers, in training) is drawn from ``gen``
    (torch's default generator of the device when None)."""
    if mode not in _GATES:
        raise MXNetError("RNN mode %r not supported" % mode)
    if projection_size:
        raise MXNetError("RNN projection_size is not implemented")
    T, N, I = data.shape
    H = state_size
    D = 2 if bidirectional else 1
    weights, biases = _unpack_params(parameters, mode, num_layers, I, H, D)
    c_states = state_cell if mode == "lstm" else torch.zeros_like(state)

    x = data
    hs_out, cs_out = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(D):
            sidx = layer * D + d
            (W, R), (bW, bR) = weights[layer][d], biases[layer][d]
            out, hT, cT = _run_direction(mode, x, state[sidx],
                                         c_states[sidx], W, R, bW, bR,
                                         reverse=d == 1)
            outs.append(out)
            hs_out.append(hT)
            cs_out.append(cT)
        x = outs[0] if D == 1 else torch.cat(outs, -1)
        if p > 0 and _training and layer < num_layers - 1:
            keep = 1.0 - p
            mask = torch.rand(x.shape, device=x.device, generator=gen) < keep
            x = torch.where(mask, x / keep, 0.0).to(x.dtype)

    hN = torch.stack(hs_out, 0)
    if mode == "lstm":
        return x, hN, torch.stack(cs_out, 0)
    return x, hN


@register("_rnn_nostate", num_outputs=-1, needs_rng=True,
          training_aware=True)
def rnn_nostate(gen, data, parameters, state_size=None, num_layers=1,
                mode="lstm", bidirectional=False, _training=False, **kw):
    """``RNN`` from all-zero initial states: the ONNX importer's target
    for a recurrent node without ``initial_h``/``initial_c``."""
    D = 2 if bidirectional else 1
    z = torch.zeros((num_layers * D, data.shape[1], state_size),
                    dtype=data.dtype, device=data.device)
    kw.pop("state_outputs", None)
    return rnn(gen, data, parameters, z, z if mode == "lstm" else None,
               state_size=state_size, num_layers=num_layers, mode=mode,
               bidirectional=bidirectional, _training=_training, **kw)
