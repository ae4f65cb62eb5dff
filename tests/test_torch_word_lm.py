"""MXNet's Gluon word language model (apache/mxnet
``example/gluon/word_language_model``: embedding, dropout, a 2-layer
LSTM, dropout, a decoder tied to the embedding) trained by the port
against the reference, on the CPU, at a small width: vocabulary 50,
width 16, bptt 5, batch 3.

The loop is the example's: ``SoftmaxCrossEntropyLoss`` over the
(bptt x batch) tokens, the hidden state detached between segments,
``clip_global_norm`` at 0.25 x bptt x batch on every gradient, then
``Trainer("sgd", lr 20).step(bptt x batch)``.
Three steps at dropout 0 from the same weights, the port op by op and
hybridized, against the reference op by op: the losses within 1e-6 x
(1 + |loss|), the norms the clip read within 1e-5 relative, and every
parameter within 1e-5 + 1e-4 x |ref| after the three steps (lr 20 turns
f32 rounding in the gradients into 1e-6-sized weight differences;
measured worst: losses 0, norms 1.1e-7, parameters 9.0e-8).  The tied
weight is one Parameter: listed once by ``collect_params``, updated once
a step, under two structural names in a checkpoint.  At dropout 0.5 the
hybridized port equals the port op by op, bit for bit, from one seed.

The ``cuda`` tests (skipped without a card) run the same loop on the
card: hybridized (one CUDA graph for the forward and one for the
backward) bit for bit against op by op at dropout 0 and 0.5, and the
losses within 1e-5 of the CPU's.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as P
from mxnet_tpu_torch.convert import set_block_params
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

V, E, L, T, B = 50, 16, 2, 5, 3
STEPS = 3


def word_lm(mx, dropout):
    """The example's ``RNNModel`` (``--tied``), in package ``mx``."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class RNNModel(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(V, E)
                self.rnn = rnn.LSTM(E, L, dropout=dropout, input_size=E)
                self.decoder = nn.Dense(V, flatten=False, in_units=E,
                                        params=self.encoder.params)

        def hybrid_forward(self, F, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            return self.decoder(self.drop(output)), hidden

    return RNNModel()


def tokens(seed=0):
    """STEPS segments of (bptt + 1) x batch token ids."""
    return np.random.RandomState(seed).randint(0, V, (STEPS, T + 1, B)) \
        .astype(np.float32)


def reference_weights():
    net = word_lm(R, 0.0)
    net.initialize(R.initializer.Uniform(0.1))
    net(R.nd.array(tokens()[0, :T]), net.rnn.begin_state(B))
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def train(mx, weights, dropout=0.0, hybridize=False, ctx=None, seed=None):
    """STEPS steps of the example's loop: (losses, clip norms, the
    parameters by structural name after them)."""
    kw = {} if mx is R else {"ctx": ctx or P.cpu()}
    net = word_lm(mx, dropout)
    names = net._collect_params_with_prefix()
    if mx is R:
        net.initialize()
        for k, p in names.items():
            p.set_data(R.nd.array(weights[k]))
    else:
        set_block_params(net, weights, ctx=kw["ctx"])
    if hybridize:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 20})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = list(net.collect_params().values())
    if seed is not None:
        mx.random.seed(seed)
    hidden = net.rnn.begin_state(B, **kw)
    losses, norms = [], []
    for seg in tokens():
        x, y = mx.nd.array(seg[:T], **kw), mx.nd.array(seg[1:], **kw)
        hidden = [h.detach() for h in hidden]
        with mx.autograd.record():
            out, hidden = net(x, hidden)
            loss = loss_fn(out.reshape((T * B, V)), y.reshape((T * B,)))
        loss.backward()
        norms.append(mx.gluon.utils.clip_global_norm(
            [p.grad() for p in params], 0.25 * T * B))
        trainer.step(T * B)
        losses.append(float(loss.mean().asscalar()))
    return losses, norms, {k: v.data().asnumpy() for k, v in names.items()}


@pytest.fixture(scope="module")
def reference_run():
    w = reference_weights()
    return w, train(R, w)


@pytest.mark.parametrize("hybridize", [False, True])
def test_training_matches_the_reference(reference_run, hybridize):
    w, (r_losses, r_norms, r_params) = reference_run
    losses, norms, params = train(P, w, hybridize=hybridize)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(norms, r_norms, rtol=1e-5)
    assert set(params) == set(r_params) == {
        "encoder.weight", "decoder.weight", "decoder.bias",
        "rnn.parameters"}
    for k in r_params:
        np.testing.assert_allclose(params[k], r_params[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(params["encoder.weight"],
                                  params["decoder.weight"])


def test_the_tied_weight_is_one_parameter():
    net = word_lm(P, 0.0)
    assert net.decoder.weight is net.encoder.weight
    params = net.collect_params()
    assert [p.name for p in params.values()].count(
        net.encoder.weight.name) == 1
    assert len(params) == 3
    structural = net._collect_params_with_prefix()
    assert structural["decoder.weight"] is structural["encoder.weight"]
    net.initialize(P.initializer.Uniform(0.1), ctx=P.cpu())
    trainer = P.gluon.Trainer(params, "sgd", {"learning_rate": 1.0})
    assert len(trainer._params) == 3
    w = {k: v.data().asnumpy() for k, v in structural.items()}
    set_block_params(net, w)
    w["decoder.weight"] = w["decoder.weight"] + 1.0
    with pytest.raises(ValueError, match="shared Parameter"):
        set_block_params(net, w)


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """A reference ``save_parameters`` file of the tied model (both
    names of the tied weight in it) loads into the port and gives the
    reference's output."""
    net = word_lm(R, 0.0)
    net.initialize(R.initializer.Uniform(0.1))
    x = tokens()[0, :T]
    want, _ = net(R.nd.array(x), net.rnn.begin_state(B))
    fname = str(tmp_path / "word_lm.params")
    net.save_parameters(fname)
    port = word_lm(P, 0.0)
    port.load_parameters(fname, ctx=P.cpu())
    got, _ = port(P.nd.array(x, ctx=P.cpu()),
                  port.rnn.begin_state(B, ctx=P.cpu()))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_hybridized_dropout_equals_op_by_op(reference_run):
    w, _ = reference_run
    eager = train(P, w, dropout=0.5, seed=3)
    hyb = train(P, w, dropout=0.5, hybridize=True, seed=3)
    assert eager[0] == hyb[0] and eager[1] == hyb[1]
    for k in eager[2]:
        np.testing.assert_array_equal(hyb[2][k], eager[2][k])
    plain = train(P, w, seed=3)
    assert plain[0] != eager[0]               # the masks did act


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_card_captured_equals_eager(dropout, cuda_device):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    net = word_lm(P, 0.0)
    net.initialize(P.initializer.Uniform(0.1), ctx=P.cpu())
    net(P.nd.array(tokens()[0, :T], ctx=P.cpu()),
        net.rnn.begin_state(B, ctx=P.cpu()))
    w = {k: v.data().asnumpy()
         for k, v in net._collect_params_with_prefix().items()}
    eager = train(P, w, dropout, ctx=P.gpu(0), seed=1)
    hyb = train(P, w, dropout, hybridize=True, ctx=P.gpu(0), seed=1)
    assert eager[0] == hyb[0] and eager[1] == hyb[1]
    for k in eager[2]:
        np.testing.assert_array_equal(hyb[2][k], eager[2][k])
    if dropout == 0.0:
        cpu = train(P, w)
        np.testing.assert_allclose(eager[0], cpu[0], rtol=1e-5, atol=1e-5)
