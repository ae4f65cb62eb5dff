"""The port's Module API (``mxnet_tpu_torch/module/``, ``model.py``,
``callback.py``) against the reference's, on the CPU.

* ``Module``: both packages load the same reference-exported thumbnail
  ResNet-18 v1 (``-symbol.json`` and ``.params``, the port's weights
  carried by ``convert.from_mx_params``), wrap it in ``SoftmaxOutput``
  (the gradient the batch mean) and run 3 SGD steps (lr 0.01, momentum
  0.9) on one batch of 4 x 3 x 32 x 32, tests/test_torch_gluon.py's
  Trainer case.  The first step's outputs (the same weights) agree
  within 2e-6 (measured 5.5e-7).  After an update the reference's
  jitted executor (XLA reorders the f32 sums of the whole forward and
  backward) and the port's op-by-op one part by f32 rounding, and this
  backward amplifies rounding: a relative change of 1e-7 in the weights
  moves the second step's gradients by up to 28% in some tensors
  (measured on the port).  So the later outputs are held within 1e-3,
  the mean losses within 1e-4 (of about 2 to 3, then 0.04 to 0.1) and
  each parameter and running statistic within 2e-3 x (1 + its largest
  |value|) after each step (measured over six initial draws: at most
  1.7e-4, 2.6e-5 and 6e-4);
* ``fit`` with ``do_checkpoint``, then ``Module.load`` and ``score``: the
  loaded module scores exactly as the live one, and a checkpoint written
  by either package loads in the other to the same values (exactly);
  the optimizer states saved by one load in the other;
* ``BucketingModule``: examples/nmt_bucketing.py's loop for 10 batches in
  both packages from the reference's initial weights: outputs and
  parameters within rtol 1e-5, atol 1e-6 (measured: 6e-8), and
  ``_buckets`` is ``{8, 16, 24}``; tests/test_symbol_module.py's
  bucketing case.

The ``cuda`` test (skipped without a card) runs the NMT loop with the
buckets in a shuffled order through executors replaying their CUDA
graphs and through the same loop with ``_eager``: parameters and outputs
bit for bit (each bucket's graphs have a memory pool of their own).
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as P
from mxnet_tpu_torch.convert import from_mx_params

from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

B, HW = 4, 32
# examples/nmt_bucketing.py's buckets and vocabulary (held equal to the
# example's in test_bucketing_module_nmt_matches_the_reference)
BUCKETS, VOCAB = (8, 16, 24), 32


def nmt_example():
    """examples/nmt_bucketing.py, which imports the reference."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import nmt_bucketing
    return nmt_bucketing


def _nd(mx, a, ctx=None):
    return mx.nd.array(a, ctx=ctx or mx.cpu()) if mx is P else \
        mx.nd.array(a)


@pytest.fixture(scope="module")
def resnet18(tmp_path_factory):
    """A thumbnail ResNet-18 v1 (10 classes) exported by the reference
    after a recorded forward (running statistics moved): its prefix."""
    tmp = tmp_path_factory.mktemp("r18")
    np.random.seed(0)
    with R.name.NameManager():
        net = R.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                   thumbnail=True,
                                                   prefix="net_")
        net.initialize(R.initializer.Xavier())
        x = np.random.RandomState(1).randn(B, 3, HW, HW).astype(np.float32)
        with R.autograd.record():
            net(R.nd.array(x))
        prefix = str(tmp / "resnet18")
        net.export(prefix)
    return prefix


def _module(mx, prefix, args, aux, batch=B, **opt):
    head = mx.sym.SoftmaxOutput(mx.sym.load(prefix + "-symbol.json"),
                                normalization="batch", name="softmax")
    mod = mx.mod.Module(head, context=mx.cpu())
    mod.bind(data_shapes=[("data", (batch, 3, HW, HW))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        {"learning_rate": 0.01, "momentum": 0.9}, **opt))
    return mod


def _batches(n, seed=2, batch=B):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 3, HW, HW).astype(np.float32),
             rng.randint(0, 10, batch).astype(np.float32))
            for _ in range(n)]


def test_module_resnet18_three_steps(resnet18):
    r_args, r_aux = R.model.load_params(resnet18 + "-0000.params")
    p_args, p_aux = from_mx_params(r_args, r_aux, ctx=P.cpu())
    mods = {R: _module(R, resnet18, r_args, r_aux),
            P: _module(P, resnet18, p_args, p_aux)}
    x, y = _batches(1)[0]
    for step in range(3):
        outs = {}
        for mx, mod in mods.items():
            mod.forward_backward(mx.io.DataBatch(data=[_nd(mx, x)],
                                                 label=[_nd(mx, y)]))
            mod.update()
            outs[mx] = mod.get_outputs()[0].asnumpy()
        np.testing.assert_allclose(outs[P], outs[R], rtol=0,
                                   atol=2e-6 if step == 0 else 1e-3)
        losses = [-np.log(outs[mx][np.arange(B), y.astype(int)]).mean()
                  for mx in (R, P)]
        assert abs(losses[0] - losses[1]) <= 1e-4, losses
        (ra, rx), (pa, px) = mods[R].get_params(), mods[P].get_params()
        assert sorted(pa) == sorted(ra) and sorted(px) == sorted(rx)
        for got, want in ((pa, ra), (px, rx)):
            for k in want:
                w = want[k].asnumpy()
                np.testing.assert_allclose(
                    got[k].asnumpy(), w, rtol=0,
                    atol=2e-3 * (1 + np.abs(w).max()), err_msg=k)
    assert losses[1] < 0.5      # it learns the batch
    assert mods[P].output_shapes == mods[R].output_shapes
    assert [g.shape for g in mods[P].get_input_grads()] == \
        [g.shape for g in mods[R].get_input_grads()]


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax", normalization="batch")


def _blobs(n=64, seed=42):
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, 16) * 3
    labels = rng.randint(0, 4, n)
    xs = (centers[labels] + rng.randn(n, 16) * 0.5).astype(np.float32)
    return xs, labels.astype(np.float32)


def test_fit_checkpoint_load_score(tmp_path):
    """``fit`` (Speedometer, do_checkpoint) in both packages from the same
    weights; ``Module.load`` of each package's checkpoint in both
    packages scores exactly as the live module; the optimizer states
    cross over too."""
    xs, ys = _blobs()
    with R.name.NameManager():
        rsym = _mlp(R)
    with P.name.NameManager():
        psym = _mlp(P)
    np.random.seed(0)
    rmod = R.mod.Module(rsym, context=R.cpu())
    rmod.bind([("data", (32, 16))], [("softmax_label", (32,))])
    rmod.init_params(initializer=R.initializer.Xavier())
    init = rmod.get_params()
    prefixes = {"ref": str(tmp_path / "r"), "port": str(tmp_path / "p")}
    live = {}
    with P.cpu():
        for name, mx, sym in (("ref", R, rsym), ("port", P, psym)):
            it = mx.io.NDArrayIter(xs, ys, batch_size=32)
            mod = mx.mod.Module(sym, context=mx.cpu())
            args, aux = init if mx is R else from_mx_params(*init,
                                                            ctx=P.cpu())
            speed = mx.callback.Speedometer(32, frequent=1)
            mod.fit(it, num_epoch=2, arg_params=args, aux_params=aux,
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9},
                    batch_end_callback=speed,
                    epoch_end_callback=mx.callback.do_checkpoint(
                        prefixes[name]))
            live[name] = (mod, mod.score(it, "acc"))
            mod.save_optimizer_states(prefixes[name] + ".states")
        np.testing.assert_allclose(live["port"][1][0][1],
                                   live["ref"][1][0][1])
        assert live["port"][1][0][1] > 0.9
        for name in live:
            for mx in (R, P):
                loaded = mx.mod.Module.load(prefixes[name], 2,
                                            context=mx.cpu())
                it = mx.io.NDArrayIter(xs, ys, batch_size=32)
                loaded.bind(it.provide_data, it.provide_label,
                            for_training=False)
                loaded.init_params()
                assert loaded.score(it, "acc") == live[name][1]
                want = live[name][0].get_params()[0]
                got = loaded.get_params()[0]
                for k in want:
                    np.testing.assert_array_equal(got[k].asnumpy(),
                                                  want[k].asnumpy())
        # the momentum traces saved by the reference load in the port
        pmod = live["port"][0]
        pmod.load_optimizer_states(prefixes["ref"] + ".states")
        rstates = live["ref"][0]._opt_states
        for k, st in pmod._opt_states.items():
            np.testing.assert_array_equal(st.asnumpy(),
                                          rstates[k].asnumpy())
        # predict merges the batches, dropping the last batch's padding
        it = P.io.NDArrayIter(xs[:40], ys[:40], batch_size=32)
        assert pmod.predict(it).shape == (40, 4)


def nmt_port_sym_gen(seq_len):
    """examples/nmt_bucketing.py's ``sym_gen`` over the port."""
    data = P.sym.Variable("data")
    emb = P.sym.Embedding(data, input_dim=VOCAB, output_dim=16,
                          name="emb")
    fc = P.sym.FullyConnected(emb, num_hidden=VOCAB,
                              flatten=False, name="fc")
    out = P.sym.SoftmaxOutput(fc, preserve_shape=True,
                              normalization="valid", name="softmax")
    return out, ("data",), ("softmax_label",)


def nmt_batches(n, seed=0, order=None):
    """examples/nmt_bucketing.py's ``BucketIter`` batches as numpy
    (bucket, data, label), reordered by ``order`` if given."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        L = int(rng.choice(BUCKETS))
        data = rng.randint(0, VOCAB, (32, L))
        out.append((L, data.astype(np.float32),
                    ((data + 1) % VOCAB).astype(np.float32)))
    return out if order is None else [out[i] for i in order]


def nmt_run(mx, sym_gen, ctx, batches, params=None, eager=False):
    """The example's training loop over ``batches``: (module, outputs,
    accuracy, BLEU, initial params)."""
    bm = mx.mod.BucketingModule(sym_gen, default_bucket_key=24,
                                context=ctx)
    bm.bind(data_shapes=[("data", (32, 24))],
            label_shapes=[("softmax_label", (32,))])
    if params is None:
        np.random.seed(0)
        bm.init_params(initializer=mx.initializer.Xavier())
    else:
        bm.init_params(arg_params=params[0], aux_params=params[1])
    init = bm.get_params()
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.5})
    if eager:
        for L in BUCKETS:
            bm.switch_bucket(L, [("data", (32, L))],
                             [("softmax_label", (32, L))])
            bm._curr_module._exec._eager = True
    metric = mx.metric.Accuracy(axis=2)
    bleu = mx.metric.BLEU(smooth=True)
    outs = []
    for L, d, l in batches:
        batch = mx.io.DataBatch(
            data=[_nd(mx, d, ctx)], label=[_nd(mx, l, ctx)], bucket_key=L,
            provide_data=[("data", (32, L))],
            provide_label=[("softmax_label", (32, L))])
        bm.forward(batch, is_train=True)
        bm.backward()
        bm.update()
        metric.update(batch.label[0], bm.get_outputs()[0])
        bleu.update(batch.label[0], bm.get_outputs()[0])
        outs.append(bm.get_outputs()[0].asnumpy())
    return bm, outs, metric.get()[1], bleu.get()[1], init


def test_bucketing_module_nmt_matches_the_reference():
    example = nmt_example()
    assert (BUCKETS, VOCAB) == (example.BUCKETS, example.VOCAB)
    batches = nmt_batches(10)
    rbm, routs, racc, rbleu, init = nmt_run(R, example.sym_gen,
                                            R.cpu(), batches)
    pbm, pouts, pacc, pbleu, _ = nmt_run(
        P, nmt_port_sym_gen, P.cpu(), batches,
        params=from_mx_params(*init, ctx=P.cpu()))
    assert set(pbm._buckets) == set(rbm._buckets) == {8, 16, 24}
    for got, want in zip(pouts, routs):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert pacc == racc and pbleu == rbleu
    want = rbm._curr_module.get_params()[0]
    got = pbm.get_params()[0]
    for k in want:
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6)
    # every bucket reads the default bucket's parameter arrays
    master = pbm._buckets[24]._exec.arg_dict["fc_weight"]
    assert all(m._exec.arg_dict["fc_weight"] is master
               for m in pbm._buckets.values())


def test_bucketing_module_reference_case():
    """tests/test_symbol_module.py::test_bucketing_module's twin."""
    def sym_gen(seq_len):
        data = P.sym.Variable("data")
        fc = P.sym.FullyConnected(data, num_hidden=8, name="fc",
                                  flatten=False)
        fc = P.sym.mean(fc, axis=1)
        out = P.sym.SoftmaxOutput(fc, name="softmax")
        return out, ("data",), ("softmax_label",)

    bm = P.mod.BucketingModule(sym_gen, default_bucket_key=16,
                               context=P.cpu())
    bm.bind(data_shapes=[("data", (4, 16, 8))],
            label_shapes=[("softmax_label", (4,))])
    bm.init_params(initializer=P.initializer.Xavier())
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    for L in (16, 8, 16, 12):
        batch = P.io.DataBatch(
            data=[_nd(P, rng.randn(4, L, 8).astype(np.float32))],
            label=[_nd(P, rng.randint(0, 8, 4).astype(np.float32))],
            bucket_key=L, provide_data=[("data", (4, L, 8))],
            provide_label=[("softmax_label", (4,))])
        bm.forward(batch, is_train=True)
        bm.backward()
        bm.update()
    assert set(bm._buckets) == {16, 8, 12}
    assert bm.get_outputs()[0].shape == (4, 8)


@pytest.mark.cuda
def test_bucketing_captured_in_random_order_equals_eager(cuda_device):
    """The NMT loop with its batches shuffled (buckets replayed in an
    order other than their capture order) through captured executors
    and through ``_eager`` ones, from the same weights: every output and
    the parameters bit for bit."""
    order = np.random.RandomState(3).permutation(20)
    batches = nmt_batches(20, order=order)
    runs = [nmt_run(P, nmt_port_sym_gen, P.gpu(0), batches, eager=eager)
            for eager in (True, False)]
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)
    pa, pb = (r[0].get_params()[0] for r in runs)
    for k in pa:
        np.testing.assert_array_equal(pa[k].asnumpy(), pb[k].asnumpy())
    assert all(len(m._exec._programs) == 1
               for m in runs[1][0]._buckets.values())
