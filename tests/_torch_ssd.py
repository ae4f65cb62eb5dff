"""The SSD of ``examples/ssd_detection.py`` driven through a package's
MXNet API: its synthetic images, its ``SSDHead`` (written here with the
port's Gluon), its anchors, one training step (``MultiBoxTarget``,
softmax cross-entropy and smooth L1, ``Trainer.step``), its decode
(``MultiBoxDetection`` with NMS) and its evaluation (mean IoU and class
accuracy of each image's top detection).

Shared by ``tests/test_torch_ssd.py`` and ``chip_smoke.py``'s
``detection`` phase.  Imports no JAX: the step, decode and evaluation
take the package (``mxnet_tpu_torch`` or, in the CPU tests, the
reference) as an argument.
"""
import numpy as np

N_CLASSES = 2           # red box, green box
SIZES = (0.55, 0.4, 0.3)
RATIOS = (1.0, 1.6)
FEAT = 4                # the backbone's output side at 32 x 32
BATCH = 32
LR = 2e-3
EPOCHS = 40
EVAL_BATCH = 16


def make_batch(rng, n, size=32):
    """The example's draw: images with one axis-aligned rectangle (class
    = colour channel) on a noisy background; numpy (x, labels)."""
    x = rng.uniform(0, 0.15, (n, 3, size, size)).astype("float32")
    labels = np.zeros((n, 1, 5), dtype="float32")
    for i in range(n):
        cls = rng.randint(0, N_CLASSES)
        w, h = rng.randint(10, 18, 2)
        x0, y0 = rng.randint(0, size - w), rng.randint(0, size - h)
        x[i, cls, y0:y0 + h, x0:x0 + w] += 0.8
        labels[i, 0] = [cls, x0 / size, y0 / size,
                        (x0 + w) / size, (y0 + h) / size]
    return x, labels


def ssd_head(mx, n_anchors):
    """The example's ``SSDHead`` (conv backbone + per-anchor class and
    box predictors) in package ``mx``."""
    nn = mx.gluon.nn

    class SSDHead(mx.gluon.HybridBlock):
        def __init__(self, n_anchors):
            super().__init__()
            self.n_anchors = n_anchors
            with self.name_scope():
                self.backbone = nn.HybridSequential()
                for ch in (16, 32, 32):
                    self.backbone.add(
                        nn.Conv2D(ch, 3, padding=1, use_bias=False),
                        nn.BatchNorm(), nn.Activation("relu"),
                        nn.MaxPool2D(2))
                self.cls = nn.Dense(n_anchors * (N_CLASSES + 1))
                self.loc = nn.Dense(n_anchors * 4)

        def hybrid_forward(self, F, x):
            h = self.backbone(x)
            return (self.cls(h).reshape((0, N_CLASSES + 1, self.n_anchors)),
                    self.loc(h))

    return SSDHead(n_anchors)


def anchors(mx, ctx):
    """The example's anchors: (1, 64, 4) over the 4 x 4 feature map."""
    feat = mx.nd.zeros((1, 1, FEAT, FEAT), ctx=ctx)
    return mx.nd.MultiBoxPrior(feat, sizes=SIZES, ratios=RATIOS, clip=True)


def trainer(mx, net, lr=LR):
    return mx.gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})


def train_step(mx, net, tr, anc, x, labels):
    """One step of the example's loop on NDArrays ``x``/``labels``:
    (cls_loss, loc_loss) NDArrays."""
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss(axis=1)
    bs = x.shape[0]
    with mx.autograd.record():
        cls_pred, loc_pred = net(x)
        loc_t, loc_m, cls_t = mx.nd.MultiBoxTarget(anc, labels, cls_pred)
        cls_loss = ce(cls_pred, cls_t).mean()
        loc_loss = mx.nd.smooth_l1((loc_pred - loc_t) * loc_m,
                                   scalar=1.0).sum() / bs
        L = cls_loss + loc_loss
    L.backward()
    tr.step(bs)
    return cls_loss, loc_loss


def decode(mx, net, anc, x):
    """The example's decode: per-class NMS over the softmaxed classes ->
    (B, A, 6) numpy rows [class_id, score, x0, y0, x1, y1]."""
    cls_pred, loc_pred = net(x)
    return mx.nd.MultiBoxDetection(mx.nd.softmax(cls_pred, axis=1),
                                   loc_pred, anc,
                                   nms_threshold=0.45).asnumpy()


def evaluate(dets, gts):
    """The example's score: (mean IoU of each image's top kept
    detection against its box, class accuracy of that detection)."""
    ious, hits = [], 0
    for i in range(len(dets)):
        kept = dets[i][dets[i][:, 0] >= 0]
        if not len(kept):
            ious.append(0.0)
            continue
        best = kept[np.argmax(kept[:, 1])]
        gt = gts[i, 0]
        x0 = max(best[2], gt[1])
        y0 = max(best[3], gt[2])
        x1 = min(best[4], gt[3])
        y1 = min(best[5], gt[4])
        inter = max(x1 - x0, 0) * max(y1 - y0, 0)
        union = ((best[4] - best[2]) * (best[5] - best[3])
                 + (gt[3] - gt[1]) * (gt[4] - gt[2]) - inter)
        ious.append(inter / union if union > 0 else 0.0)
        hits += int(best[0] == gt[0])
    return float(np.mean(ious)), hits / len(dets)


def params_of(net):
    """Every parameter (running statistics included) by structural
    name, as numpy."""
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def ssd_symbol(mx):
    """The SSD target and decode ops as one symbol of package ``mx``:
    anchors of a feature map, ``MultiBoxTarget`` (with hard-negative
    mining) and ``MultiBoxDetection``; outputs loc_target, loc_mask,
    cls_target and the detections."""
    sym = mx.sym
    feat, cls_pred = sym.Variable("feat"), sym.Variable("cls_pred")
    loc_pred, label = sym.Variable("loc_pred"), sym.Variable("label")
    anc = sym.MultiBoxPrior(feat, sizes=(0.5, 0.3), ratios=(1.0, 2.0),
                            clip=True)
    tgt = sym.MultiBoxTarget(anc, label, cls_pred,
                             negative_mining_ratio=3.0)
    det = sym.MultiBoxDetection(sym.softmax(cls_pred, axis=1), loc_pred,
                                anc, nms_threshold=0.45)
    return sym.Group([tgt[0], tgt[1], tgt[2], det])


def ssd_symbol_inputs(seed=7, B=2, side=4):
    """Numpy inputs of :func:`ssd_symbol`: a side x side feature map
    (3 anchors a cell), 3 label rows an image (the last padded)."""
    rng = np.random.RandomState(seed)
    A = side * side * 3
    xy = rng.uniform(0, 0.5, (B, 3, 2))
    wh = rng.uniform(0.1, 0.4, (B, 3, 2))
    lab = np.concatenate([rng.randint(0, 2, (B, 3, 1)), xy, xy + wh], 2)
    lab[:, 2, 0] = -1
    return {"feat": np.zeros((B, 8, side, side), "float32"),
            "cls_pred": rng.randn(B, 3, A).astype("float32"),
            "loc_pred": (rng.randn(B, 4 * A) * 0.1).astype("float32"),
            "label": lab.astype("float32")}
