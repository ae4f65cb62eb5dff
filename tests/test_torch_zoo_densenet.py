"""Port parity: the DenseNet family against ``mxnet_tpu``.

``densenet121`` itself is held in predict mode at 224 x 224, batch 1
(its ``AvgPool2D(7)`` fixes the input size), the reference op by op.
The full check of ``_torch_zoo.family_parity`` (train-mode forward and
one SGD step; limits in its docstring) runs on a ``DenseNet`` of the
same class with fewer and narrower layers (16 initial features, growth
8, blocks of 1, 2, 2 and 1 layers, bottleneck 2), at the same input:
the reference's backward over all 121 layers took 60 s hybridized on
the CPU and 187 s op by op.
"""
from _torch_zoo import CLASSES, family_parity, predict_parity


def test_densenet121_predict_matches_reference():
    predict_parity(lambda pkg: pkg.gluon.model_zoo.vision.densenet121(
        classes=CLASSES), 1, 224)


def test_densenet_step_matches_reference():
    family_parity(lambda pkg: pkg.gluon.model_zoo.vision.DenseNet(
        16, 8, [1, 2, 2, 1], bn_size=2, classes=CLASSES), 1, 224)
