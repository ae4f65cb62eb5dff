"""Port parity: Inception v3 against ``mxnet_tpu``.

``inceptionv3`` at 299 x 299, batch 1 (its ``AvgPool2D(8)`` fixes the
size), through ``_torch_zoo.family_parity`` with ``train_tol=1e-4``
and the SGD step on BatchNorm's running statistics, as MobileNet v2
(94 BatchNorms at batch 1; see ``_torch_zoo``).  The state after the
step is held at 2e-6: one of the 320 ``beta`` of the E1 block's
branch moved 1.85e-6 more in one package than in the other (its
gradient sums 8 x 8 positions of a 2048-channel block; f32 order).
"""
from _torch_zoo import CLASSES, family_parity


def test_inception_v3_matches_reference():
    family_parity(lambda pkg: pkg.gluon.model_zoo.vision.get_model(
        "inceptionv3", classes=CLASSES), 1, 299, train_tol=1e-4,
        step_train=False, state_tol=2e-6)
