"""The detection and vision ops of the port (``mxnet_tpu_torch/ops/
vision.py``, ``vision_ext.py``) against the reference's.

Each case of ``tests/_torch_port.py``'s ``OP_SPECS["vision"]`` and
``OP_SPECS["vision_ext"]`` goes through the reference and the port on
the CPU from the same numpy inputs (outputs, dtypes, gradients within
the case's family limit), differentiable cases also against float64
central differences, and every alias under its name.
"""
import numpy as np
import pytest

import _torch_port as T
from _torch_port import cuda_device  # noqa: F401

SPECS = T.OP_SPECS["vision"] + T.OP_SPECS["vision_ext"]
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


# ------------------------------------------------ the reference's cases --
# The port's counterparts of tests/test_vision_ops.py and
# tests/test_contrib_ext.py: each case runs in both packages on the same
# numpy inputs.  Class ids, keep decisions (a score of -1), matches and
# ranks must match exactly; boxes, scores and every other float within
# 1e-6 absolute + 1e-6 relative (the reference's jit contracts
# multiply-adds into FMAs, torch's CPU ops round each step).
EXACT_ATOL = 1e-6


def _resolve(pkg, name):
    obj = pkg.nd
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _run(pkg, name, arrays, kw, grad=()):
    """(outputs, gradients of the inputs ``grad`` under the sum of the
    first output's squares) of ``pkg.nd.<name>(*arrays, **kw)``."""
    ctx = {} if pkg.__name__ == "mxnet_tpu" else {"ctx": pkg.cpu()}
    xs = [a if not isinstance(a, np.ndarray) else
          pkg.nd.array(a, dtype=a.dtype, **ctx) for a in arrays]
    for j in grad:
        xs[j].attach_grad()
    fn = _resolve(pkg, name)
    with pkg.autograd.record():
        out = fn(*xs, **kw)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        loss = (outs[0] * outs[0]).sum() if grad else None
    if grad:
        loss.backward()
    return ([o.asnumpy() for o in outs],
            [xs[j].grad.asnumpy() for j in grad])


def both(name, arrays, kw=None, grad=(), exact=()):
    """``name`` through the reference and the port: outputs and
    gradients held to each other (the output columns ``exact`` of a
    (..., K) detection output bit for bit); returns the port's."""
    import mxnet_tpu as R
    import mxnet_tpu_torch as P
    kw = kw or {}
    want, wg = _run(R, name, arrays, kw, grad)
    got, gg = _run(P, name, arrays, kw, grad)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (name, k, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=EXACT_ATOL,
                                   err_msg="%s output %d" % (name, k))
        if exact and k == 0:
            np.testing.assert_array_equal(a[..., list(exact)],
                                          b[..., list(exact)])
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   err_msg="%s gradient" % name)
    return got, gg


def _corner(rng, shape):
    a = rng.uniform(0, 1, shape).astype("float32")
    a[..., 2:] += a[..., :2]
    return a


def case_box_iou():
    rng = np.random.RandomState(0)
    both("contrib.box_iou", [_corner(rng, (5, 4)), _corner(rng, (7, 4))])


NMS3 = np.array([[[0, 0.9, 0.0, 0.0, 1.0, 1.0],
                  [0, 0.8, 0.05, 0.05, 1.0, 1.0],
                  [0, 0.7, 2.0, 2.0, 3.0, 3.0]]], "float32")


def case_box_nms_suppresses_overlaps():
    out, _ = both("contrib.box_nms", [NMS3], dict(
        overlap_thresh=0.5, coord_start=2, score_index=1, id_index=0),
        exact=(0, 1))
    assert (out[0][0, :, 1] > 0).sum() == 2


def case_box_nms_per_class_vs_force():
    data = np.array([[[0, 0.9, 0.0, 0.0, 1.0, 1.0],
                      [1, 0.8, 0.0, 0.0, 1.0, 1.0]]], "float32")
    kw = dict(overlap_thresh=0.5, coord_start=2, score_index=1, id_index=0)
    keep, _ = both("contrib.box_nms", [data], kw, exact=(0, 1))
    sup, _ = both("contrib.box_nms", [data], dict(kw, force_suppress=True),
                  exact=(0, 1))
    assert (keep[0][0, :, 1] > 0).sum() == 2
    assert (sup[0][0, :, 1] > 0).sum() == 1


def case_multibox_prior():
    both("MultiBoxPrior", [np.zeros((1, 3, 4, 6), "float32")],
         dict(sizes=(0.5, 0.25), ratios=(1.0, 2.0)))


def case_multibox_target_assigns():
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0]]], "float32")
    label = np.array([[[2, 0.0, 0.0, 0.5, 0.5], [-1, 0, 0, 0, 0]]],
                     "float32")
    out, _ = both("MultiBoxTarget", [anchors, label,
                                     np.zeros((1, 4, 3), "float32")])
    assert out[2][0, 0] == 3


def case_multibox_detection_roundtrip():
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]]],
                       "float32")
    cls_prob = np.array([[[0.1, 0.2], [0.8, 0.1], [0.1, 0.7]]], "float32")
    out, _ = both("MultiBoxDetection", [cls_prob, np.zeros((1, 8), "float32"),
                                        anchors], exact=(0, 1))
    assert sorted(out[0][0][out[0][0][:, 0] >= 0][:, 0]) == [0.0, 1.0]


def case_roi_pooling_matches_manual():
    x = np.arange(64, dtype="float32").reshape(1, 1, 8, 8)
    rois = np.array([[0, 0, 0, 3, 3]], "float32")
    both("ROIPooling", [x, rois], dict(pooled_size=(2, 2),
                                       spatial_scale=1.0))


def case_roi_align_constant_field():
    both("contrib.ROIAlign", [np.full((1, 2, 10, 10), 3.5, "float32"),
                              np.array([[0, 1.0, 1.0, 7.0, 5.0]], "float32")],
         dict(pooled_size=(3, 3), spatial_scale=1.0))


def case_roi_align_gradient_flows():
    x = np.random.RandomState(0).rand(1, 1, 6, 6).astype("float32")
    both("contrib.ROIAlign", [x, np.array([[0, 0.5, 0.5, 4.5, 4.5]],
                                          "float32")],
         dict(pooled_size=(2, 2), spatial_scale=1.0), grad=(0,))


def case_bilinear_sampler_identity_grid():
    x = np.random.RandomState(1).rand(2, 3, 5, 7).astype("float32")
    xg, yg = np.meshgrid(np.linspace(-1, 1, 7), np.linspace(-1, 1, 5))
    grid = np.stack([xg, yg])[None].repeat(2, 0).astype("float32")
    both("BilinearSampler", [x, grid], grad=(0, 1))


def case_spatial_transformer_identity_affine():
    x = np.random.RandomState(2).rand(1, 2, 6, 6).astype("float32")
    for theta in ([1, 0, 0, 0, 1, 0], [1, 0, 0.5, 0, 1, 0]):
        both("SpatialTransformer", [x, np.array([theta], "float32")],
             dict(target_shape=(6, 6)), grad=(0, 1))


def case_grid_generator_warp_zero_flow():
    both("GridGenerator", [np.zeros((1, 2, 4, 5), "float32")],
         dict(transform_type="warp"))


def case_bilinear_resize_2d():
    both("contrib.BilinearResize2D",
         [np.arange(16, dtype="float32").reshape(1, 1, 4, 4)],
         dict(height=7, width=7))


def case_adaptive_avg_pooling():
    both("contrib.AdaptiveAvgPooling2D",
         [np.random.RandomState(3).rand(2, 3, 7, 5).astype("float32")],
         dict(output_size=(3, 2)))
    both("contrib.AdaptiveAvgPooling2D",
         [np.random.RandomState(4).rand(1, 1, 6, 6).astype("float32")],
         dict(output_size=(3, 3)))


def case_correlation_self_is_mean_square():
    x = np.random.RandomState(5).rand(1, 4, 6, 6).astype("float32")
    both("Correlation", [x, x], dict(kernel_size=1, max_displacement=1,
                                     stride1=1, stride2=1, pad_size=1))


def case_svm_output_grad():
    both("SVMOutput", [np.array([[0.5, -0.2, 0.1]], "float32"),
                       np.array([0], "float32")],
         dict(margin=1.0, use_linear=True), grad=(0,))


def case_multibox_target_padded_rows_dont_clobber():
    anchors = np.array([[[0.0, 0.0, 0.4, 0.4], [0.6, 0.6, 1.0, 1.0]]],
                       "float32")
    label = np.array([[[1, 0.0, 0.0, 0.2, 0.2], [-1, 0, 0, 0, 0]]],
                     "float32")
    out, _ = both("MultiBoxTarget", [anchors, label,
                                     np.zeros((1, 3, 2), "float32")],
                  dict(overlap_threshold=0.5))
    assert out[2][0, 0] == 2


def case_box_nms_topk_counts_valid_only():
    data = np.array([[[0, 0.9, 0.0, 0.0, 1.0, 1.0],
                      [1, 0.8, 2.0, 2.0, 3.0, 3.0]]], "float32")
    out, _ = both("contrib.box_nms", [data], dict(
        overlap_thresh=0.5, topk=1, coord_start=2, score_index=1,
        id_index=0, background_id=0), exact=(0, 1))
    assert (out[0][0, :, 1] > 0).sum() == 1


def _mrcnn(gt, rois, matches, cls_t, C, MS):
    return both("contrib.mrcnn_mask_target", [rois, gt, matches, cls_t],
                dict(num_rois=rois.shape[1], num_classes=C,
                     mask_size=(MS, MS), aligned=True))


def case_mrcnn_mask_target_basic():
    gt = np.zeros((1, 2, 8, 8), np.float32)
    gt[0, 0, :4, :] = 1.0
    gt[0, 1, :, :4] = 1.0
    rois = np.array([[[0, 0, 7, 7]] * 3], np.float32)
    _mrcnn(gt, rois, np.array([[0, 1, 0]], np.int32),
           np.array([[2, 1, 0]], np.int32), 4, 4)


def case_mrcnn_mask_target_roi_crop_region():
    gt = np.zeros((1, 1, 16, 16), np.float32)
    gt[0, 0, :8, :8] = 1.0
    rois = np.array([[[0, 0, 7.0, 7.0], [8.0, 8.0, 15.0, 15.0]]],
                    np.float32)
    _mrcnn(gt, rois, np.zeros((1, 2), np.int32), np.ones((1, 2), np.int32),
           2, 4)


def case_mrcnn_mask_target_data_path():
    from mxnet_tpu.gluon.data.vision.datasets import \
        SyntheticInstanceSegDataset
    _, lab = SyntheticInstanceSegDataset(num_samples=2, size=32,
                                         max_instances=2, seed=3)[0]
    boxes = lab["boxes"].asnumpy()[None]
    M = boxes.shape[1]
    _mrcnn(lab["masks"].asnumpy()[None], boxes,
           np.arange(M, dtype=np.int32)[None],
           lab["classes"].asnumpy().astype("int32")[None], 3, 14)


def case_deformable_conv_zero_offset_equals_conv():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 8, 8).astype("float32")
    w = rng.randn(6, 4, 3, 3).astype("float32")
    b = np.zeros(6, "float32")
    off = np.zeros((2, 18, 8, 8), "float32")
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=6)
    both("DeformableConvolution", [x, off, w, b], kw)
    both("ModulatedDeformableConvolution",
         [x, off, np.ones((2, 9, 8, 8), "float32"), w, b], kw)


def case_deformable_conv_integer_offset_shifts():
    x = np.random.RandomState(1).randn(1, 2, 6, 6).astype("float32")
    off = np.zeros((1, 2, 6, 6), "float32")
    off[:, 1] = 1.0
    both("DeformableConvolution", [x, off, np.ones((2, 2, 1, 1), "float32"),
                                   np.zeros(2, "float32")],
         dict(kernel=(1, 1), num_filter=2))


def case_deformable_conv_fractional_offsets_gradient():
    """Fractional offsets (x 0.3): the gradients of the input, the
    offsets and the weight."""
    rng = np.random.RandomState(2)
    both("DeformableConvolution",
         [rng.randn(1, 2, 5, 5).astype("float32"),
          (rng.randn(1, 8, 4, 4) * 0.3).astype("float32"),
          rng.randn(3, 2, 2, 2).astype("float32"), np.zeros(3, "float32")],
         dict(kernel=(2, 2), num_filter=3), grad=(0, 1, 2))


def case_psroi_pooling_reads_position_sensitive_channels():
    data = np.tile(np.arange(18, dtype="float32").reshape(1, -1, 1, 1),
                   (1, 1, 10, 10))
    both("PSROIPooling", [data, np.array([[0, 1, 1, 8, 8]], "float32")],
         dict(spatial_scale=1.0, output_dim=2, pooled_size=3))


def case_deformable_psroi_no_trans_matches_psroi():
    data = np.random.RandomState(3).randn(1, 8, 8, 8).astype("float32")
    rois = np.array([[0, 1, 1, 6, 6]], "float32")
    both("DeformablePSROIPooling", [data, rois], dict(
        spatial_scale=1.0, output_dim=2, pooled_size=2, group_size=2,
        no_trans=True))


def case_proposal_shapes_and_batch_ids():
    rng = np.random.RandomState(4)
    cls = rng.rand(2, 6, 4, 4).astype("float32")
    bb = (rng.randn(2, 12, 4, 4) * 0.1).astype("float32")
    info = np.array([[64, 64, 1.0]] * 2, "float32")
    kw = dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=10, scales=(8,),
              ratios=(0.5, 1, 2))
    both("MultiProposal", [cls, bb, info], kw, exact=(0,))
    both("Proposal", [cls[:1], bb[:1], info[:1]], dict(kw, output_score=True),
         exact=(0,))


def case_rroi_align_zero_angle_matches_grid():
    data = np.random.RandomState(5).randn(1, 3, 16, 16).astype("float32")
    for ang in (0, 90):
        both("RROIAlign", [data, np.array([[0, 8, 8, 8, 8, ang]],
                                          "float32")],
             dict(pooled_size=(4, 4), spatial_scale=1.0))


def case_box_encode_decode_roundtrip():
    anchors = np.array([[[10., 10, 20, 20], [30, 30, 50, 50]]], "float32")
    refs = np.array([[[12., 11, 22, 21]]], "float32")
    out, _ = both("contrib.box_encode", [np.array([[1., 0]], "float32"),
                                         np.array([[0, 0]], "float32"),
                                         anchors, refs])
    both("contrib.box_decode", [out[0], anchors], dict(
        std0=0.1, std1=0.1, std2=0.2, std3=0.2))


def case_bipartite_matching_greedy():
    sc = np.array([[[0.9, 0.1], [0.8, 0.7]]], "float32")
    for thr in (0.05, 0.75):
        both("contrib.bipartite_matching", [sc], dict(threshold=thr))


CASES = sorted((name[5:], fn) for name, fn in list(globals().items())
               if name.startswith("case_"))


@pytest.mark.parametrize("fn", [fn for _, fn in CASES],
                         ids=[n for n, _ in CASES])
def test_reference_case(fn):
    fn()


# ------------------------------------------------ the exactness hazards --
def test_duplicate_best_anchor_later_box_wins():
    """Two valid boxes whose best anchor is the same (and a padded row):
    the reference's scatter keeps the later box, and so does the port,
    whichever order the classes come in."""
    anchors = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1],
                         [.5, 0, 1, .5]]], "float32")
    label = np.array([[[0, 0, 0, .4, .4], [1, .05, .05, .45, .45],
                       [-1, 0, 0, .5, .5]],
                      [[1, .05, .05, .45, .45], [0, 0, 0, .4, .4],
                       [-1, 0, 0, .5, .5]]], "float32")
    cls_pred = np.random.RandomState(0).randn(2, 3, 4).astype("float32")
    out, _ = both("MultiBoxTarget", [anchors, label, cls_pred],
                  dict(overlap_threshold=0.99))
    np.testing.assert_array_equal(out[2][:, 0], [2.0, 1.0])


def test_box_nms_score_ties_keep_the_input_order():
    """Rows of equal score keep their input order (a stable sort, as
    ``jnp.argsort``): the earlier of two tied overlapping boxes is the
    one kept."""
    rng = np.random.RandomState(1)
    data = np.zeros((2, 16, 6), "float32")
    data[..., 0] = rng.randint(0, 2, (2, 16))
    data[..., 1] = np.round(rng.uniform(0, 1, (2, 16)), 1)
    data[..., 2:4] = rng.uniform(0, 0.3, (2, 16, 2))
    data[..., 4:] = data[..., 2:4] + 0.6
    for kw in (dict(), dict(id_index=0), dict(force_suppress=True,
                                             id_index=0)):
        both("contrib.box_nms", [data], dict(overlap_thresh=0.5, **kw),
             exact=(0, 1, 2, 3, 4, 5))


def test_proposal_score_ties_go_to_the_lower_index():
    """Quantized RPN scores (many ties): the pre-NMS top-k and the
    post-NMS order take the lower index first, as ``lax.top_k``."""
    rng = np.random.RandomState(2)
    cls = np.round(rng.rand(1, 6, 5, 5), 1).astype("float32")
    bb = (rng.randn(1, 12, 5, 5) * 0.1).astype("float32")
    info = np.array([[80, 80, 1.0]], "float32")
    both("Proposal", [cls, bb, info], dict(
        rpn_pre_nms_top_n=40, rpn_post_nms_top_n=15, threshold=0.6,
        rpn_min_size=4, scales=(8,), ratios=(0.5, 1, 2), output_score=True),
        exact=(0, 1, 2, 3, 4))


def test_detection_topk_counts_valid_rows_only():
    """``nms_topk`` counts valid rows only: the best-scoring anchors are
    below the threshold and take no slot."""
    rng = np.random.RandomState(3)
    A = 40
    cls_prob = rng.uniform(0, 0.3, (1, 3, A)).astype("float32")
    cls_prob[0, 1:, :8] = 0.02                  # below threshold 0.05
    cls_prob[0, 0, :8] = 0.99                   # background wins there
    anchors = _corner(rng, (1, A, 4)) * 0.5
    out, _ = both("MultiBoxDetection", [cls_prob, np.zeros((1, 4 * A),
                                                           "float32"),
                                        anchors],
                  dict(threshold=0.05, nms_threshold=0.5, nms_topk=5),
                  exact=(0, 1))
    assert (out[0][0, :, 0] >= 0).sum() == 5


SSD300 = dict(
    maps=(38, 19, 10, 5, 3, 1),
    sizes=((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
           (.88, .961)),
    ratios=((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5, 3, 1. / 3),
            (1, 2, .5, 3, 1. / 3), (1, 2, .5), (1, 2, .5)),
    steps=(8, 16, 32, 64, 100, 300))


def ssd300_anchors(pkg):
    """MXNet's example/ssd VGG16-reduced 300 anchors: (1, 8732, 4)."""
    ctx = {} if pkg.__name__ == "mxnet_tpu" else {"ctx": pkg.cpu()}
    parts = []
    for m, s, r, st in zip(SSD300["maps"], SSD300["sizes"],
                           SSD300["ratios"], SSD300["steps"]):
        feat = pkg.nd.zeros((1, 1, m, m), **ctx)
        parts.append(pkg.nd.MultiBoxPrior(
            feat, sizes=s, ratios=r, clip=False,
            steps=(st / 300.0, st / 300.0)).asnumpy())
    return np.concatenate(parts, axis=1)


def test_detection_at_ssd300_scale():
    """``MultiBoxDetection`` over SSD300's 8732 anchors on one image (21
    classes, NMS threshold 0.45, top 400): the anchors, the class ids
    and the keep decisions bit for bit, boxes and scores within 1e-6."""
    import mxnet_tpu as R
    import mxnet_tpu_torch as P
    anchors = ssd300_anchors(P)
    np.testing.assert_allclose(anchors, ssd300_anchors(R), rtol=1e-6,
                               atol=1e-7)
    assert anchors.shape == (1, 8732, 4)
    rng = np.random.RandomState(4)
    logits = rng.randn(1, 21, 8732).astype("float32") * 2
    cls_prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .astype("float32")
    loc = (rng.randn(1, 8732 * 4) * 0.5).astype("float32")
    out, _ = both("MultiBoxDetection", [cls_prob, loc, anchors], dict(
        nms_threshold=0.45, nms_topk=400), exact=(0,))
    kept = out[0][0, :, 0] >= 0
    assert 0 < kept.sum() <= 400


def test_nms_plain_version_matches_reference_scan():
    """``kernels/nms.py``'s plain version against the reference's
    ``_nms_keep`` on the same sorted boxes: with class ids, across
    classes, with invalid rows."""
    import jax.numpy as jnp
    import torch
    from mxnet_tpu.ops.vision import _nms_keep
    from mxnet_tpu_torch.kernels.nms import nms_keep_reference
    rng = np.random.RandomState(5)
    N = 300
    c = rng.uniform(0.1, 0.9, (N, 2))
    wh = rng.uniform(0.05, 0.3, (N, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype("float32")
    valid = rng.rand(N) > 0.1
    ids = rng.randint(0, 3, N).astype("float32")
    for force in (False, True):
        for thresh in (0.3, 0.7):
            want = np.asarray(_nms_keep(jnp.asarray(boxes), None,
                                        jnp.asarray(valid), thresh, force,
                                        jnp.asarray(ids)))
            got = nms_keep_reference(
                torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None],
                None if force else torch.from_numpy(ids)[None], thresh)
            np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("op,dtypes", [
    ("MultiBoxTarget", ("float32", "float32", "bfloat16")),
    ("MultiBoxDetection", ("bfloat16", "float32", "float32")),
    ("_contrib_box_nms", ("bfloat16",)),
    ("_contrib_ROIAlign", ("bfloat16", "float32")),
    ("_contrib_Proposal", ("bfloat16", "bfloat16", "float32")),
    ("SVMOutput", ("bfloat16", "float32")),
    ("SpatialTransformer", ("bfloat16", "bfloat16")),
    ("GridGenerator", ("bfloat16",)),
    ("_contrib_DeformableConvolution", ("float32",) * 4),
])
def test_amp_hook_classes_vision_ops_as_the_reference(op, dtypes):
    """Under AMP the port's cast hook hands each vision op the input
    dtypes the reference's lists give it: the detection heads as they
    come (an f32 anchor set and label stay f32), ``SVMOutput`` and the
    affine grid in f32, the deformable convolution in the target
    dtype."""
    import jax.numpy as jnp
    import torch
    from mxnet_tpu.contrib.amp.amp import _make_hook as jmake
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.contrib.amp.amp import _make_hook
    from mxnet_tpu_torch.ops import registry
    want = jmake("bfloat16")(jreg.get_op(op), [jnp.zeros((2,), d)
                                               for d in dtypes])
    got = _make_hook("bfloat16")(registry.get_op(op), [
        torch.zeros(2, dtype=getattr(torch, d)) for d in dtypes])
    assert [str(t.dtype).replace("torch.", "") for t in got] == \
        [str(a.dtype) for a in want]


def test_amp_runs_spatial_transformer_in_f32():
    """End to end under ``amp.init()``: f16 inputs to
    ``SpatialTransformer`` are cast to f32 before the op, so it returns
    f32 equal to the op on the f32 casts."""
    import torch
    import mxnet_tpu_torch as P
    from mxnet_tpu_torch.contrib import amp
    rng = np.random.RandomState(6)
    x = rng.randn(1, 2, 5, 5).astype("float32")
    theta = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0]], "float32")
    ctx = P.cpu()
    xb = P.nd.array(x, ctx=ctx).astype("float16")
    tb = P.nd.array(theta, ctx=ctx).astype("float16")
    want = P.nd.SpatialTransformer(xb.astype("float32"), tb.astype("float32"),
                                   target_shape=(4, 4)).asnumpy()
    amp.init()
    try:
        got = P.nd.SpatialTransformer(xb, tb, target_shape=(4, 4))
    finally:
        amp.disable()
    assert got._data.dtype == torch.float32
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_ssd_ops_in_a_bound_symbol():
    """``MultiBoxPrior`` -> ``MultiBoxTarget`` and ``MultiBoxDetection``
    as one symbol bound to an executor, in both packages (the
    reference's ``test_detection_ops_in_symbol_graph`` grown to the
    SSD path): every output."""
    import mxnet_tpu as R
    import mxnet_tpu_torch as P
    from _torch_ssd import ssd_symbol, ssd_symbol_inputs
    feed = ssd_symbol_inputs()
    outs = []
    for pkg in (R, P):
        ctx = pkg.cpu()
        args = {k: pkg.nd.array(v, ctx=ctx) for k, v in feed.items()}
        exe = ssd_symbol(pkg).bind(ctx, args)
        outs.append([o.asnumpy() for o in exe.forward()])
    for k, (got, want) in enumerate(zip(outs[1], outs[0])):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg="output %d" % k)
    np.testing.assert_array_equal(outs[1][2], outs[0][2])
    np.testing.assert_array_equal(outs[1][3][..., 0], outs[0][3][..., 0])
