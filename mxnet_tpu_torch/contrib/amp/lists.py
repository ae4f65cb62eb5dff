"""AMP op lists: the port's own copy of ``mxnet_tpu/contrib/amp/lists.py``.

The same four classes, entry for entry (``tests/test_torch_amp.py``
holds them equal to the reference's): ops that run in the target dtype,
ops forced to float32, ops whose float inputs are cast to the widest
among them, and ops the hook leaves alone.  Every op the port registers
belongs to exactly one class; :func:`classify` answers which.
"""

# Ops that run in the low-precision target dtype — the tensor-core matmul
# and conv FLOPs (reference: FP16_FUNCS).
TARGET_DTYPE_OPS = [
    "FullyConnected", "Convolution", "Deconvolution", "RNN",
    "dot", "batch_dot", "_npi_matmul",
    "_linalg_gemm", "_linalg_gemm2", "_linalg_trmm", "_linalg_syrk",
    # the rest of the matmul and convolution families
    "Correlation", "_rnn_nostate",
    "_contrib_DeformableConvolution",
    "_contrib_ModulatedDeformableConvolution",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_np_matmul", "_np_einsum", "_np_tensordot", "_np_inner",
    "_np_outer", "_np_vdot", "_np_kron", "khatri_rao",
]

# Numerically-sensitive ops forced to float32 (reference: FP32_FUNCS).
# BatchNorm is NOT here (matching the reference's cuDNN-BN treatment):
# the op itself takes low-precision I/O and accumulates its statistics
# and running-stat updates in f32 internally (ops/nn.py batch_norm), so
# casting its activations to f32 would only burn HBM bandwidth.
FP32_OPS = [
    "LayerNorm", "InstanceNorm", "GroupNorm",
    "L2Normalization", "softmax", "log_softmax", "softmin",
    "SoftmaxOutput", "softmax_cross_entropy", "CTCLoss",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "make_loss",
    "exp", "expm1", "log", "log10", "log1p", "log2",
    "rsqrt", "rcbrt", "reciprocal", "square", "sqrt", "cbrt",
    "pow", "broadcast_power", "_power_scalar", "_rpower_scalar",
    "gamma", "gammaln", "digamma", "erf", "erfc", "erfinv",
    "sum", "mean", "prod", "nansum", "nanprod", "norm", "moments",
    "cumsum", "smooth_l1", "sin", "cos", "tan", "sinh", "cosh", "tanh",
    "arcsin", "arccos", "arctan", "arcsinh", "arccosh", "arctanh",
    "softsign",
    # ----------------------------------------------------------------
    # losses / normalizations that divide or exponentiate
    "LRN", "SVMOutput", "IdentityAttachKLSparseReg",
    "masked_softmax", "masked_log_softmax", "softmax_activation",
    "log_sigmoid", "mish",
    # affine-grid coordinate matmuls (bf16 grid coordinates visibly
    # warp the sampled image)
    "GridGenerator", "SpatialTransformer",
    # linalg factorizations / solves — classically ill-conditioned
    "_linalg_det", "_linalg_gelqf", "_linalg_inverse",
    "_linalg_potrf", "_linalg_potri", "_linalg_slogdet",
    "_linalg_sumlogdiag", "_linalg_syevd", "_linalg_trsm",
    "_np_linalg_cholesky", "_np_linalg_det", "_np_linalg_eigh",
    "_np_linalg_eigvalsh", "_np_linalg_inv", "_np_linalg_lstsq",
    "_np_linalg_matrix_power", "_np_linalg_matrix_rank",
    "_np_linalg_norm", "_np_linalg_pinv", "_np_linalg_qr",
    "_np_linalg_slogdet", "_np_linalg_solve", "_np_linalg_svd",
    # long-accumulation reductions and signal ops (np namespace
    # counterparts of the sum/mean/... family above)
    "_np_convolve", "_np_correlate", "_np_cov",
    "_np_sum", "_np_mean", "_np_average", "_np_std", "_np_var",
    "_np_nanmean", "_np_nanstd", "_np_nanvar",
    "_np_prod", "_np_cumsum", "_np_cumprod", "_np_trace",
    "_np_trapz", "_np_gradient", "_np_interp", "_np_polyval",
    "_np_histogram", "_np_percentile", "_np_quantile", "_np_median",
    # transcendental / log-domain binaries
    "_np_logaddexp", "_np_logaddexp2", "_np_hypot", "_np_i0",
    "_np_sinc", "_np_float_power",
    "_np_arctan2", "_np_angle", "_np_unwrap", "arctan2",
]

# Ops whose float inputs must agree — cast to the widest participating
# dtype (reference: WIDEST_TYPE_CASTS / amp_multicast).
WIDEST_TYPE_CASTS = [
    "add_n", "Concat", "stack", "where",
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
    "broadcast_mod",
    # np-namespace multi-float-input joins
    # and binaries whose operands' dtypes must agree
    "_np_concatenate", "_np_stack", "_np_column_stack", "_np_where",
    "_np_copysign", "_np_fmax", "_np_fmin", "_np_fmod",
    "_np_floor_divide", "_np_divmod", "_np_heaviside", "_np_ldexp",
    "_np_nextafter",
]

# Ops the AMP hook deliberately leaves alone (the
# reference's implicit "everything else" made EXPLICIT so the registry
# test can fail on unclassified new ops).  Rationale per family:
#   * dtype-preserving structure/shape/index/selection ops — casting
#     buys nothing and burns bandwidth;
#   * comparison / logical / bit ops — bool or int outputs;
#   * samplers and creation ops — produce fresh arrays, dtype is an
#     attr, there is nothing to cast;
#   * optimizer ``*_update`` ops — they read/write the f32 master
#     weights; casting their inputs would silently truncate the
#     master copy (the loss-scaler handles their grad dtype);
#   * quantized int8 ops — already carry explicit scales; AMP casting
#     the float min/max range scalars would skew the calibration;
#   * BatchNorm family — low-precision I/O with internal f32 stats
#     (see FP32_OPS note);
#   * activations that are monotone + bounded-slope (relu/sigmoid/...)
#     are bf16-safe by the reference's FP16-ok treatment.
PASSTHROUGH_SAFE_OPS = [
    # -- NN layers with safe low-precision I/O ---------------------
    "Activation", "BatchNorm", "Dropout", "Embedding", "LeakyReLU",
    "Pooling", "UpSampling", "_contrib_SyncBatchNorm",
    "relu", "sigmoid", "hard_sigmoid",
    "_contrib_AdaptiveAvgPooling2D", "_contrib_BilinearResize2D",
    "BilinearSampler",
    # -- vision / detection heads (index-heavy, box coords) --------
    "Crop", "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget",
    "ROIPooling", "_contrib_DeformablePSROIPooling",
    "_contrib_MultiProposal", "_contrib_PSROIPooling",
    "_contrib_Proposal", "_contrib_ROIAlign", "_contrib_RROIAlign",
    "_contrib_box_decode", "_contrib_box_encode", "_contrib_box_iou",
    "_contrib_box_nms", "_contrib_bipartite_matching",
    "_contrib_mrcnn_mask_target",
    # -- sequence / masking ----------------------------------------
    "SequenceLast", "SequenceMask", "SequenceReverse",
    # -- framework plumbing ----------------------------------------
    "BlockGrad", "Cast", "Custom", "identity", "amp_cast",
    "amp_multicast", "_contrib_gradientmultiplier",
    "_contrib_div_sqrt_dim", "_contrib_quadratic",
    "_contrib_allclose", "_contrib_getnnz", "_contrib_boolean_mask",
    "_contrib_index_array", "_contrib_index_copy",
    "_contrib_count_sketch", "_contrib_fft", "_contrib_ifft",
    "_onnx_expand",
    # -- quantized int8 path (explicit scales; see note above) -----
    "_contrib_dequantize", "_contrib_quantize", "_contrib_quantize_v2",
    "_contrib_quantized_act", "_contrib_quantized_conv",
    "_contrib_quantized_flatten", "_contrib_quantized_fully_connected",
    "_contrib_quantized_pooling", "_contrib_requantize",
    # -- optimizer updates (f32 master weights) --------------------
    "adam_update", "adamw_update", "ftrl_update",
    "lamb_update_phase1", "lamb_update_phase2",
    "mp_adam_update", "mp_lamb_update_phase1", "mp_lamb_update_phase2",
    "mp_nag_mom_update", "mp_sgd_mom_update", "mp_sgd_update",
    "multi_all_finite", "multi_lars", "multi_mp_sgd_mom_update",
    "multi_mp_sgd_update", "multi_sgd_mom_update", "multi_sgd_update",
    "multi_sum_sq", "nag_mom_update",
    "preloaded_multi_sgd_mom_update", "preloaded_multi_sgd_update",
    "rmsprop_update", "rmspropalex_update", "sgd_mom_update",
    "sgd_update", "signsgd_update", "signum_update",
    "_contrib_group_adagrad_update", "all_finite", "reset_arrays",
    # -- creation / ranges (dtype is an attr) ----------------------
    "_arange", "_eye", "_full", "_full_like", "_linspace", "_ones",
    "_zeros", "ones_like", "zeros_like", "one_hot",
    "_np_bartlett", "_np_blackman", "_np_hamming", "_np_hanning",
    "_np_kaiser", "_np_indices", "_np_meshgrid", "_np_tri",
    "_np_vander", "_contrib_arange_like",
    # -- samplers --------------------------------------------------
    "_random_exponential", "_random_gamma",
    "_random_generalized_negative_binomial",
    "_random_negative_binomial", "_random_normal", "_random_poisson",
    "_random_randint", "_random_uniform",
    "_sample_exponential", "_sample_gamma",
    "_sample_generalized_negative_binomial", "_sample_multinomial",
    "_sample_negative_binomial", "_sample_normal", "_sample_poisson",
    "_sample_uniform", "_sample_unique_zipfian", "_shuffle",
    # -- comparisons / logical / bit ops (bool or int results) -----
    "broadcast_equal", "broadcast_greater", "broadcast_greater_equal",
    "broadcast_lesser", "broadcast_lesser_equal", "broadcast_not_equal",
    "broadcast_logical_and", "broadcast_logical_or",
    "broadcast_logical_xor", "logical_not",
    "_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
    "_lesser_scalar", "_lesser_equal_scalar", "_not_equal_scalar",
    "isfinite", "isinf", "isnan", "sign",
    "_np_all", "_np_any", "_np_allclose", "_np_array_equal",
    "_np_isclose", "_np_isin", "_np_in1d", "_np_signbit",
    "_np_bitwise_and", "_np_bitwise_or", "_np_bitwise_xor",
    "_np_left_shift", "_np_right_shift", "_np_gcd", "_np_lcm",
    # -- scalar-attr elementwise (dtype-preserving, exact in bf16
    #    relative to their operand's precision) --------------------
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
    "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
    "_maximum_scalar", "_minimum_scalar", "_floordiv_scalar",
    "_broadcast_floordiv",
    "abs", "negative", "ceil", "floor", "fix", "rint", "round",
    "trunc", "clip", "_np_clip", "_np_round", "_np_positive",
    "_np_nan_to_num", "_np_conj", "_np_real", "_np_imag",
    "_np_deg2rad", "_np_rad2deg", "degrees", "radians",
    "_np_frexp", "_np_modf", "_np_spacing", "_np_cross",
    "_np_ediff1d", "_np_diff",
    # -- selection / argmax / sorting (exact in any dtype) ---------
    "argmax", "argmin", "argmax_channel", "argsort", "sort", "topk",
    "max", "min", "pick",
    "_np_argsort", "_np_argwhere", "_np_flatnonzero", "_np_nonzero",
    "_np_sort", "_np_max", "_np_min", "_np_ptp",
    "_np_nanargmax", "_np_nanargmin", "_np_nanmax", "_np_nanmin",
    "_np_count_nonzero", "_np_searchsorted", "_np_digitize",
    "_np_bincount", "_np_unique",
    # -- shape / layout / index movement ---------------------------
    "Flatten", "reshape", "reshape_like",
    "expand_dims", "squeeze", "swapaxes", "transpose", "slice",
    "slice_axis", "slice_like", "split", "split_v2", "flip", "tile",
    "repeat", "pad", "depth_to_space", "space_to_depth",
    "broadcast_axis", "broadcast_like", "broadcast_to",
    "diag", "shape_array", "size_array",
    "take", "batch_take", "gather_nd", "scatter_nd",
    "ravel_multi_index", "unravel_index", "fill_element_0index",
    "col2im", "im2col",
    "_linalg_extractdiag", "_linalg_extracttrian", "_linalg_makediag",
    "_np_broadcast_to", "_np_diag", "_np_diagonal",
    "_np_expand_dims", "_np_flatten", "_np_flip", "_np_fliplr",
    "_np_flipud", "_np_moveaxis", "_np_pad", "_np_repeat",
    "_np_reshape", "_np_roll", "_np_rollaxis", "_np_rot90",
    "_np_split", "_np_squeeze", "_np_swapaxes", "_np_take",
    "_np_take_along_axis", "_np_tile", "_np_transpose",
    "_np_tril", "_np_triu",
]


def classify(name):
    """Return this op's AMP class: ``'target'`` | ``'fp32'`` |
    ``'widest'`` | ``'passthrough'`` — or ``None`` if the op is not in
    any list (a classification gap; the registry sweep test fails on
    it)."""
    if name in _TARGET_SET:
        return "target"
    if name in _FP32_SET:
        return "fp32"
    if name in _WIDEST_SET:
        return "widest"
    if name in _PASSTHROUGH_SET:
        return "passthrough"
    return None


def _rebuild_sets():
    """Refresh the lookup sets (amp.init() may extend the lists)."""
    global _TARGET_SET, _FP32_SET, _WIDEST_SET, _PASSTHROUGH_SET
    _TARGET_SET = frozenset(TARGET_DTYPE_OPS)
    _FP32_SET = frozenset(FP32_OPS)
    _WIDEST_SET = frozenset(WIDEST_TYPE_CASTS)
    _PASSTHROUGH_SET = frozenset(PASSTHROUGH_SAFE_OPS)


_rebuild_sets()
