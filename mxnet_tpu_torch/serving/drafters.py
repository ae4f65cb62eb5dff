"""Draft-token proposers for in-engine speculative decode.  Port of
``mxnet_tpu/serving/drafters.py`` (pure numpy; the port keeps its own
copy).

The ``ServingEngine`` drafts with :func:`ngram_draft` on the host, as
part of the per-step scheduling it already does.
``models/gpt.py _draft_ngram`` is the on-device twin used by the
stand-alone ``generate_speculative`` loop; the two follow one drafting
rule (held against each other and against the reference by
``tests/test_torch_gpt_spec.py``).

The drafter contract the engine accepts (``spec_drafter=``):

    drafter(tokens: np.ndarray (n,), K: int) -> np.ndarray (K,)

``tokens`` is the row's committed sequence (prompt + generated, the
last element being the not-yet-cached pending token); the return is K
proposals for the positions after it.  Proposal quality only moves the
accept rate: the batched verify forward gates correctness, so an
adversarial drafter degrades to plain decode.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ngram_draft"]


def ngram_draft(tokens, K, g=2):
    """Prompt-lookup (n-gram) draft: propose the K tokens that followed
    the most recent earlier occurrence of the final ``g`` committed
    tokens; repeat the last token for the positions no match covers (or
    when there is no match, or the row is not longer than ``g``)."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    n = tokens.size
    if n < 1:
        raise ValueError("ngram_draft: empty token row")
    if K < 1:
        raise ValueError("ngram_draft: K must be >= 1")
    out = np.full(K, tokens[n - 1], np.int32)
    if n <= g:
        return out
    key = tokens[n - g:]
    # most recent usable match: its continuation starts inside the
    # committed region (s + g < n); one sliding-window compare, no
    # Python loop over offsets (this runs once per decode row a step)
    win = np.lib.stride_tricks.sliding_window_view(tokens[:n - 1], g)
    hits = np.nonzero((win == key).all(axis=1))[0]
    if hits.size:
        s = int(hits[-1])
        idx = s + g + np.arange(K)
        ok = idx < n
        out[ok] = tokens[idx[ok]]
    return out
