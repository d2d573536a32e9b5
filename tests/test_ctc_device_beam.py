"""On-device batched CTC prefix beam == the dict-based reference.

Round 5: _prefix_beam_device_fn runs the WHOLE Hannun prefix beam —
blank/repeat self paths, child extensions, child-into-self prefix
merging, per-frame unit pruning, top-K — as one lax.scan over frames,
with fusion/biasing as table gathers. Pins against ctc_prefix_beam_decode
(the streaming/offline reference) on short utterances where the f32
accumulation contract cannot flip rankings.
"""

from __future__ import annotations

import numpy as np
import pytest

from mogasr.am.ctc import (
    ctc_fusion_matrix,
    ctc_prefix_beam_decode,
    ctc_prefix_beam_decode_device,
)


def _rand_logp(rng, B, T, V, peaky=True):
    x = rng.standard_normal((B, T, V)).astype(np.float32)
    if peaky:
        # sharpen a random unit per frame so beams branch meaningfully
        idx = rng.integers(0, V, (B, T))
        x[np.arange(B)[:, None], np.arange(T)[None, :], idx] += 2.5
    x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x


def _ref(logp, n_frames, **kw):
    return [ctc_prefix_beam_decode(logp[b, : n_frames[b]], **kw)
            for b in range(logp.shape[0])]


def _assert_same(got, want, k=None, tol=2e-4):
    for b, (g, w) in enumerate(zip(got, want)):
        gl = [u for _s, u in g][:k]
        wl = [u for _s, u in w][:k]
        assert gl == wl, f"row {b}: {gl} != {wl}"
        for (gs, _u), (ws, _w) in zip(g[:k], w[:k]):
            assert abs(gs - ws) <= tol * max(1.0, abs(ws)), (b, gs, ws)




@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Mitigation for the full-suite XLA CPU segfault (VERDICT r3 #1a,
    root-caused as compiler-state accumulation
    after hundreds of jitted executables). Round 5 grew the suite with
    compile-heavy device-beam/device-feature modules, which moved the
    crash point EARLIER (observed in test_serve.py at ~82% of the grown
    suite); dropping the accumulated cache before each heavy module keeps
    single-process `pytest tests/` viable. tests/run_all.py remains the
    crash-proof sharded fallback."""
    import jax

    jax.clear_caches()

@pytest.mark.parametrize("prune", [-12.0, -3.0])
def test_device_prefix_beam_matches_reference(prune):
    rng = np.random.default_rng(0)
    B, T, V = 3, 14, 6
    logp = _rand_logp(rng, B, T, V)
    nf = np.asarray([14, 9, 1], np.int32)
    got = ctc_prefix_beam_decode_device(
        logp, nf, beam_size=4, u_cap=20, prune_logp=prune)
    want = _ref(logp, nf, beam_size=4, prune_logp=prune)
    _assert_same(got, want)


def test_device_prefix_beam_zero_frames():
    rng = np.random.default_rng(1)
    logp = _rand_logp(rng, 2, 6, 5)
    got = ctc_prefix_beam_decode_device(
        logp, np.asarray([6, 0], np.int32), beam_size=3, u_cap=12)
    assert got[1] == [(0.0, [])]


def test_device_prefix_beam_fusion_matches_callback():
    from mogasr.lm.unit_ngram import estimate_unit_bigram, fusion_score

    rng = np.random.default_rng(2)
    B, T, V = 2, 10, 6          # 5 units + blank (last)
    logp = _rand_logp(rng, B, T, V)
    nf = np.asarray([10, 7], np.int32)
    seqs = [list(rng.integers(0, 5, size=rng.integers(2, 6)))
            for _ in range(30)]
    lm = estimate_unit_bigram(seqs, 5)
    w = 0.6
    fm = ctc_fusion_matrix(5, lm, w)
    got = ctc_prefix_beam_decode_device(
        logp, nf, beam_size=4, u_cap=16, fusion=fm)
    want = _ref(logp, nf, beam_size=4,
                ext_score=fusion_score(lm, w), ext_weight=1.0)
    _assert_same(got, want)


def test_device_prefix_beam_bias_matches_callback():
    from mogasr.decoder.biasing import CompiledBiaser, ContextBiaser

    rng = np.random.default_rng(3)
    B, T, V = 2, 10, 6
    logp = _rand_logp(rng, B, T, V)
    nf = np.asarray([10, 8], np.int32)
    biaser = ContextBiaser([[0, 1], [2, 3, 1]], weight=1.2,
                           completion_scale=0.5)
    comp = CompiledBiaser(biaser, n_units=5)
    got = ctc_prefix_beam_decode_device(
        logp, nf, beam_size=4, u_cap=16,
        bias_next=comp.next_state, bias_delta=comp.delta)
    want = _ref(logp, nf, beam_size=4,
                ext_score=biaser.score, ext_weight=1.0)
    _assert_same(got, want)


def test_device_prefix_beam_top1_equals_beam_search_quality():
    """Sanity: the device beam's top-1 equals the reference top-1 on a
    wider-beam longer case (rank tail may reorder within f32 tolerance,
    the 1-best must not)."""
    rng = np.random.default_rng(4)
    logp = _rand_logp(rng, 4, 30, 8)
    nf = np.full((4,), 30, np.int32)
    got = ctc_prefix_beam_decode_device(logp, nf, beam_size=8, u_cap=40)
    want = _ref(logp, nf, beam_size=8)
    for g, w in zip(got, want):
        assert g[0][1] == w[0][1]
