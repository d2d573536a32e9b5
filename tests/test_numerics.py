"""Numerics guards: decode decisions invariant to half-precision scoring, no NaNs
through the pipeline under jax_debug_nans (SURVEY.md §5 non-determinism /
sanitizer row), global CMVN stats."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mogasr import pipeline as pipe
from mogasr.config import DecodeConfig, FrontendConfig

FCFG = FrontendConfig()


@pytest.fixture(scope="module")
def system(trained_system):
    return trained_system


def test_bf16_scoring_preserves_decode_decisions(system):
    """Half-precision scorer noise (~0.1 nats on ~100-nat margins) must not
    change the decoded words — the 'matched WER' guarantee for the throughput
    path. The half-precision type is float16 (see mogasr.am.gmm_pallas)."""
    from mogasr.am.gmm_pallas import score_frames

    lex, topo, batches, gmm = system
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    graph = pipe.word_decode_graph(lex, topo, dcfg)
    for fb in batches[:1]:
        s32 = score_frames(fb.feats, gmm, "float32", interpret=True)
        s16 = score_frames(fb.feats, gmm, "float16", interpret=True)
        h32 = pipe.decode_batch(fb, s32, graph, dcfg)
        h16 = pipe.decode_batch(fb, s16, graph, dcfg)
        assert h32 == h16


def test_no_nans_in_pipeline(system):
    """Full scoring+decode under jax_debug_nans: any NaN raises immediately."""
    lex, topo, batches, gmm = system
    with jax.debug_nans(True):
        fb = batches[0]
        scores = pipe.score_batch(fb.feats, gmm)
        graph = pipe.word_decode_graph(lex, topo, DecodeConfig())
        pipe.decode_batch(fb, scores, graph, DecodeConfig(acoustic_scale=1.0))


def test_global_cmvn_stats(system):
    lex, topo, batches, gmm = system
    mean, istd = pipe.compute_global_cmvn(batches)
    assert mean.shape == (FCFG.feat_dim,)
    # features are already per-utterance CMVN'd, so global stats ~ (0, 1)
    np.testing.assert_allclose(mean, 0.0, atol=0.1)
    np.testing.assert_allclose(1.0 / istd, 1.0, atol=0.15)
