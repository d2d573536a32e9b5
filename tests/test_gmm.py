"""GMM scorer tests: NumPy oracle vs pure-JAX vs the fused kernel (Pallas
interpreter) parity, plus scale/shape properties (SURVEY.md §4 golden-file
strategy). Kernel-specific cases live in test_gmm_kernel.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mogasr.am import gmm as G
from mogasr.am.gmm_pallas import gmm_loglik_kernel, score_frames
from mogasr.config import GmmConfig


@pytest.fixture(scope="module")
def small_gmm():
    rng = np.random.default_rng(1)
    S, K, D = 7, 5, 4
    w = rng.dirichlet(np.ones(K), size=S).astype(np.float32)
    mu = rng.standard_normal((S, K, D)).astype(np.float32)
    var = (0.3 + rng.random((S, K, D))).astype(np.float32)
    return G.GmmSet(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))


@pytest.fixture(scope="module")
def x(small_gmm):
    rng = np.random.default_rng(2)
    return rng.standard_normal((23, 4)).astype(np.float32)


def test_oracle_is_a_density(small_gmm):
    """Sanity: exp(loglik) integrates to ~1 on a 1-D slice."""
    w = np.asarray(small_gmm.weights)[0:1]
    mu = np.asarray(small_gmm.means)[0:1, :, 0:1]
    var = np.asarray(small_gmm.vars)[0:1, :, 0:1]
    grid = np.linspace(-10, 10, 4001)[:, None]
    ll = G.gmm_loglik_np(grid, w, mu, var)
    integral = np.exp(ll[:, 0]).sum() * (grid[1, 0] - grid[0, 0])
    np.testing.assert_allclose(integral, 1.0, atol=1e-3)


def test_jax_matches_oracle(small_gmm, x):
    ref = G.gmm_loglik_np(x, *map(np.asarray, small_gmm))
    got = np.asarray(G.gmm_loglik(jnp.asarray(x), small_gmm, state_chunk=3))
    assert got.shape == (23, 7)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_gemm_np_matches_oracle(small_gmm, x):
    ref = G.gmm_loglik_np(x, *map(np.asarray, small_gmm))
    got = G.gmm_loglik_np_gemm(x, *map(np.asarray, small_gmm))
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-4)


def test_pallas_matches_oracle(small_gmm, x):
    ref = G.gmm_loglik_np(x, *map(np.asarray, small_gmm))
    got = np.asarray(gmm_loglik_kernel(jnp.asarray(x), small_gmm, block_m=8, block_s=16, interpret=True))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_pallas_realistic_shapes():
    """Non-divisible N/S, K=8: padding correctness of the tiled kernel."""
    rng = np.random.default_rng(3)
    S, K, D = 37, 8, 13
    w = rng.dirichlet(np.ones(K), size=S).astype(np.float32)
    mu = rng.standard_normal((S, K, D)).astype(np.float32)
    var = (0.5 + rng.random((S, K, D))).astype(np.float32)
    g = G.GmmSet(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))
    x = rng.standard_normal((129, D)).astype(np.float32)
    ref = G.gmm_loglik_np(x, w, mu, var)
    got = np.asarray(gmm_loglik_kernel(jnp.asarray(x), g, block_m=64, interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_batched_wrapper(small_gmm):
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 11, 4)).astype(np.float32)
    out = np.asarray(score_frames(jnp.asarray(feats), small_gmm, interpret=True))
    assert out.shape == (2, 11, 7)
    ref = G.gmm_loglik_np(feats.reshape(-1, 4), *map(np.asarray, small_gmm)).reshape(2, 11, 7)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-5)


def test_init_shapes():
    cfg = GmmConfig(n_states=10, n_components=4, feat_dim=6)
    g = G.init_gmm(cfg, jax.random.key(0))
    assert g.weights.shape == (10, 4)
    assert g.means.shape == (10, 4, 6)
    np.testing.assert_allclose(np.asarray(g.weights.sum(-1)), 1.0, atol=1e-6)


def test_loglik_padding_rows_ignored(small_gmm, x):
    """Extra zero rows must not change valid rows' scores (SURVEY §7 #4)."""
    xp = np.concatenate([x, np.zeros((9, x.shape[1]), np.float32)])
    a = np.asarray(gmm_loglik_kernel(jnp.asarray(x), small_gmm, block_m=8, block_s=16, interpret=True))
    b = np.asarray(gmm_loglik_kernel(jnp.asarray(xp), small_gmm, block_m=8, block_s=16, interpret=True))[: x.shape[0]]
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_max_mode_scoring(small_gmm, x):
    """mode='max' (Viterbi approximation): XLA and the kernel agree; the
    value is a lower bound on the exact logsumexp within log K nats."""
    from mogasr.am.gmm import gmm_loglik

    exact = np.asarray(gmm_loglik(jnp.asarray(x), small_gmm))
    ref = np.asarray(gmm_loglik(jnp.asarray(x), small_gmm, mode="max"))
    K = small_gmm.n_components
    assert np.all(ref <= exact + 1e-4)
    assert np.all(exact <= ref + np.log(K) + 1e-4)

    got = np.asarray(gmm_loglik_kernel(
        jnp.asarray(x), small_gmm, mode="max", interpret=True))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-5)


def test_max_mode_decode_equivalence():
    """On a TRAINED system (peaked components) max-mode scoring preserves
    Viterbi decode decisions — the gate for using it as the throughput path."""
    import jax

    from mogasr import pipeline as pipe
    from mogasr.am.gmm import gmm_loglik
    from mogasr.config import (
        BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TopologyConfig,
        TrainConfig,
    )
    from mogasr.data.synthetic import make_corpus
    from mogasr.hmm.lexicon import synthetic_lexicon
    from mogasr.hmm.topology import build_topology

    fcfg = FrontendConfig()
    bcfg = BatchConfig(batch_size=4, bucket_boundaries=(250, 400))
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    train = make_corpus(10, words_per_utt=(1, 3), seed=21)
    test = make_corpus(6, words_per_utt=(1, 3), seed=22)
    tb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in train], fcfg, bcfg)
    eb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in test], fcfg, bcfg)
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=2, feat_dim=fcfg.feat_dim)
    gmm = pipe.train_gmm(tb, lex, topo, gcfg, TrainConfig(num_em_iters=4)).gmm

    graph = pipe.word_decode_graph(lex, topo, dcfg)
    for fb in eb:
        B, T, D = fb.feats.shape
        ll_sum = gmm_loglik(fb.feats.reshape(-1, D), gmm).reshape(B, T, -1)
        ll_max = gmm_loglik(
            fb.feats.reshape(-1, D), gmm, mode="max").reshape(B, T, -1)
        hyp_sum = pipe.decode_batch(fb, ll_sum, graph, dcfg)
        hyp_max = pipe.decode_batch(fb, ll_max, graph, dcfg)
        assert hyp_sum == hyp_max
