"""Test configuration: run everything on a faked 8-device CPU mesh.

SURVEY.md §4: `xla_force_host_platform_device_count=8` stands in for a mock
distributed backend — multi-chip sharding tests run on any box. Must be set
before jax is imported anywhere. The persistent compilation cache that the
entry scripts turn on stays off here, so the suite writes nothing to disk.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# JAX_PLATFORMS=cuda,cpu lets `-m gpu` tests reach a card; the default is CPU.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"] or "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


MINI_VOCAB = ["fish", "cat", "see", "sun", "tree", "dog"]


@pytest.fixture(scope="session")
def mini_system():
    """Small-vocabulary system with FULL phone coverage that generalizes to
    fresh synthetic utterances (the 16-utt trained_system memorizes its
    training realizations but mis-decodes unseen ones — fine for
    decode-vs-decode tests, wrong for recognition-quality claims). 'fish'
    carries the alternate pronunciation f-iy-sh for multi-pron tests.
    Returns (mlex, topo, gmm, vocab)."""
    from mogasr import pipeline as pipe
    from mogasr.config import (
        BatchConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig,
    )
    from mogasr.data.synthetic import LEXICON, make_corpus
    from mogasr.hmm.lexicon import make_lexicon_multi
    from mogasr.hmm.topology import build_topology

    variants = {w: [list(LEXICON[w])] for w in MINI_VOCAB}
    variants["fish"].append(["f", "iy", "sh"])
    mlex = make_lexicon_multi(variants)
    topo = build_topology(mlex, TopologyConfig())
    fcfg = FrontendConfig()
    train_utts = make_corpus(24, words_per_utt=(2, 3), seed=1, vocab=MINI_VOCAB)
    batches = pipe.featurize(
        [(u.utt_id, u.wave, u.words) for u in train_utts],
        fcfg, BatchConfig(batch_size=8, bucket_boundaries=(250, 400)),
    )
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=2, feat_dim=fcfg.feat_dim)
    gmm, _ = pipe.train_gmm(batches, mlex, topo, gcfg, TrainConfig(num_em_iters=6))
    return mlex, topo, gmm, list(MINI_VOCAB)


@pytest.fixture(scope="session")
def trained_system():
    """One shared small trained system (lex, topo, batches, gmm): 16 synthetic
    utts (seed 42), K=2, 6 Viterbi-EM iters, buckets (250, 400). Session-scoped
    because several suites need an identical setup and training costs ~20 s."""
    from mogasr import pipeline as pipe
    from mogasr.config import (
        BatchConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig,
    )
    from mogasr.data.synthetic import make_corpus
    from mogasr.hmm.lexicon import synthetic_lexicon
    from mogasr.hmm.topology import build_topology

    fcfg = FrontendConfig()
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    utts = make_corpus(16, words_per_utt=(2, 3), seed=42)
    batches = pipe.featurize(
        [(u.utt_id, u.wave, u.words) for u in utts],
        fcfg, BatchConfig(batch_size=8, bucket_boundaries=(250, 400)),
    )
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=2, feat_dim=fcfg.feat_dim)
    gmm, _ = pipe.train_gmm(batches, lex, topo, gcfg, TrainConfig(num_em_iters=6))
    return lex, topo, batches, gmm


@pytest.fixture
def gpu():
    """The first NVIDIA GPU; skips the test where there is none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return devs[0]
