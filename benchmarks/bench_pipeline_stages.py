"""Microbenchmark: per-stage timing of the inference pipeline on one chip.

Splits the bench.py pipeline into frontend / GMM scoring / Viterbi decode and
times each separately, so optimization effort goes where the time is.

    python benchmarks/bench_pipeline_stages.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def timeit(fn, reps=3):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


def main() -> None:
    sys.path.insert(0, ".")
    import jax
    import jax.numpy as jnp

    from mogasr import pipeline as pipe
    from mogasr.am.gmm import GmmSet
    from mogasr.am.gmm_pallas import score_frames
    from mogasr.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
    from mogasr.data.batching import make_batches
    from mogasr.data.synthetic import make_corpus
    from mogasr.decoder import viterbi as vit
    from mogasr.frontend.jax_frontend import cached_frontend
    from mogasr.hmm import graph as gr
    from mogasr.hmm.lexicon import synthetic_lexicon
    from mogasr.hmm.topology import build_topology

    fcfg = FrontendConfig()
    dcfg = DecodeConfig(acoustic_scale=0.1)
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    S, K, D = 1000, 256, fcfg.feat_dim
    rng = np.random.default_rng(0)
    gmm = GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        jnp.asarray(rng.standard_normal((S, K, D)).astype(np.float32)),
        jnp.asarray((0.5 + rng.random((S, K, D))).astype(np.float32)),
    )

    B = 8
    utts = make_corpus(16, words_per_utt=(8, 16), seed=1)
    bcfg = BatchConfig(batch_size=B, bucket_boundaries=(1400,))
    batch = next(iter(make_batches([(u.utt_id, u.wave, u.words) for u in utts], bcfg, fcfg)))
    waves = jnp.asarray(batch.waves)
    ns = jnp.asarray(batch.num_samples)
    fe = cached_frontend(fcfg, batch.waves.shape[1])

    feats, nf = fe(waves, ns)
    T = feats.shape[1]
    graph = pipe.word_decode_graph(lex, topo, dcfg)
    graphs = {k: jnp.asarray(v) for k, v in gr.batch_graphs([graph] * B).items()}
    ll = score_frames(feats, gmm, "float16")

    results = {
        "batch": f"B={B} T={T} J={graph.n_states} S={S} K={K}",
        "frontend_ms": round(timeit(lambda: fe(waves, ns)) * 1e3, 2),
        "gmm_scoring_f16_ms": round(
            timeit(lambda: score_frames(feats, gmm, "float16")) * 1e3, 2
        ),
        "viterbi_decode_ms": round(
            timeit(lambda: vit.viterbi(ll, graphs, nf, acoustic_scale=0.1)) * 1e3, 2
        ),
        "viterbi_no_backtrace_ms": round(
            timeit(
                lambda: vit.viterbi(ll, graphs, nf, acoustic_scale=0.1, with_backtrace=False)
            ) * 1e3, 2
        ),
    }
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
