"""Scoring-path WER A/B on the trained headline bundle.

Answers two questions the judged metric ("throughput at matched WER")
depends on, with the very system bench.py times:

1. Does float16 scoring change decisions vs f32-HIGHEST? (throughput dtype)
2. Does max-mode (Viterbi approximation, best component only) change
   decisions vs exact logsumexp? (epilogue throughput option)

Decodes the same held-out corpus through each scoring variant and reports
WER + utterance-level hypothesis agreement. Writes
benchmarks/results_ab_scoring.json.

    python benchmarks/ab_scoring_wer.py [--n-utts 256]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mogasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-utts", type=int, default=256)
    ap.add_argument("--bundle", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mogasr import pipeline as pipe
    from mogasr.am.gmm_pallas import score_frames
    from mogasr.config import BatchConfig, DecodeConfig
    from mogasr.data import synthetic as syn
    from mogasr.data.batching import make_batches
    from mogasr.decoder import viterbi as vit
    from mogasr.eval.wer import corpus_wer
    from mogasr.frontend.jax_frontend import cached_frontend
    from mogasr.hmm import graph as gr
    from mogasr.hmm import triphone as tri
    from mogasr.utils.bundle import load_system

    bundle_dir = args.bundle or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "headline")
    gmm, topo, fcfg, tied, meta = load_system(bundle_dir)
    dmeta = meta.get("decode", {})
    dcfg = DecodeConfig(
        acoustic_scale=dmeta.get("acoustic_scale", 1.0),
        word_insertion_penalty=dmeta.get("word_insertion_penalty", 2.0),
    )
    word_lex = {w: list(topo.lexicon.prons[w]) for w in topo.lexicon.words}
    speakers = syn.make_speakers(meta.get("speakers", 20))
    utts = syn.make_corpus_v2(
        args.n_utts, lexicon=word_lex, speakers=speakers,
        style=syn.CorpusStyle(), seed=999, words_per_utt=(3, 9),
    )
    graph = tri.word_loop_graph_cd(
        tied, insertion_penalty=dcfg.word_insertion_penalty)
    bcfg = BatchConfig(batch_size=64, bucket_boundaries=(250, 350, 450, 600))
    batches = list(make_batches(
        [(u.utt_id, u.wave, u.words) for u in utts], bcfg, fcfg))
    B = bcfg.batch_size
    graphs_np = gr.batch_graphs([graph] * B)
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    chain_id = graphs_np["chain_id"]

    prepared = []
    for b in batches:
        fe = cached_frontend(fcfg, b.waves.shape[1])
        feats, n_frames = fe(jnp.asarray(b.waves), jnp.asarray(b.num_samples))
        prepared.append((feats, n_frames, b))

    variants = [
        ("f32_sum", dict(compute_dtype="float32", mode="sum")),
        ("f16_sum", dict(compute_dtype="float16", mode="sum")),
        ("f16_max", dict(compute_dtype="float16", mode="max")),
    ]
    refs = [[w.lower() for w in b.words[i]] for _f, _n, b in prepared
            for i in range(len(b.utt_ids))]
    out = {"bundle": bundle_dir, "n_utts": args.n_utts,
           "gmm": "x".join(map(str, gmm.means.shape)), "rows": []}
    hyps_by_variant = {}
    for name, kw in variants:
        t0 = time.time()
        hyps = []
        for feats, n_frames, b in prepared:
            ll = score_frames(feats, gmm, **kw)
            res = vit.viterbi(ll, graphs, n_frames,
                              acoustic_scale=dcfg.acoustic_scale)
            toks = vit.path_to_tokens(res, graph.labels, chain_id)
            for i in range(len(b.utt_ids)):
                hyps.append([w.lower() for w in toks[i]
                             if w not in ("<sil>", "sil")])
        wer, detail = corpus_wer(refs, hyps)
        hyps_by_variant[name] = hyps
        row = {"variant": name, "wer": round(wer, 4),
               "wall_s": round(time.time() - t0, 1)}
        if name != "f32_sum":
            base = hyps_by_variant["f32_sum"]
            agree = sum(h == g for h, g in zip(hyps, base))
            row["utt_agreement_vs_f32"] = round(agree / len(base), 4)
        out["rows"].append(row)
        print(json.dumps(row), flush=True)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_ab_scoring.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
