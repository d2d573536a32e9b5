"""Train the HEADLINE-scale acoustic system and export it as a bundle.

Round-2 requirement (round-1 VERDICT item 1): throughput and WER must be
measured on the SAME system.  This script trains the flagship model —
tied-triphone GMM-HMM (target >=1000 tied pdfs, mixture-split to 16-32
components) on the v2 discriminative synthetic corpus — evaluates held-out
WER, and saves everything bench.py needs to time THAT checkpoint to
``benchmarks/headline/`` (mogasr.utils.bundle format).

    python benchmarks/train_headline.py [--train-utts N] [--components K] ...

Runs on the GPU (several minutes of EM); deterministic.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--train-utts", type=int, default=1600)
    p.add_argument("--test-utts", type=int, default=120)
    p.add_argument("--vocab", type=int, default=300)
    p.add_argument("--speakers", type=int, default=20)
    p.add_argument("--target-pdfs", type=int, default=1200)
    p.add_argument("--components", type=int, default=16)
    p.add_argument("--mono-components", type=int, default=8)
    p.add_argument("--mono-iters", type=int, default=10)
    p.add_argument("--cd-iters", type=int, default=12)
    p.add_argument("--min-occ", type=float, default=100.0,
                   help="min frames for a tied pdf (tying threshold)")
    p.add_argument("--min-split-occ", type=float, default=40.0,
                   help="min avg frames/component required to split a state")
    p.add_argument("--var-floor", type=float, default=0.01,
                   help="variance floor (features are CMVN unit-variance)")
    p.add_argument("--out", default=None, help="bundle dir (default benchmarks/headline)")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from mogasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from mogasr import pipeline as pipe
    from mogasr.config import (
        BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TopologyConfig,
        TrainConfig,
    )
    from mogasr.data import synthetic as syn
    from mogasr.eval.wer import corpus_wer
    from mogasr.hmm import triphone as tri
    from mogasr.hmm.lexicon import make_lexicon
    from mogasr.hmm.topology import build_topology
    from mogasr.utils.bundle import save_system

    t0 = time.time()
    out_dir = args.out or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "headline")

    fcfg = FrontendConfig()
    bcfg = BatchConfig(batch_size=32, bucket_boundaries=(250, 400, 550, 700))
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)

    word_lex = syn.extended_lexicon(args.vocab)
    lex = make_lexicon(word_lex)
    topo = build_topology(lex, TopologyConfig())
    speakers = syn.make_speakers(args.speakers)
    style = syn.CorpusStyle()

    print(f"[{time.time()-t0:.0f}s] synthesizing {args.train_utts}+{args.test_utts} utts", flush=True)
    train = syn.make_corpus_v2(args.train_utts, lexicon=word_lex,
                               speakers=speakers, style=style, seed=100,
                               words_per_utt=(3, 9))
    test = syn.make_corpus_v2(args.test_utts, lexicon=word_lex,
                              speakers=speakers, style=style, seed=999,
                              words_per_utt=(3, 9))

    print(f"[{time.time()-t0:.0f}s] featurizing", flush=True)
    tb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in train], fcfg, bcfg)
    eb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in test], fcfg, bcfg)
    n_frames_total = sum(int(x) for fb in tb for x in fb.n_frames)
    print(f"[{time.time()-t0:.0f}s] {n_frames_total} train frames", flush=True)

    # ---- stage 1: monophone EM with splitting + transition re-estimation
    gcfg_mono = GmmConfig(n_states=topo.n_pdfs, n_components=args.mono_components,
                          feat_dim=fcfg.feat_dim, var_floor=args.var_floor,
                          min_split_occ=args.min_split_occ)
    res = pipe.train_gmm(
        tb, lex, topo, gcfg_mono, TrainConfig(num_em_iters=args.mono_iters),
        reestimate_transitions=True,
    )
    gmm_mono, topo_t = res.gmm, res.topo
    print(f"[{time.time()-t0:.0f}s] mono EM done: loglik "
          f"{res.history[0]:.2f} -> {res.history[-1]:.2f}", flush=True)

    m_mono = pipe.evaluate(eb, gmm_mono, lex, topo_t, dcfg)
    print(f"[{time.time()-t0:.0f}s] mono heldout WER {m_mono['wer']:.4f}", flush=True)

    # ---- stage 2: tied-triphone system at headline scale
    gcfg_cd = GmmConfig(n_states=args.target_pdfs, n_components=args.components,
                        feat_dim=fcfg.feat_dim, var_floor=args.var_floor,
                        min_split_occ=args.min_split_occ)
    tied, res_cd = pipe.train_triphone(
        tb, lex, topo_t, gcfg_cd, TrainConfig(num_em_iters=args.cd_iters),
        gmm_mono, target_pdfs=args.target_pdfs, min_occ=args.min_occ,
    )
    gmm_cd = res_cd.gmm
    print(f"[{time.time()-t0:.0f}s] CD EM done: {tied.n_pdfs} tied pdfs x "
          f"{gmm_cd.n_components} comps, loglik {res_cd.history[0]:.2f} -> "
          f"{res_cd.history[-1]:.2f}", flush=True)

    # ---- held-out WER of the exact exported system (word-loop CD decode,
    # the same graph bench.py times)
    graph_cd = tri.word_loop_graph_cd(
        tied, insertion_penalty=dcfg.word_insertion_penalty)
    refs, hyps = [], []
    for fb in eb:
        scores = pipe.score_batch(fb.feats, gmm_cd)
        out = pipe.decode_batch(fb, scores, graph_cd, dcfg)
        for b in range(fb.size):
            refs.append([w.lower() for w in fb.words[b]])
            hyps.append([w.lower() for w in out[b]])
    wer_cd, detail = corpus_wer(refs, hyps)
    print(f"[{time.time()-t0:.0f}s] CD heldout WER {wer_cd:.4f} ({detail})", flush=True)

    meta = {
        "corpus": "v2",
        "train_utts": args.train_utts,
        "test_utts": args.test_utts,
        "vocab": args.vocab,
        "speakers": args.speakers,
        "train_frames": n_frames_total,
        "tied_pdfs": tied.n_pdfs,
        "components": gmm_cd.n_components,
        "min_occ": args.min_occ,
        "min_split_occ": args.min_split_occ,
        "var_floor": args.var_floor,
        "em_loglik_mono": [round(h, 4) for h in res.history],
        "em_loglik_cd": [round(h, 4) for h in res_cd.history],
        "heldout_wer_mono": round(m_mono["wer"], 4),
        "heldout_wer": round(wer_cd, 4),
        "decode": {"acoustic_scale": dcfg.acoustic_scale,
                   "word_insertion_penalty": dcfg.word_insertion_penalty},
        "wall_s": round(time.time() - t0, 1),
    }
    save_system(out_dir, gmm_cd, topo_t, fcfg, tied=tied, meta=meta)
    print(json.dumps(meta, indent=2))
    print(f"saved bundle to {out_dir}")


if __name__ == "__main__":
    main()
