"""Headline batch-size A/B: is the Viterbi scan latency-bound at B=64?

bench.py runs the trained headline pipeline at batch 64. The decode scan's
per-step work is [B, J] elementwise/VPU ops over T sequential steps; if a
step at B=64 is latency-bound rather than throughput-bound, doubling B
doubles utts/dispatch at near-constant step time — a free headline win.
This measures the FULL bench.py pipeline (fused frontend -> the GMM scorer
at bench.py's setting -> XLA Viterbi) at several batch sizes in interleaved
windows (slow drift hits all arms alike).

    python benchmarks/bench_batch_scale.py --batches 64,128 --windows 5
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mogasr.utils.compile_cache import enable_compile_cache

enable_compile_cache()

BUNDLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "headline")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "results_batch_scale.json")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batches", default="64,128")
    p.add_argument("--windows", type=int, default=5)
    p.add_argument("--n-utts", type=int, default=768)
    p.add_argument("--min-window-s", type=float, default=4.0)
    args = p.parse_args()
    batch_sizes = [int(b) for b in args.batches.split(",")]

    import jax
    import jax.numpy as jnp

    import bench
    from mogasr.am.gmm_pallas import score_frames
    from mogasr.config import BatchConfig, DecodeConfig
    from mogasr.data import synthetic as syn
    from mogasr.data.batching import make_batches
    from mogasr.decoder import viterbi as vit
    from mogasr.frontend.jax_frontend import cached_frontend
    from mogasr.hmm import graph as gr
    from mogasr.hmm import triphone as tri
    from mogasr.utils.bundle import load_system

    gmm, topo, fcfg, tied, meta = load_system(BUNDLE_DIR)
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
    audio_seconds = sum(len(u.wave) for u in utts) / fcfg.sample_rate
    graph = tri.word_loop_graph_cd(
        tied, insertion_penalty=dcfg.word_insertion_penalty)

    def build_runner(B: int):
        bcfg = BatchConfig(batch_size=B,
                           bucket_boundaries=(250, 350, 450, 600))
        graphs = {k: jnp.asarray(v)
                  for k, v in gr.batch_graphs([graph] * B).items()}
        prepared = [
            (jnp.asarray(b.waves), jnp.asarray(b.num_samples),
             cached_frontend(fcfg, b.waves.shape[1]))
            for b in make_batches(
                [(u.utt_id, u.wave, u.words) for u in utts], bcfg, fcfg)
        ]

        def run_all():
            outs = []
            for w, ns, fe in prepared:
                feats, n_frames = fe(w, ns)
                ll = score_frames(feats, gmm, bench.SCORE_DTYPE,
                                  bench.SCORE_MODE)
                outs.append(vit.viterbi(
                    ll, graphs, n_frames, acoustic_scale=dcfg.acoustic_scale))
            jax.block_until_ready(outs)

        return run_all, len(prepared)

    runners = {}
    for B in batch_sizes:
        print(f"compile + warm B={B} ...", flush=True)
        t0 = time.perf_counter()
        run_all, n_batches = build_runner(B)
        run_all()
        print(f"  B={B}: {n_batches} batches, warm in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        runners[B] = run_all

    # calibrate passes per window per arm (>= min_window_s of work)
    passes = {}
    for B, run_all in runners.items():
        t0 = time.perf_counter()
        run_all()
        est = time.perf_counter() - t0
        passes[B] = max(1, int(args.min_window_s / max(est, 1e-3)) + 1)

    rates = {B: [] for B in batch_sizes}
    for w in range(args.windows):
        for B, run_all in runners.items():
            t0 = time.perf_counter()
            for _ in range(passes[B]):
                run_all()
            dt = (time.perf_counter() - t0) / passes[B]
            rates[B].append(args.n_utts / dt)
            print(f"  window {w} B={B}: {args.n_utts / dt:.1f} utt/s",
                  flush=True)

    rows = [{
        "batch": B,
        "utts_per_sec": round(statistics.median(rates[B]), 2),
        "windows_utts_per_sec": [round(r, 1) for r in rates[B]],
        "passes_per_window": passes[B],
    } for B in batch_sizes]
    out = {
        "metric": "headline_pipeline_batch_scale",
        "n_utts": args.n_utts,
        "audio_seconds": round(audio_seconds, 1),
        "gmm": "x".join(str(d) for d in gmm.means.shape),
        "windows": args.windows,
        "protocol": "interleaved windows",
        "rows": rows,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
