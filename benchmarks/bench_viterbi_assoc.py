"""A/B: sequential lax.scan Viterbi vs the chunked transfer-matrix form.

VERDICT r4 item 5 / SURVEY §7 hard-part 2: the log-depth "associative
scan over T" candidate has sat on the candidates list for three
rounds while the headline plateaued and the r3 analysis found the forward
scan latency-bound at small batch. The TRUE log-depth form needs max-plus
matrix-matrix combines: O(J^3) elementwise work per pair (no matrix unit does max-plus) —
at the headline word-loop J that is thousands of times the sequential
work, rejected by arithmetic (recorded in the output JSON). The viable
variant is viterbi_chunked (mogasr/decoder/viterbi.py): depth T -> C +
T/C + C for J x more work. This script A/Bs it against the plain scan
under the round-3 interleaved-window protocol at:

  - the headline decode shape (B=256, the synthetic word-loop graph,
    T=600 frames), and
  - the serving tick shape (B=64, T=24).

Writes benchmarks/results_viterbi_assoc.json.

    python benchmarks/bench_viterbi_assoc.py [--cpu] [--runs 5]
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
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "results_viterbi_assoc.json")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--runs", type=int, default=5,
                   help="interleaved timed windows per arm (close-call "
                        "protocol: >=5, paired per-window ratios reported)")
    p.add_argument("--reps", type=int, default=8,
                   help="dispatches per timed window")
    p.add_argument("--chunk", type=int, default=32)
    args = p.parse_args()

    from mogasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mogasr import pipeline as pipe
    from mogasr.config import DecodeConfig, TopologyConfig
    from mogasr.decoder import viterbi as vit
    from mogasr.hmm import graph as gr
    from mogasr.hmm.lexicon import synthetic_lexicon
    from mogasr.hmm.topology import build_topology

    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    g = pipe.word_decode_graph(lex, topo, dcfg)
    P = topo.n_pdfs
    rng = np.random.default_rng(0)

    shapes = [("headline", 256, 600), ("serving_tick", 64, 24)]
    results = {"chunk": args.chunk, "runs": args.runs, "reps": args.reps,
               "shapes": {}}
    # the arithmetic rejection of the true log-depth form, recorded
    J = int(np.asarray(gr.batch_graphs([g])["emit_id"]).shape[1])
    results["logdepth_rejection"] = {
        "J": J,
        "work_ratio_vs_sequential": round(J * J / 3.0, 1),
        "note": "max-plus matrix-matrix associative_scan costs ~J^2/deg x "
                "the sequential work in elementwise ops (max-plus cannot "
                "use a matrix unit); rejected by arithmetic, the chunked O(J^2) form is "
                "the measured arm",
    }

    for name, B, T in shapes:
        graphs = {k: jnp.asarray(v)
                  for k, v in gr.batch_graphs([g] * B).items()}
        ll = jnp.asarray(rng.standard_normal((B, T, P)).astype(np.float32))
        nf = jnp.full((B,), T, jnp.int32)
        chunk = min(args.chunk, max(T // 2, 1))

        def run_seq():
            r = vit.viterbi(ll, graphs, nf, acoustic_scale=1.0)
            jax.block_until_ready(r.path)

        def run_chk():
            r = vit.viterbi_chunked(ll, graphs, nf, acoustic_scale=1.0,
                                    chunk=chunk)
            jax.block_until_ready(r.path)

        # equality spot check + compile/warm
        a = vit.viterbi(ll, graphs, nf)
        b = vit.viterbi_chunked(ll, graphs, nf, chunk=chunk)
        paths_equal = bool(
            np.array_equal(np.asarray(a.path), np.asarray(b.path)))
        arms = {"sequential": run_seq, "chunked": run_chk}
        times = {k: [] for k in arms}
        for _ in range(2):
            for f in arms.values():
                f()
        for r_i in range(args.runs):
            for k, f in arms.items():
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    f()
                times[k].append((time.perf_counter() - t0) / args.reps)
                print(f"  {name} run {r_i+1}/{args.runs} {k}: "
                      f"{times[k][-1]*1e3:.2f} ms", flush=True)
        med = {k: statistics.median(v) for k, v in times.items()}
        paired = [s / c for s, c in zip(times["sequential"],
                                        times["chunked"])]
        results["shapes"][name] = {
            "B": B, "T": T, "chunk": chunk,
            "paths_equal": paths_equal,
            "sequential_ms": [round(t * 1e3, 3) for t in times["sequential"]],
            "chunked_ms": [round(t * 1e3, 3) for t in times["chunked"]],
            "median_sequential_ms": round(med["sequential"] * 1e3, 3),
            "median_chunked_ms": round(med["chunked"] * 1e3, 3),
            "paired_speedup_seq_over_chunked": [round(x, 3) for x in paired],
            "paired_speedup_spread": [round(min(paired), 3),
                                      round(max(paired), 3)],
        }
        print(f"{name}: seq {med['sequential']*1e3:.2f} ms vs chunked "
              f"{med['chunked']*1e3:.2f} ms (paired spread "
              f"{min(paired):.2f}..{max(paired):.2f}) paths_equal="
              f"{paths_equal}", flush=True)

    results["backend"] = jax.default_backend()
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
