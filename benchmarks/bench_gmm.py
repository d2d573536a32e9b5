"""GMM scorer A/B on the GPU: the fused kernel against XLA's ``gmm_loglik``.

Times the scorer alone, for both compute dtypes and both modes, at two
sizes: the headline model's widths (1168 pdfs x 16 components x 39 dims) on
one 256 x 600-frame batch, and the BASELINE.json scoring size (1000 x 256 x
39 at 8192 frames). Each arm is first compared with the float32 XLA scorer.
``--sweep`` also times a grid of kernel block sizes. ``--e2e`` also times the
headline decode end to end (bench.py's corpus and pipeline) with each scorer,
in the order kernel, XLA, XLA, kernel. Prints one JSON line.

    python benchmarks/bench_gmm.py [--sweep] [--e2e] [--reps 20]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = {
    "headline": (1168, 16, 39, 256 * 600),
    "baseline": (1000, 256, 39, 8192),
}


def random_gmm(S, K, D, seed):
    import jax.numpy as jnp

    from mogasr.am.gmm import GmmSet

    rng = np.random.default_rng(seed)
    return GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        jnp.asarray(rng.standard_normal((S, K, D)).astype(np.float32)),
        jnp.asarray((0.5 + rng.random((S, K, D))).astype(np.float32)),
    )


def time_ms(fn, args, reps):
    """Median wall time of one call that ends in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def e2e(reps):
    """Headline decode utt/s and WER with the kernel and with XLA's scorer,
    for both dtypes and modes (ABBA order; median of each arm's passes)."""
    import jax
    import jax.numpy as jnp

    import bench
    from mogasr.am.gmm import gmm_loglik
    from mogasr.am.gmm_pallas import gmm_loglik_kernel
    from mogasr.decoder import viterbi as vit
    from mogasr.eval.wer import corpus_wer
    from mogasr.hmm import graph as gr

    gmm, graph, fcfg, dcfg, bcfg, utts, _meta = bench.load_headline()
    prepared = bench.prepare_batches(utts, fcfg, bcfg)
    graphs = {k: jnp.asarray(v)
              for k, v in gr.batch_graphs([graph] * bcfg.batch_size).items()}

    def decoder(score):
        def run(waves, num_samples, fe):
            feats, n_frames = fe(waves, num_samples)
            B, T, D = feats.shape
            ll = score(feats.reshape(B * T, D), gmm).reshape(B, T, -1)
            return vit.viterbi(ll, graphs, n_frames,
                               acoustic_scale=dcfg.acoustic_scale)
        return run

    rows = {}
    for dt, mode in itertools.product(("float32", "float16"), ("sum", "max")):
        arms = {
            "kernel": decoder(jax.jit(
                lambda a, g: gmm_loglik_kernel(a, g, dt, mode))),
            "xla": decoder(jax.jit(
                lambda a, g: gmm_loglik(a, g, mode=mode, compute_dtype=dt))),
        }
        passes = {"kernel": [], "xla": []}
        wer = {}
        for arm in ("kernel", "xla", "xla", "kernel"):
            _med, times, outs = bench.time_decode(arms[arm], prepared, reps)
            passes[arm] += times
            refs, hyps = bench.hypotheses(outs, prepared, graph, bcfg.batch_size)
            wer[arm] = corpus_wer(refs, hyps)[0]
        row = {f"{arm}_utt_per_s": len(utts) / statistics.median(t)
               for arm, t in passes.items()}
        row.update({f"{arm}_wer": w for arm, w in wer.items()})
        row["pass_s"] = passes
        rows[f"{dt}/{mode}"] = row
        print("e2e", dt, mode, {k: v for k, v in row.items() if k != "pass_s"},
              file=sys.stderr, flush=True)
    return {"n_utts": len(utts), "batch": bcfg.batch_size, "arms": rows}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--e2e", action="store_true")
    args = p.parse_args()

    from mogasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from mogasr.am.gmm import gmm_loglik
    from mogasr.am.gmm_pallas import gmm_loglik_kernel

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_gmm.py times the GPU; found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "card": card, "sizes": {}}
    for size, (S, K, D, N) in SIZES.items():
        gmm = random_gmm(S, K, D, seed=7)
        x = jnp.asarray(np.random.default_rng(1).standard_normal(
            (N, D)).astype(np.float32))
        xla = jax.jit(gmm_loglik, static_argnames=("mode", "compute_dtype"))
        ker = jax.jit(gmm_loglik_kernel, static_argnums=(2, 3))
        rows = {}
        for dt, mode in itertools.product(("float32", "float16"), ("sum", "max")):
            want = xla(x, gmm, mode=mode)
            row = {
                "kernel_max_abs_err_vs_xla_f32": float(
                    jnp.max(jnp.abs(ker(x, gmm, dt, mode) - want))),
                "xla_max_abs_err_vs_xla_f32": float(jnp.max(jnp.abs(
                    xla(x, gmm, mode=mode, compute_dtype=dt) - want))),
                "kernel_ms": time_ms(ker, (x, gmm, dt, mode), args.reps),
                "xla_ms": time_ms(lambda a, g: xla(
                    a, g, mode=mode, compute_dtype=dt), (x, gmm), args.reps),
            }
            rows[f"{dt}/{mode}"] = row
            print(size, dt, mode, row, file=sys.stderr, flush=True)
        out["sizes"][size] = {"S": S, "K": K, "D": D, "N": N, "arms": rows}
        if args.sweep:
            sweep = {}
            for dt, mode in itertools.product(("float32", "float16"), ("sum", "max")):
                for bm, bs, nw, ns in itertools.product(
                        (32, 64, 128), (64, 128), (4, 8), (2, 3)):
                    key = f"{dt}/{mode}/{bm}x{bs}/w{nw}/s{ns}"
                    try:
                        sweep[key] = time_ms(
                            lambda a, g: gmm_loglik_kernel(
                                a, g, dt, mode, block_m=bm, block_s=bs,
                                num_warps=nw, num_stages=ns),
                            (x, gmm), max(3, args.reps // 4))
                    except Exception as e:  # a block shape the compiler refuses
                        sweep[key] = f"{type(e).__name__}: {str(e)[:120]}"
                    print(size, key, sweep[key], file=sys.stderr, flush=True)
            out["sizes"][size]["sweep_ms"] = sweep
    if args.e2e:
        out["e2e_headline"] = e2e(max(3, args.reps // 4))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
