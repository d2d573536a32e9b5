"""Headline benchmark: trained GMM-HMM decode throughput and held-out WER.

Times the trained headline system (benchmarks/headline: a tied-triphone GMM
with 1168 pdfs x 16 components x 39 dims, trained by
benchmarks/train_headline.py on the v2 synthetic corpus) end to end on one
accelerator: front end -> GMM scoring -> Viterbi, over 768 held-out v2
utterances in batches of 256. It reports the WER of the very pipeline being
timed, measured on the same utterances.

Also reported:
- vs_baseline: the same system on one CPU core (NumPy front end, NumPy GEMM
  scorer, XLA-CPU Viterbi), 4 utterance slices x 3 reps, median per-frame
  cost, frame-extrapolated.
- gmm_scorer: the scorer alone at the BASELINE.json scoring size
  (8192 frames x 1000 states x 256 components).

Runs on a GPU only. Prints the device, then ONE JSON line.

    python bench.py
"""

from __future__ import annotations

import json
import os
import statistics
import time

import numpy as np

BUNDLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "benchmarks", "headline")

# The production scoring setting: float16 operands with float32
# accumulation, best component only. On the headline bundle it decodes the
# same words as float32 sum-mode scoring (chip_smoke.py checks the WER).
SCORE_DTYPE = "float16"
SCORE_MODE = "max"

N_UTTS = 768
BATCH = 256
BUCKETS = (250, 350, 450, 600)


def load_headline(n_utts: int = N_UTTS):
    """The trained bundle and its timed corpus: held-out v2 utterances from
    the trainer's speakers and recipe (seed 999; utterance seeds depend only
    on (seed, index), so this is a superset of the trainer's eval set)."""
    from mogasr.config import BatchConfig, DecodeConfig
    from mogasr.data import synthetic as syn
    from mogasr.hmm import triphone as tri
    from mogasr.utils.bundle import load_system

    gmm, topo, fcfg, tied, meta = load_system(BUNDLE_DIR)
    dmeta = meta.get("decode", {})
    dcfg = DecodeConfig(
        acoustic_scale=dmeta.get("acoustic_scale", 1.0),
        word_insertion_penalty=dmeta.get("word_insertion_penalty", 2.0),
    )
    word_lex = {w: list(topo.lexicon.prons[w]) for w in topo.lexicon.words}
    utts = syn.make_corpus_v2(
        n_utts, lexicon=word_lex, speakers=syn.make_speakers(meta.get("speakers", 20)),
        style=syn.CorpusStyle(), seed=999, words_per_utt=(3, 9),
    )
    graph = tri.word_loop_graph_cd(
        tied, insertion_penalty=dcfg.word_insertion_penalty)
    bcfg = BatchConfig(batch_size=BATCH, bucket_boundaries=BUCKETS)
    return gmm, graph, fcfg, dcfg, bcfg, utts, meta


def prepare_batches(utts, fcfg, bcfg):
    """[(waves, num_samples, frontend, Batch)] on the default device."""
    import jax.numpy as jnp

    from mogasr.data.batching import make_batches
    from mogasr.frontend.jax_frontend import cached_frontend

    batches = make_batches([(u.utt_id, u.wave, u.words) for u in utts], bcfg, fcfg)
    return [(jnp.asarray(b.waves), jnp.asarray(b.num_samples),
             cached_frontend(fcfg, b.waves.shape[1]), b) for b in batches]


def make_decoder(gmm, graph, dcfg, batch_size, compute_dtype=SCORE_DTYPE,
                 mode=SCORE_MODE):
    """(waves, num_samples, frontend) -> ViterbiResult: the timed pipeline."""
    import jax.numpy as jnp

    from mogasr.am.gmm_pallas import score_frames
    from mogasr.decoder import viterbi as vit
    from mogasr.hmm import graph as gr

    graphs = {k: jnp.asarray(v)
              for k, v in gr.batch_graphs([graph] * batch_size).items()}

    def run(waves, num_samples, fe):
        feats, n_frames = fe(waves, num_samples)
        ll = score_frames(feats, gmm, compute_dtype, mode)
        return vit.viterbi(ll, graphs, n_frames, acoustic_scale=dcfg.acoustic_scale)

    return run


def hypotheses(results, prepared, graph, batch_size):
    """Word sequences (and references) of decoded batches, in batch order."""
    from mogasr.decoder import viterbi as vit
    from mogasr.hmm import graph as gr

    chain_id = gr.batch_graphs([graph] * batch_size)["chain_id"]
    refs, hyps = [], []
    for res, (_w, _ns, _fe, b) in zip(results, prepared):
        toks = vit.path_to_tokens(res, graph.labels, chain_id)
        for i in range(len(b.utt_ids)):
            refs.append([w.lower() for w in b.words[i]])
            hyps.append([w.lower() for w in toks[i] if w not in ("<sil>", "sil")])
    return refs, hyps


def time_decode(run, prepared, reps: int = 3):
    """Median seconds of one pass over the corpus, after a warm-up pass."""
    import jax

    outs = [run(w, ns, fe) for (w, ns, fe, _b) in prepared]
    jax.block_until_ready(outs)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [run(w, ns, fe) for (w, ns, fe, _b) in prepared]
        jax.block_until_ready(outs)
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times, outs


def _cpu_baseline(utts, fcfg, gmm, graph, dcfg, total_frames, n_utts):
    """Per-frame cost of the CPU pipeline (NumPy front end + NumPy GEMM GMM
    scoring + XLA-CPU Viterbi) on the first 4 utterances, sliced to 300
    frames each, 3 timed reps per slice after a warm-up; per-frame cost =
    median across slices of the per-slice median; extrapolated linearly by
    total frame count. Returns (cpu_utts_per_sec, protocol, ci)."""
    import jax
    import jax.numpy as jnp

    from mogasr.am.gmm import gmm_loglik_np_gemm
    from mogasr.decoder import viterbi as vit
    from mogasr.frontend import numpy_ref as npref
    from mogasr.hmm import graph as gr

    cpu = jax.devices("cpu")[0]
    graphs = jax.device_put(
        {k: jnp.asarray(v) for k, v in gr.batch_graphs([graph]).items()}, cpu)
    viterbi_cpu = jax.jit(lambda ll, nf, g: vit.viterbi(
        ll, g, nf, acoustic_scale=dcfg.acoustic_scale))
    w_np, mu_np, var_np = map(np.asarray, gmm)
    cpu_frames, n_slices, reps = 300, 4, 3
    per_frame_costs = []
    for u in utts[:n_slices]:
        wave_slice = u.wave[: (cpu_frames - 1) * fcfg.frame_shift + fcfg.frame_length]

        def one():
            feats = npref.extract_features_np(wave_slice, fcfg)
            ll = gmm_loglik_np_gemm(feats, w_np, mu_np, var_np)
            ll_c, nf_c = jax.device_put(
                (np.asarray(ll[None], np.float32),
                 np.asarray([ll.shape[0]], np.int32)), cpu)
            jax.block_until_ready(viterbi_cpu(ll_c, nf_c, graphs))
            return feats.shape[0]

        nf = one()  # warm the viterbi compile for this shape
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            one()
            times.append(time.perf_counter() - t0)
        per_frame_costs.append(statistics.median(times) / nf)
    per_frame = statistics.median(per_frame_costs)
    ci = [n_utts / (max(per_frame_costs) * total_frames),
          n_utts / (min(per_frame_costs) * total_frames)]
    return n_utts / (per_frame * total_frames), {
        "slices": n_slices, "frames_per_slice": cpu_frames, "reps": reps,
        "slice_per_frame_us": [1e6 * c for c in per_frame_costs],
    }, ci


def _scorer_ms(reps: int = 10):
    """Median ms of the scorer alone, both modes, at the BASELINE.json
    scoring size (random model, 8192 frames x 1000 states x 256 comps)."""
    import jax
    import jax.numpy as jnp

    from mogasr.am.gmm import GmmSet
    from mogasr.am.gmm_pallas import score_frames

    S, K, D, N = 1000, 256, 39, 8192
    rng = np.random.default_rng(7)
    gmm = GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        jnp.asarray(rng.standard_normal((S, K, D)).astype(np.float32)),
        jnp.asarray((0.5 + rng.random((S, K, D))).astype(np.float32)),
    )
    x = jnp.asarray(rng.standard_normal((N, D)).astype(np.float32))
    out = {"scale": f"{N}x{S}x{K}x{D}", "dtype": SCORE_DTYPE}
    for mode in ("sum", "max"):
        jax.block_until_ready(score_frames(x, gmm, SCORE_DTYPE, mode))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(score_frames(x, gmm, SCORE_DTYPE, mode))
            times.append(time.perf_counter() - t0)
        out[f"{mode}_ms"] = 1e3 * statistics.median(times)
    return out


def main() -> None:
    from mogasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from mogasr.eval.wer import corpus_wer

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}", flush=True)

    gmm, graph, fcfg, dcfg, bcfg, utts, meta = load_headline()
    S, K, D = gmm.means.shape
    audio_seconds = sum(len(u.wave) for u in utts) / fcfg.sample_rate
    prepared = prepare_batches(utts, fcfg, bcfg)
    run = make_decoder(gmm, graph, dcfg, bcfg.batch_size)
    dt, rep_times, outs = time_decode(run, prepared)
    refs, hyps = hypotheses(outs, prepared, graph, bcfg.batch_size)
    wer, _counts = corpus_wer(refs, hyps)
    utts_per_sec = len(utts) / dt

    total_frames = sum(fcfg.num_frames(len(u.wave)) for u in utts)
    cpu_utts_per_sec, cpu_protocol, cpu_ci = _cpu_baseline(
        utts, fcfg, gmm, graph, dcfg, total_frames, len(utts))

    print(json.dumps({
        "metric": "pipeline_utterances_per_sec_per_chip",
        "value": utts_per_sec,
        "unit": "utt/s/chip",
        "device": device,
        "vs_baseline": utts_per_sec / cpu_utts_per_sec,
        "rtf": dt / audio_seconds,
        "wer": wer,
        "heldout_wer_at_train": meta.get("heldout_wer"),
        "gmm": f"{S}x{K}x{D} trained tied-triphone",
        "scoring": {"dtype": SCORE_DTYPE, "mode": SCORE_MODE},
        "n_utts": len(utts),
        "rep_utts_per_sec": [len(utts) / t for t in rep_times],
        "audio_seconds": audio_seconds,
        "cpu_utts_per_sec": cpu_utts_per_sec,
        "cpu_ci": cpu_ci,
        "cpu_protocol": cpu_protocol,
        "gmm_scorer": _scorer_ms(),
    }))


if __name__ == "__main__":
    main()
