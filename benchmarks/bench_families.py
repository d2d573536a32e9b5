"""Per-AM-family decode throughput on one chip (round-1 VERDICT item 4).

Measures utt/s/chip + RTF at bench scale for every acoustic-model family's
production decode path, dispatching every batch and syncing once:

  gmm       frontend -> GMM scorer (float16, max) -> Viterbi word-loop
  mlp       frontend -> MLP posteriors -> prior-scaled Viterbi word-loop
  lstm      frontend -> LSTM posteriors -> prior-scaled Viterbi word-loop
  ctc       frontend -> LSTM encoder -> device argmax (+ host collapse)
  rnnt      frontend -> LSTM encoder -> fully on-device greedy scan
  aed       frontend -> Conformer encoder -> on-device beam search (beam 4;
            fixed token budget, so speed is weight-independent worst case)

NN weights are randomly initialized at production sizes — decode SPEED is
weight-independent (decisions are not scored here; accuracy rows live in
demo_accuracy_v2.py / the headline bundle).  Writes
benchmarks/results_families.json.

    python benchmarks/bench_families.py [--n-utts N]
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
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3,
                    help="dispatch windows averaged into one timing")
    ap.add_argument("--runs", type=int, default=1,
                    help="independent timed windows per family, INTERLEAVED "
                         "across families so drift hits all rows alike")
    ap.add_argument("--families", default=None,
                    help="comma list to measure a subset (e.g. "
                         "gmm,mlp); writes results_families_ab.json "
                         "instead so the full table isn't clobbered")
    ap.add_argument("--out", default=None,
                    help="override output JSON filename (in benchmarks/)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mogasr import pipeline as pipe
    from mogasr.am.ctc import ctc_greedy_decode
    from mogasr.am.gmm import GmmSet
    from mogasr.am.gmm_pallas import score_frames
    from mogasr.am.neural import build_model, posteriors_to_loglik
    from mogasr.am.rnnt import (
        RnntModel, build_rnnt_model, init_rnnt_train_state,
        make_rnnt_device_greedy,
    )
    from mogasr.config import (
        BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig, TrainConfig,
    )
    from mogasr.data import synthetic as syn
    from mogasr.data.batching import make_batches
    from mogasr.decoder import viterbi as vit
    from mogasr.frontend.jax_frontend import cached_frontend
    from mogasr.hmm import graph as gr
    from mogasr.hmm.lexicon import make_lexicon
    from mogasr.hmm.topology import build_topology

    t_start = time.time()
    fcfg = FrontendConfig()
    dcfg = DecodeConfig(acoustic_scale=0.1)
    word_lex = syn.extended_lexicon(300)
    lex = make_lexicon(word_lex)
    topo = build_topology(lex, TopologyConfig())
    n_pdfs = topo.n_pdfs

    utts = syn.make_corpus_v2(args.n_utts, lexicon=word_lex, n_speakers=12,
                              seed=999, words_per_utt=(3, 9))
    audio_seconds = sum(len(u.wave) for u in utts) / fcfg.sample_rate
    bcfg = BatchConfig(batch_size=args.batch,
                       bucket_boundaries=(250, 350, 450, 600))
    batches = list(
        make_batches([(u.utt_id, u.wave, u.words) for u in utts], bcfg, fcfg))
    prepared = [
        (jnp.asarray(b.waves), jnp.asarray(b.num_samples),
         cached_frontend(fcfg, b.waves.shape[1]))
        for b in batches
    ]

    graph = pipe.word_decode_graph(lex, topo, dcfg)
    graphs = {
        k: jnp.asarray(v)
        for k, v in gr.batch_graphs([graph] * args.batch).items()
    }

    rng = np.random.default_rng(0)
    tcfg = TrainConfig(nn_hidden=args.hidden, nn_layers=args.layers,
                       nn_context=4)
    S, K, D = n_pdfs, 32, fcfg.feat_dim
    gmm = GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        jnp.asarray(rng.standard_normal((S, K, D)).astype(np.float32)),
        jnp.asarray((0.5 + rng.random((S, K, D))).astype(np.float32)),
    )
    log_priors = jnp.asarray(np.log(np.full(n_pdfs, 1.0 / n_pdfs, np.float32)))

    def nn_scorer(arch):
        model = build_model(arch, n_pdfs, tcfg)
        params = model.init(
            jax.random.key(0), jnp.zeros((2, 8, fcfg.feat_dim)),
            jnp.asarray([8, 8]))
        # keep only the trainable collection (MoeAm's init also returns its
        # sown "losses")
        return model, {"params": params["params"]}

    mlp_model, mlp_params = nn_scorer("mlp")
    lstm_model, lstm_params = nn_scorer("lstm")
    moe_model, moe_params = nn_scorer("moe")  # production EP arch (round 4)
    rnnt_model = build_rnnt_model(lex.n_phones, tcfg)
    rnnt_params = init_rnnt_train_state(
        rnnt_model, tcfg, fcfg.feat_dim, 4, jax.random.key(1)).params
    rnnt_decode = make_rnnt_device_greedy(rnnt_model, rnnt_params, u_cap=120)
    rnnt_decode_scan = make_rnnt_device_greedy(
        rnnt_model, rnnt_params, u_cap=120, impl="frame_scan")

    def run_gmm(w, ns, fe):
        feats, nf = fe(w, ns)
        ll = score_frames(feats, gmm, "float16", "max")
        return vit.viterbi(ll, graphs, nf, acoustic_scale=dcfg.acoustic_scale).path

    def make_hybrid(model, params):
        # jitted logits closure: production consumers (cli/eval.py) never
        # call model.apply eagerly — an eager apply dispatches every op
        # separately and measures dispatch, not the model
        logits_fn = jax.jit(lambda feats, nf: model.apply(params, feats, nf))

        def run(w, ns, fe):
            feats, nf = fe(w, ns)
            ll = posteriors_to_loglik(logits_fn(feats, nf), log_priors)
            return vit.viterbi(ll, graphs, nf,
                               acoustic_scale=dcfg.acoustic_scale).path
        return run

    ctc_model = build_model("lstm", lex.n_phones + 1, tcfg)  # +1 blank
    ctc_params = ctc_model.init(
        jax.random.key(2), jnp.zeros((2, 8, fcfg.feat_dim)), jnp.asarray([8, 8]))

    _ctc_stock = jax.jit(
        lambda feats, nf: ctc_model.apply(ctc_params, feats, nf))
    # PRODUCTION route: the greedy argmax is FUSED into the forward jit,
    # so each batch is one dispatch and one small pull
    _ctc_stock_frames = jax.jit(
        lambda feats, nf: (jnp.argmax(
            ctc_model.apply(ctc_params, feats, nf), -1).astype(jnp.int32),
            nf))

    def run_ctc(w, ns, fe):
        feats, nf = fe(w, ns)
        return _ctc_stock_frames(feats, nf)

    def run_ctc_unfused(w, ns, fe):
        # the r2-r4 route (separate argmax dispatch) kept as the A/B arm
        feats, nf = fe(w, ns)
        return _ctc_stock(feats, nf), nf

    def run_rnnt(w, ns, fe):
        from mogasr.am.rnnt import rnnt_encode

        feats, nf = fe(w, ns)
        enc = rnnt_encode(rnnt_model, rnnt_params, feats, nf)  # production route
        return rnnt_decode(enc, nf)

    def run_rnnt_scan(w, ns, fe):
        # pre-round-3 frame-scan greedy kept as the A/B row (identical
        # hypotheses — tested; the label loop cuts sequential depth ~T/E)
        from mogasr.am.rnnt import rnnt_encode

        feats, nf = fe(w, ns)
        enc = rnnt_encode(rnnt_model, rnnt_params, feats, nf)
        return rnnt_decode_scan(enc, nf)

    from mogasr.am.aed import build_aed_model, init_aed_train_state, make_aed_decoder

    aed_model = build_aed_model(lex.n_phones, tcfg)
    aed_params = init_aed_train_state(
        aed_model, tcfg, fcfg.feat_dim, 4, jax.random.key(3)).params
    aed_decode = make_aed_decoder(aed_model, aed_params, beam=4, max_tokens=48)

    def run_aed(w, ns, fe):
        feats, nf = fe(w, ns)
        return aed_decode(feats, nf)

    # rnnt_beam: the quality-path monotonic beam, now FULLY on device
    # (round 5): encoder + all expansion rounds + prefix merging + top-K
    # in one jitted lax.scan per batch — the same dispatch budget as the
    # greedy rows, so it runs the standard interleaved-window protocol
    # (the r4 host-orchestrated beam measured 1.0 utt/s, dispatch-bound).
    from mogasr.am.rnnt import make_rnnt_beam_device

    _rnnt_beam_dev = make_rnnt_beam_device(
        rnnt_model, rnnt_params, beam_size=4, max_symbols_per_frame=4,
        u_cap=120)

    def run_rnnt_beam_dev(w, ns, fe):
        feats, nf = fe(w, ns)
        return _rnnt_beam_dev(feats, nf)

    # ctc_conformer: same CTC decode path with the matmul-friendly ConformerAm
    # encoder (attention+conv GEMMs at T/4) instead of the scan-bound LSTM
    conf_model = build_model("conformer", lex.n_phones + 1, tcfg)
    conf_params = conf_model.init(
        jax.random.key(4), jnp.zeros((2, 8, fcfg.feat_dim)), jnp.asarray([8, 8]))

    from mogasr.am.ctc import make_ctc_logits_fn

    _conf_logits = make_ctc_logits_fn(conf_model, conf_params)

    from mogasr.am.ctc import make_ctc_frames_fn

    _conf_frames = make_ctc_frames_fn(conf_model, conf_params)

    def run_ctc_conformer(w, ns, fe):
        # the EXACT production route (make_ctc_frames_fn): one jitted
        # closure decoding at the encoder's native 25 Hz rate with the
        # argmax fused — greedy collapse is frame-rate invariant, so
        # hypotheses are identical to the upsampled path (tested)
        feats, nf = fe(w, ns)
        return _conf_frames(feats, nf)

    # quality-path logp closure: log_softmax fused into the same dispatch
    # (the r4 row paid an EAGER log_softmax dispatch per batch post-sync)
    @jax.jit
    def _conf_logp(feats, nf):
        lg, nd = _conf_logits(feats, nf)
        return jax.nn.log_softmax(lg, axis=-1), nd

    def run_ctc_beam_logp(w, ns, fe):
        feats, nf = fe(w, ns)
        return _conf_logp(feats, nf)

    # ctc_beam_device: the round-5 ON-DEVICE prefix beam (fusion/bias-
    # capable) fused with the conformer logp closure — one dispatch per
    # batch; ranked host lists are the decode output (harvested with
    # async copies like the greedy rows)
    from mogasr.am.ctc import _prefix_beam_device_fn

    _pb_fn = _prefix_beam_device_fn(8, lex.n_phones, 200, -12.0,
                                    False, False)
    _pb_zf = jnp.zeros((1, 1), jnp.float32)
    _pb_zi = jnp.zeros((1, 1), jnp.int32)

    @jax.jit
    def _conf_beam_dev(feats, nf):
        logp, nd = _conf_logp(feats, nf)
        hist, lens, pb, pnb = _pb_fn(logp, nd, _pb_zf, _pb_zi, _pb_zf)
        return hist, lens, pb, pnb

    def run_ctc_beam_dev(w, ns, fe):
        feats, nf = fe(w, ns)
        return _conf_beam_dev(feats, nf)

    _conf_up = jax.jit(
        lambda feats, nf: conf_model.apply(conf_params, feats, nf))
    _conf_up_frames = jax.jit(
        lambda feats, nf: (jnp.argmax(
            conf_model.apply(conf_params, feats, nf), -1).astype(jnp.int32),
            nf))

    def run_ctc_conformer_up(w, ns, fe):
        # pre-round-3 path (repeat-upsampled to 100 Hz) kept as the A/B row
        feats, nf = fe(w, ns)
        return _conf_up_frames(feats, nf)

    # ctc_conformer_bf16: the make_bf16_logits recipe (params cast once,
    # XLA constant-folds; activations follow input dtype) at the native
    # 25 Hz rate, jitted like every production route
    from mogasr.am.quantize import cast_float_leaves

    conf_p16 = cast_float_leaves(conf_params, jnp.bfloat16)

    @jax.jit
    def _conf_bf16(feats, nf):
        lg, nd = conf_model.apply(
            conf_p16, feats.astype(jnp.bfloat16), nf, method="subsampled")
        return jnp.argmax(lg, -1).astype(jnp.int32), nd

    def run_ctc_conformer_bf16(w, ns, fe):
        feats, nf = fe(w, ns)
        return _conf_bf16(feats, nf)

    # lstm_prefused: SAME LstmAm checkpoint evaluated by the hoisted-GEMM
    # forward (mogasr.am.fast_lstm) — input projection of all frames as one
    # GEMM, scan does only the recurrent half (exactness-tested)
    from mogasr.am.fast_lstm import lstm_am_apply_prefused

    def make_hybrid_prefused(params):
        logits_fn = jax.jit(
            lambda feats, nf: lstm_am_apply_prefused(params, feats, nf))

        def run(w, ns, fe):
            feats, nf = fe(w, ns)
            ll = posteriors_to_loglik(logits_fn(feats, nf), log_priors)
            return vit.viterbi(ll, graphs, nf,
                               acoustic_scale=dcfg.acoustic_scale).path
        return run

    # quantized hybrid scorers (mogasr.am.quantize): bf16 any arch, int8 mlp
    from mogasr.am.quantize import make_quantized_logits

    def make_hybrid_quant(model, params, precision):
        logits_fn = make_quantized_logits(model, params, precision)

        def run(w, ns, fe):
            feats, nf = fe(w, ns)
            ll = posteriors_to_loglik(logits_fn(feats, nf), log_priors)
            return vit.viterbi(ll, graphs, nf,
                               acoustic_scale=dcfg.acoustic_scale).path
        return run

    families = [
        ("gmm", run_gmm, None),
        ("mlp", make_hybrid(mlp_model, mlp_params), None),
        # moe: the production MoE frame classifier (--arch moe), dense
        # single-chip execution through the same hybrid decode path
        ("moe", make_hybrid(moe_model, moe_params), None),
        ("mlp_bf16", make_hybrid_quant(mlp_model, mlp_params, "bfloat16"), None),
        ("mlp_int8", make_hybrid_quant(mlp_model, mlp_params, "int8"), None),
        ("lstm", make_hybrid(lstm_model, lstm_params), None),
        ("lstm_bf16", make_hybrid_quant(lstm_model, lstm_params, "bfloat16"), None),
        ("lstm_int8", make_hybrid_quant(lstm_model, lstm_params, "int8"), None),
        ("lstm_prefused", make_hybrid_prefused(lstm_params), None),
        ("ctc", run_ctc, "collapse_frames"),
        ("ctc_unfused", run_ctc_unfused, "collapse"),
        ("ctc_conformer", run_ctc_conformer, "collapse_frames"),
        ("ctc_conformer_up", run_ctc_conformer_up, "collapse_frames"),
        ("ctc_conformer_bf16", run_ctc_conformer_bf16, "collapse_frames"),
        ("rnnt", run_rnnt, None),
        ("rnnt_scan", run_rnnt_scan, None),
        ("rnnt_beam", run_rnnt_beam_dev, None),
        ("aed", run_aed, None),
        # quality-path decoders (round-3 VERDICT item 9): the accuracy-
        # critical decode modes, timed like every production row.
        # ctc_beam: conformer logits at 25 Hz + native C++ prefix beam
        # (beam 8, mogasr/native/ctc_beam_native.cpp) on host — the
        # LM-fusion-capable CTC path.
        ("ctc_beam", run_ctc_beam_logp, "beam"),
        ("ctc_beam_device", run_ctc_beam_dev, "beam_rank"),
    ]

    fam_filter = (set(args.families.split(",")) if args.families else None)
    selected = [f for f in families
                if fam_filter is None or f[0] in fam_filter]

    from mogasr.am.ctc import ctc_beam_decode_batch, ctc_collapse_frames

    ctc_blank = lex.n_phones   # every CTC row here: V = n_phones + 1

    def _host_async(outs):
        """Overlap every batch's device->host copy before the first
        np.asarray: serialized per-batch pulls cost a device round-trip
        EACH; async copies pipeline them."""
        for parts in outs:
            for a in (parts if isinstance(parts, tuple) else (parts,)):
                try:
                    a.copy_to_host_async()
                except AttributeError:
                    pass

    def make_run_all(fn, host_post):
        def run_all():
            outs = [fn(w, ns, fe) for (w, ns, fe) in prepared]
            jax.block_until_ready(outs)
            if host_post == "collapse_frames":  # fused-argmax rows
                _host_async(outs)
                for frames, nf in outs:
                    ctc_collapse_frames(
                        np.asarray(frames), np.asarray(nf), ctc_blank)
            elif host_post == "collapse":  # CTC host-side blank collapse
                for logits, nf in outs:
                    ctc_greedy_decode(logits, nf)
            elif host_post == "beam":  # native prefix beam (quality path)
                _host_async(outs)
                for logp, nf in outs:
                    ctc_beam_decode_batch(
                        np.asarray(logp), np.asarray(nf), beam_size=8)
            elif host_post == "beam_rank":  # device beam: rank on host
                _host_async(outs)
                for hist, lens, pb, pnb in outs:
                    tot = np.logaddexp(np.asarray(pb), np.asarray(pnb))
                    hist, lens = np.asarray(hist), np.asarray(lens)
                    for b in range(hist.shape[0]):
                        order = np.argsort(-tot[b])
                        [hist[b, k, : lens[b, k]].tolist()
                         for k in order if tot[b, k] > -1e15]
            return outs
        return run_all

    # Compile + warm every family first, then take `--runs` timed windows
    # per family in an INTERLEAVED order (run 1 of every family, run 2 of
    # every family, ...) so slow drift cannot masquerade as a
    # family difference in an A/B.
    rows = []
    failed: dict[str, str] = {}
    runners = {}
    for name, fn, host_post in selected:
        runners[name] = make_run_all(fn, host_post)
        try:
            runners[name]()  # compile + warm (not timed)
        except Exception as e:  # record and keep measuring the other rows
            failed[name] = f"{type(e).__name__}: {e}"[:300]
            del runners[name]
            print(f"  {name}: FAILED {type(e).__name__} "
                  f"[{time.time()-t_start:.0f}s]", flush=True)
    timings: dict[str, list] = {name: [] for name in runners}
    for run_i in range(args.runs):
        for name, run_all in runners.items():
            t0 = time.perf_counter()
            for _ in range(args.reps):
                run_all()
            timings[name].append((time.perf_counter() - t0) / args.reps)
            print(f"  run {run_i + 1}/{args.runs} {name}: "
                  f"{args.n_utts / timings[name][-1]:.1f} utt/s "
                  f"[{time.time()-t_start:.0f}s]", flush=True)
    for name, fn, host_post in selected:
        if name in failed:
            rows.append({"family": name, "error": failed[name]})
            continue
        dts = sorted(timings[name])
        dt = dts[len(dts) // 2]  # median window
        row = {
            "family": name,
            "utts_per_sec": round(args.n_utts / dt, 2),
            "rtf": round(dt / audio_seconds, 6),
        }
        if args.runs > 1:
            row["runs_utts_per_sec"] = [
                round(args.n_utts / d, 1) for d in timings[name]]
        rows.append(row)
        print(f"  {name}: {row['utts_per_sec']} utt/s rtf {row['rtf']}"
              + (f" runs {row['runs_utts_per_sec']}" if args.runs > 1 else "")
              + f"  [{time.time()-t_start:.0f}s]", flush=True)

    # aed_stream: the chunk-incremental streaming path — the metric that
    # matters here is PER-CHUNK STEP LATENCY (64 concurrent streams, one
    # dispatch per 320 ms audio chunk), not batch utt/s: the stream steps
    # are serialized by their carried state, so wall time = n_chunks x
    # (dispatch + step). Also reported as chunkstep_realtime_x = batched
    # chunk-step throughput as a multiple of realtime. NOTE this is NOT
    # "realtime streams/chip": that name is reserved for the serving-engine
    # metric (bench_serve.py), which includes session lifecycle, finals and
    # partials — ~80x lower. VERDICT r3 weak #4.
    from mogasr.am.aed import (
        aed_stream_init, build_aed_model as _bam, make_aed_stream_step,
    )

    if fam_filter is None or "aed_stream" in fam_filter:
        saed_model = _bam(lex.n_phones, tcfg, chunk_frames=8)
        saed_params = init_aed_train_state(
            saed_model, tcfg, fcfg.feat_dim, 4, jax.random.key(4)).params
        saed_step = make_aed_stream_step(saed_model, saed_params)
        w, ns, fe = prepared[0]
        feats, _nf = fe(w, ns)
        B, T = feats.shape[0], feats.shape[1]
        raw_per = 4 * 8
        n_chunks = T // raw_per
        feats = jax.block_until_ready(feats[:, : n_chunks * raw_per])

        def run_stream():
            st = aed_stream_init(saed_model, batch=B, n_feats=fcfg.feat_dim)
            outs = []
            for c in range(n_chunks):
                e, l, st = saed_step(
                    feats[:, c * raw_per : (c + 1) * raw_per], st)
                outs.append(l)
            jax.block_until_ready(outs)

        run_stream()  # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            run_stream()
        dt = (time.perf_counter() - t0) / args.reps
        chunk_audio_s = raw_per * fcfg.frame_shift / fcfg.sample_rate
        rows.append({
            "family": "aed_stream",
            "concurrent_streams": B,
            "chunk_audio_ms": round(1000 * chunk_audio_s, 1),
            "chunk_step_ms": round(1000 * dt / n_chunks, 2),
            "chunkstep_realtime_x": round(
                B * chunk_audio_s * n_chunks / dt, 1),
        })
        print(f"  aed_stream: {rows[-1]['chunk_step_ms']} ms/chunk-step, "
              f"chunk-step throughput {rows[-1]['chunkstep_realtime_x']}x "
              f"realtime (no lifecycle) [{time.time()-t_start:.0f}s]",
              flush=True)

    # rnnt_beam_host: the r3-r4 host-orchestrated batched beam kept as the
    # A/B floor (one synchronized dispatch per (frame, round) — the dispatch
    # floor bounds it; single-batch measurement, annotated). The
    # production `rnnt_beam` row above is the on-device scan.
    if fam_filter is None or "rnnt_beam_host" in fam_filter:
        from mogasr.am.rnnt import rnnt_beam_decode_batch

        w, ns, fe = prepared[0]
        feats, nf = fe(w, ns)
        n_rb = feats.shape[0]
        rnnt_beam_decode_batch(rnnt_model, rnnt_params,
                               feats, nf, beam_size=4)  # compile + warm
        t0 = time.perf_counter()
        rnnt_beam_decode_batch(rnnt_model, rnnt_params, feats, nf,
                               beam_size=4)
        dt = time.perf_counter() - t0
        rb_audio = float(np.asarray(nf).sum()) * fcfg.frame_shift \
            / fcfg.sample_rate
        rows.append({
            "family": "rnnt_beam_host",
            "n_utts": n_rb,
            "beam": 4,
            "utts_per_sec": round(n_rb / dt, 2),
            "rtf": round(dt / rb_audio, 6),
            "note": "batched monotonic beam; one dispatch per (frame, "
                    "round): the dispatch floor dominates "
                    "— single-batch measurement",
        })
        print(f"  rnnt_beam_host: {rows[-1]['utts_per_sec']} utt/s over "
              f"{n_rb} utts (batched beam) [{time.time()-t_start:.0f}s]",
              flush=True)

    out = {
        "n_utts": args.n_utts,
        "audio_seconds": round(audio_seconds, 1),
        "batch": args.batch,
        "nn": f"hidden={args.hidden} layers={args.layers}",
        "note": "random weights at production sizes; decode speed is "
                "weight-independent (accuracy rows: demo_accuracy_v2 + headline)",
        "reps": args.reps,
        "runs": args.runs,
        "rows": rows,
    }
    default_name = ("results_families.json" if fam_filter is None
                    else "results_families_ab.json")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        args.out or default_name)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
