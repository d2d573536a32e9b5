"""Serving throughput: naive per-session dispatch vs the batched engine.

Measures how many REALTIME AUDIO STREAMS one chip sustains in streaming
recognition (the serving metric that matters for deployment):

- naive: cli/serve.py per-session mode — every audio chunk costs its own
  synchronized batch-1 dispatch chain, so the ceiling is
  ~1/dispatch_latency streams no matter how small the model.
- engine: mogasr.serving.engine.BatchedSessionEngine — ONE dispatch chain
  per tick advances every live session together.

Methodology: multi-second epochs, full session
lifecycle included (start, ragged ticks, end, drain, finalize), median of
epochs. Decode decisions are irrelevant to speed, so the engine runs the
trained headline GMM (1168x16x39) with sliding CMVN (streaming-compatible;
the bundle's offline per-utterance CMVN is acausal).

    python benchmarks/bench_serve.py --capacity 64 --ticks 50
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUNDLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "headline")
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results_serve.json")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--tick-frames", type=int, default=24)
    p.add_argument("--utt-seconds", type=float, default=12.0,
                   help="audio per session per epoch")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--naive-chunks", type=int, default=40,
                   help="0.24 s chunks for the per-session reference")
    p.add_argument("--partial-every", type=int, default=8,
                   help="emit a partial for every live session every K ticks "
                        "(host backtrace cost is part of serving)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (smoke runs; numbers invalid)")
    p.add_argument("--out", default=None,
                   help="output JSON filename under benchmarks/ "
                        "(default results_serve.json)")
    p.add_argument("--skip-gmm", action="store_true",
                   help="skip the GMM engine + naive reference (A/B runs "
                        "focused on one neural engine; the output JSON "
                        "carries nulls for the GMM fields)")
    p.add_argument("--skip-ctc", action="store_true",
                   help="skip the neural-CTC engine row")
    p.add_argument("--skip-rnnt", action="store_true",
                   help="skip the RNN-T engine row")
    p.add_argument("--skip-aed", action="store_true",
                   help="skip the chunked-AED engine row")
    p.add_argument("--aed-chunk", type=int, default=8,
                   help="AED chunk_frames (tick = 4*chunk feature frames)")
    p.add_argument("--aed-precision",
                   choices=["float32", "bfloat16", "both"],
                   default="float32",
                   help="AED engine chunk-step precision (round 5): the "
                        "engine is encoder-compute bound, so bf16 matmul is "
                        "the lever; finals stay f32 exact. 'both' "
                        "interleaves for the A/B")
    p.add_argument("--aed-train-steps", type=int, default=0,
                   help="train the AED arm first (v3-corpus BPE, "
                        "unsaturated vocab) so the serving table of record "
                        "carries the production-path number (early-exit "
                        "finals actually fire) next to the random-weight "
                        "worst-case floor — VERDICT r4 item 6")
    p.add_argument("--rnnt-impl",
                   choices=["frame_scan", "label_loop", "both"],
                   default="frame_scan",
                   help="RNN-T engine chunk-greedy impl; 'both' interleaves "
                        "epochs and adjudicates the >1.2x gate in the row")
    p.add_argument("--aed-final", choices=["many", "loop", "both"],
                   default="many",
                   help="AED drain finalization: 'many' = one batched "
                        "attention-beam dispatch per T-bucket "
                        "(finalize_many), 'loop' = per-session batch-1 "
                        "finals, 'both' interleaves and adjudicates")
    p.add_argument("--history", choices=["device", "host", "both"],
                   default="both",
                   help="GMM-engine backpointer history: device-resident "
                        "(production) vs host chunk lists; 'both' interleaves "
                        "epochs for a fair A/B")
    p.add_argument("--feature-path", choices=["device", "host", "both"],
                   default="device",
                   help="engine feature extraction (round 5): 'device' "
                        "(production) fuses spectral+delta+CMVN+queue into "
                        "one async dispatch per tick; 'host' is the r2-r4 "
                        "per-slot numpy absorb path; 'both' interleaves "
                        "epochs per engine for the A/B (with --history "
                        "forced to device so arms differ in ONE variable)")
    p.add_argument("--defer-absorb", choices=["on", "off", "both"],
                   default="on",
                   help="CTC/RNN-T deferred decode absorption (round 5); "
                        "'both' interleaves for the A/B")
    args = p.parse_args()
    fp_arms = (["device", "host"] if args.feature_path == "both"
               else [args.feature_path])
    defer_arms = ({"on": [True], "off": [False],
                   "both": [True, False]}[args.defer_absorb])

    from mogasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mogasr import pipeline as pipe
    from mogasr.config import DecodeConfig
    from mogasr.data import synthetic as syn
    from mogasr.decoder.online import OnlineDecoder
    from mogasr.frontend.streaming import StreamingFrontend
    from mogasr.hmm import graph as gr
    from mogasr.serving.engine import BatchedSessionEngine

    if os.path.exists(os.path.join(BUNDLE_DIR, "system.json")):
        from mogasr.hmm import triphone as tri
        from mogasr.utils.bundle import load_system

        gmm, topo, fcfg0, tied, meta = load_system(BUNDLE_DIR)
        graph = tri.word_loop_graph_cd(tied, insertion_penalty=2.0)
        word_lex = {w: list(topo.lexicon.prons[w]) for w in topo.lexicon.words}
    else:  # hermetic fallback: random GMM at headline scale
        from cli.score import load_or_random_gmm
        from mogasr.config import FrontendConfig, TopologyConfig
        from mogasr.hmm.lexicon import synthetic_lexicon
        from mogasr.hmm.topology import build_topology

        fcfg0 = FrontendConfig()
        lex = synthetic_lexicon()
        topo = build_topology(lex, TopologyConfig())
        ns = argparse.Namespace(gmm_ckpt=None, num_states=topo.n_pdfs,
                                num_components=8)
        gmm = load_or_random_gmm(ns, fcfg0.feat_dim)
        graph = pipe.word_decode_graph(
            lex, topo, DecodeConfig(word_insertion_penalty=2.0))
        word_lex = None

    fcfg = dataclasses.replace(fcfg0, cmvn="sliding", cmvn_window=600)
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    S, K, D = gmm.means.shape

    def score_fn(feats):
        return pipe.score_batch(feats, gmm)

    sr = fcfg.sample_rate
    hop = fcfg.frame_shift
    tick_samples = args.tick_frames * hop
    # per-session audio: synthetic speech, one distinct wave per slot
    n_tick = int(args.utt_seconds * sr) // tick_samples
    rng = np.random.default_rng(7)
    waves = []
    for b in range(args.capacity):
        w = np.concatenate([
            u.wave for u in syn.make_corpus(
                4, words_per_utt=(4, 7), seed=100 + b)
        ])
        reps = int(np.ceil(n_tick * tick_samples / len(w)))
        waves.append(np.tile(w, reps)[: n_tick * tick_samples]
                     .astype(np.float32))

    # ---------------- engine epochs ----------------
    def run_epoch(eng, batched_final: bool = True) -> int:
        sids = [f"s{e}" for e in range(args.capacity)]
        for sid in sids:
            assert eng.start(sid)
        for t in range(n_tick):
            for b, sid in enumerate(sids):
                eng.feed(sid, waves[b][t * tick_samples:(t + 1) * tick_samples])
            eng.tick()
            if args.partial_every and (t + 1) % args.partial_every == 0:
                eng.partials(sids)
        for sid in sids:
            eng.end(sid)
        while not all(eng.drained(sid) for sid in sids):
            eng.tick()
        if batched_final and hasattr(eng, "finalize_many"):
            eng.finalize_many(sids)   # one final dispatch for all slots
        else:
            for sid in sids:
                eng.finalize(sid)
        return eng.frames_decoded

    # session length bound for the device-resident history (+drain margin)
    hist_frames = (n_tick + 8) * args.tick_frames
    if args.skip_gmm:
        combos = []
    elif args.feature_path == "both":
        # vary ONE variable: the feature path, at production history
        combos = [("device", "device"), ("device", "host")]
    else:
        hists = (["device", "host"] if args.history == "both"
                 else [args.history])
        combos = [(h, fp_arms[0]) for h in hists]
    modes = [f"hist={h},feat={f}" for h, f in combos]
    engines = {}
    for (h, f), mode in zip(combos, modes):
        engines[mode] = BatchedSessionEngine(
            graph, score_fn, fcfg, dcfg, capacity=args.capacity,
            tick_frames=args.tick_frames, history=h,
            max_frames=hist_frames, feature_path=f,
        )
    if engines:
        eng = engines[modes[0]]
        print(f"warmup (compiles: spectral "
              f"[{args.capacity * args.tick_frames},"
              f"{fcfg.frame_length}], score [{args.capacity},"
              f"{args.tick_frames},"
              f"{D}] on {S}x{K}, viterbi J={eng.J}) ...", flush=True)
    for mode, e_ in engines.items():
        t0 = time.perf_counter()
        run_epoch(e_)
        print(f"  warmup epoch [{mode}]: {time.perf_counter() - t0:.1f} s",
              flush=True)

    # interleaved epochs across history modes (slow drift hits all rows
    # alike)
    mode_rates = {mode: [] for mode in modes}
    for e in range(args.epochs):
        for mode, e_ in engines.items():
            base = e_.frames_decoded
            t0 = time.perf_counter()
            total = run_epoch(e_)
            dt = time.perf_counter() - t0
            frames = total - base
            mode_rates[mode].append(frames / dt)
            print(f"  epoch {e} [{mode}]: {frames} frames / {dt:.2f} s = "
                  f"{frames / dt:.0f} frames/s", flush=True)
    frames_per_rt_stream = sr / hop  # 100 frames per second of audio
    if engines:
        prod_mode = ("hist=device,feat=device"
                     if "hist=device,feat=device" in mode_rates else modes[0])
        epoch_rates = mode_rates[prod_mode]
        eng_fps = statistics.median(epoch_rates)
        eng_streams = eng_fps / frames_per_rt_stream
    else:
        prod_mode, epoch_rates, eng_fps, eng_streams = None, [], None, None

    # ---------------- naive per-session reference ----------------
    naive_streams = None
    if not args.skip_gmm:
        graphs1 = {
            k: jnp.asarray(v) for k, v in gr.batch_graphs([graph]).items()}

        def naive_chunk_loop(n_chunks: int) -> float:
            fe = StreamingFrontend(fcfg)
            dec = OnlineDecoder(graphs1, acoustic_scale=dcfg.acoustic_scale)
            w = waves[0]
            t0 = time.perf_counter()
            for i in range(n_chunks):
                feats = fe.process(w[i * tick_samples:(i + 1) * tick_samples])
                if feats.size:
                    dec.process(
                        pipe.score_batch(jnp.asarray(feats[None]), gmm),
                        np.asarray([feats.shape[0]]),
                    )
                    np.asarray(dec.delta)  # serve emits a partial per chunk
            return time.perf_counter() - t0

        naive_chunk_loop(4)  # warmup
        dt = naive_chunk_loop(args.naive_chunks)
        naive_streams = (args.naive_chunks * tick_samples / sr) / dt

    # ---------------- neural CTC engine (production-size LSTM) ----------
    ctc_row = None
    if not args.skip_ctc:
        from mogasr.am.ctc import CtcStreamDecoder
        from mogasr.am.neural import LstmAmStream, lstm_stream_init
        from mogasr.serving.engine import BatchedCtcEngine

        V = 301   # ~300 BPE units + blank; decode speed is weight-independent
        stream = LstmAmStream(n_pdfs=V, hidden=512, layers=2)
        params = stream.init(
            jax.random.key(0), jnp.zeros((1, 4, fcfg.feat_dim)),
            lstm_stream_init(stream, 1, fcfg.feat_dim),
        )

        def make_ctc_engine(fp, defer):
            return BatchedCtcEngine(
                stream, params,
                lambda: CtcStreamDecoder(blank_id=V - 1, mode="greedy"),
                lstm_stream_init(stream, args.capacity, fcfg.feat_dim),
                fcfg, capacity=args.capacity, tick_frames=args.tick_frames,
                feature_path=fp, defer_absorb=defer,
            )

        carm = [(fp, d) for fp in fp_arms for d in defer_arms]
        cengs = {f"feat={fp},defer={int(d)}": make_ctc_engine(fp, d)
                 for fp, d in carm}
        print("warmup ctc engine ...", flush=True)
        for ceng in cengs.values():
            run_epoch(ceng)
        crates = {k: [] for k in cengs}
        for e in range(args.epochs):
            for k, ceng in cengs.items():
                base = ceng.frames_decoded
                t0 = time.perf_counter()
                total = run_epoch(ceng)
                dt = time.perf_counter() - t0
                crates[k].append((total - base) / dt)
                print(f"  ctc epoch {e} [{k}]: {crates[k][-1]:.0f} frames/s",
                      flush=True)
        prod_k = next(iter(cengs))   # device/defer-on first = production
        ctc_fps = statistics.median(crates[prod_k])
        ctc_row = {
            "streams_realtime": round(ctc_fps / (sr / hop), 1),
            "frames_per_sec": round(ctc_fps, 1),
            "epochs": [round(r, 1) for r in crates[prod_k]],
            "arm": prod_k,
            "arms_ab": {k: [round(r, 1) for r in rs]
                        for k, rs in crates.items()},
            "model": f"lstm h=512 L=2 V={V} greedy",
        }

    # ---------------- RNN-T engine (production-size transducer) ---------
    rnnt_row = None
    if not args.skip_rnnt:
        from mogasr.am.rnnt import build_rnnt_model, init_rnnt_train_state
        from mogasr.config import TrainConfig
        from mogasr.serving.engine import BatchedRnntEngine

        V_RNNT = 300  # ~300 BPE units; greedy speed is weight-independent
        tcfg = TrainConfig(nn_arch="lstm", nn_hidden=512, nn_layers=3)
        rnnt_model = build_rnnt_model(V_RNNT, tcfg)
        rnnt_params = init_rnnt_train_state(
            rnnt_model, tcfg, fcfg.feat_dim, 4, jax.random.key(1)
        ).params

        def make_rnnt_engine(impl, fp, defer):
            return BatchedRnntEngine(
                rnnt_model, rnnt_params, fcfg,
                capacity=args.capacity, tick_frames=args.tick_frames,
                greedy_impl=impl, feature_path=fp, defer_absorb=defer,
            )

        impls = (["frame_scan", "label_loop"] if args.rnnt_impl == "both"
                 else [args.rnnt_impl])
        rarm = [(i, fp, d)
                for i in impls for fp in fp_arms for d in defer_arms]
        rengs = {(f"{i},feat={fp},defer={int(d)}" if len(rarm) > len(impls)
                  else i): make_rnnt_engine(i, fp, d)
                 for i, fp, d in rarm}
        impls = list(rengs)   # arm labels drive the loops below
        print("warmup rnnt engine ...", flush=True)
        for impl, reng in rengs.items():
            t0 = time.perf_counter()
            run_epoch(reng)
            print(f"  warmup [{impl}]: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        impl_rates = {impl: [] for impl in impls}
        for e in range(args.epochs):
            for impl, reng in rengs.items():
                base = reng.frames_decoded
                t0 = time.perf_counter()
                total = run_epoch(reng)
                dt = time.perf_counter() - t0
                impl_rates[impl].append((total - base) / dt)
                print(f"  rnnt epoch {e} [{impl}]: "
                      f"{impl_rates[impl][-1]:.0f} frames/s", flush=True)
        if args.rnnt_impl == "both":
            med = {i: statistics.median(rs) for i, rs in impl_rates.items()}
            # the >1.2x promotion gate, adjudicated inside the artifact
            prod_impl = ("label_loop"
                         if med["label_loop"] >= 1.2 * med["frame_scan"]
                         else "frame_scan")
        else:
            prod_impl = impls[0]
        rnnt_fps = statistics.median(impl_rates[prod_impl])
        rnnt_row = {
            "streams_realtime": round(rnnt_fps / (sr / hop), 1),
            "frames_per_sec": round(rnnt_fps, 1),
            "greedy_impl": prod_impl,
            "greedy_impl_ab": {
                i: [round(r, 1) for r in rs] for i, rs in impl_rates.items()
            },
            "model": f"lstm-enc h=512 L=2 V={V_RNNT} device-greedy",
        }

    # ---------------- chunked-AED engine (production-size Conformer) ----
    aed_row = None
    if not args.skip_aed:
        from mogasr.am import aed as A
        from mogasr.config import TrainConfig
        from mogasr.serving.engine import BatchedAedEngine

        V_AED = 300
        aed_tcfg = TrainConfig(nn_hidden=256, nn_layers=4,
                               num_nn_steps=max(args.aed_train_steps, 1))
        if args.aed_train_steps > 0:
            # trained arm at an UNSATURATED vocab: v3-corpus transcripts
            # give BPE a full ~300-unit inventory (v2 saturated at 99)
            from mogasr.config import BatchConfig
            from mogasr.data.bpe import train_bpe

            tr_utts = syn.make_corpus_v3(64, seed=5)
            tr_batches = pipe.featurize(
                [(u.utt_id, u.wave, u.words) for u in tr_utts],
                fcfg, BatchConfig(batch_size=16,
                                  bucket_boundaries=(250, 400, 600)),
            )
            transcripts = [fb.words[b] for fb in tr_batches
                           for b in range(fb.size)]
            aed_bpe = train_bpe(transcripts, n_merges=max(V_AED - 30, 1))
            print(f"training AED (BPE V={aed_bpe.n_units}) for "
                  f"{args.aed_train_steps} steps ...", flush=True)
            aed_model, aed_params = pipe.train_aed_bpe(
                tr_batches, aed_bpe, aed_tcfg,
                chunk_frames=args.aed_chunk, left_chunks=1)
            V_AED = aed_bpe.n_units
        else:
            aed_model = A.build_aed_model(
                V_AED, aed_tcfg, chunk_frames=args.aed_chunk, left_chunks=1
            )
            aed_params = A.init_aed_train_state(
                aed_model, aed_tcfg, fcfg.feat_dim, 4, jax.random.key(2)
            ).params

        def make_aed_engine(fp, prec):
            return BatchedAedEngine(
                aed_model, aed_params, fcfg, capacity=args.capacity,
                beam=4, ctc_weight=0.3, feature_path=fp,
                stream_precision=prec,
            )

        finals = (["many", "loop"] if args.aed_final == "both"
                  else [args.aed_final])
        precs = (["bfloat16", "float32"] if args.aed_precision == "both"
                 else [args.aed_precision])
        aarm = [(fm, fp, pr)
                for fm in finals for fp in fp_arms for pr in precs]
        aengs = {(f"{fm},feat={fp},prec={pr}" if len(aarm) > len(finals)
                  else fm): make_aed_engine(fp, pr)
                 for fm, fp, pr in aarm}
        _aed_final_of = {k: fm for k, (fm, _fp, _pr) in zip(aengs, aarm)}
        print("warmup aed engine ...", flush=True)
        for k, aeng in aengs.items():
            run_epoch(aeng, batched_final=(_aed_final_of[k] == "many"))
        final_rates = {k: [] for k in aengs}
        for e in range(args.epochs):
            for k, aeng in aengs.items():
                base = aeng.frames_decoded
                t0 = time.perf_counter()
                total = run_epoch(
                    aeng, batched_final=(_aed_final_of[k] == "many"))
                dt = time.perf_counter() - t0
                final_rates[k].append((total - base) / dt)
                print(f"  aed epoch {e} [{k}]: "
                      f"{final_rates[k][-1]:.0f} frames/s", flush=True)
        if args.aed_final == "both":
            med = {f_: statistics.median(rs) for f_, rs in final_rates.items()}
            prod_final = ("many" if med["many"] >= 1.2 * med["loop"]
                          else "loop")
        else:
            prod_final = next(iter(aengs))   # device-feat arm first
        aed_fps = statistics.median(final_rates[prod_final])
        aed_row = {
            "streams_realtime": round(aed_fps / (sr / hop), 1),
            "frames_per_sec": round(aed_fps, 1),
            "epochs": [round(r, 1) for r in final_rates[prod_final]],
            "final_mode": prod_final,
            "final_mode_ab": {
                f_: [round(r, 1) for r in rs]
                for f_, rs in final_rates.items()
            },
            "model": (f"conformer d=256 L={aed_tcfg.nn_layers} V={V_AED} "
                      f"chunk={args.aed_chunk} (finals incl.)"),
            "train_steps": args.aed_train_steps,
            "note": ("TRAINED arm (v3-corpus BPE; early-exit finals fire)"
                     if args.aed_train_steps > 0 else
                     "random weights = WORST-CASE finals (early-exit "
                     "never fires: no eos). Run --aed-train-steps for the "
                     "production-path arm."),
        }

    row = {
        "metric": "serving_realtime_streams_per_chip",
        "ctc_engine": ctc_row,
        "rnnt_engine": rnnt_row,
        "aed_engine": aed_row,
        "engine_streams_realtime": (round(eng_streams, 1)
                                    if eng_streams else None),
        "naive_streams_realtime": (round(naive_streams, 2)
                                   if naive_streams else None),
        "speedup": (round(eng_streams / naive_streams, 1)
                    if eng_streams and naive_streams else None),
        "engine_frames_per_sec": round(eng_fps, 1) if eng_fps else None,
        "engine_history": prod_mode,
        "engine_history_ab": {
            m: [round(r, 1) for r in rs] for m, rs in mode_rates.items()
        },
        "epoch_frames_per_sec": [round(r, 1) for r in epoch_rates],
        "capacity": args.capacity,
        "tick_frames": args.tick_frames,
        "partial_every": args.partial_every,
        "feature_path": args.feature_path,
        "defer_absorb": args.defer_absorb,
        "utt_seconds": args.utt_seconds,
        "gmm": f"{S}x{K}x{D}",
        "backend": jax.default_backend(),
        "note": "streams = frames/s / 100; lifecycle (start/end/drain/"
                "finalize) and periodic partial backtraces included; "
                "sliding CMVN (streaming-compatible)",
    }
    out_path = (os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             args.out) if args.out else OUT)
    with open(out_path, "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
