"""Transcribe a long recording: VAD segmentation -> decode -> timestamps.

The end-user entry point tying the full stack together: energy VAD splits the
recording into utterance-sized segments, each segment runs through the fused
front end + acoustic scorer + word-loop Viterbi, and the output is a
timestamped transcript (JSON lines: start/end seconds, words).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from cli.common import add_run_args, make_logger
from cli.score import load_or_random_gmm
from mogasr.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr.frontend.vad import VadConfig, segment_utterances
from mogasr.hmm.lexicon import load_lexicon, synthetic_lexicon
from mogasr.hmm.topology import build_topology
from mogasr.pipeline import (
    decode_batch_with_confidence, featurize, score_batch, word_decode_graph,
)
from mogasr.utils.metrics import Timer


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_run_args(p)
    p.add_argument("--audio", help="wav file to transcribe")
    p.add_argument("--synthetic-demo", action="store_true",
                   help="transcribe a generated long recording instead of a file")
    p.add_argument("--lexicon", help="Kaldi-style lexicon.txt (default: synthetic)")
    p.add_argument("--gmm-ckpt", help="orbax GMM checkpoint dir")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--ctc", action="store_true",
                   help="use a CTC acoustic model (train_nn --objective ctc "
                        "ckpt via --nn-ckpt) through the CTC-topology word "
                        "graph instead of the GMM")
    p.add_argument("--rnnt", action="store_true",
                   help="use an RNN-transducer (train_nn --objective rnnt "
                        "ckpt via --nn-ckpt, encoder --nn-arch lstm/blstm): "
                        "single-dispatch device-greedy decode per VAD "
                        "segment; outputs phones (or words with --bpe) with "
                        "segment timestamps — no per-word times (transducer "
                        "emissions have no frame alignment)")
    p.add_argument("--rnnt-pred", default="stateless",
                   choices=["stateless", "lstm"],
                   help="RNN-T prediction-net arch — must match the ckpt")
    p.add_argument("--rnnt-plain", action="store_true",
                   help="RNN-T ckpt trained WITHOUT the aux CTC head")
    p.add_argument("--rnnt-pruned", action="store_true",
                   help="ckpt trained with the pruned transducer loss "
                        "(train_nn --rnnt-pruned-band): tree has the "
                        "factored simple_am/simple_lm heads")
    p.add_argument("--aed", action="store_true",
                   help="use an attention encoder-decoder (train_nn "
                        "--objective aed ckpt via --nn-ckpt): beam-search "
                        "decode per VAD segment; outputs phones (or words "
                        "with --bpe) with segment timestamps — no per-word "
                        "times/confidences (no frame alignment)")
    p.add_argument("--bpe", metavar="FILE",
                   help="with --aed/--rnnt: BPE inventory (bpe.json) -> "
                        "word output; "
                        "with --ctc: LEXICON-FREE open-vocabulary "
                        "transcription (train_nn --objective ctc "
                        "--bpe-merges ckpt) — word timestamps from the "
                        "greedy emission frames, confidences from the "
                        "frame posteriors")
    p.add_argument("--aed-beam", type=int, default=4)
    p.add_argument("--aed-ctc-weight", type=float, default=0.3)
    p.add_argument("--aed-max-tokens", type=int, default=64)
    p.add_argument("--aed-chunk", type=int, default=0,
                   help="checkpoint trained with train_nn --aed-chunk C: "
                        "decode with the matching chunk mask")
    p.add_argument("--aed-left-chunks", type=int, default=1)
    p.add_argument("--nn-ckpt", help="CTC/RNN-T/AED checkpoint dir (with "
                        "--ctc/--rnnt/--aed)")
    p.add_argument("--nn-arch", default="mlp",
                   choices=["mlp", "lstm", "blstm", "tdnn", "conformer"])
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--max-segment-s", type=float, default=30.0)
    p.add_argument("--nbest", type=int, default=0,
                   help="also emit the top-N alternative word sequences per "
                        "segment from a word lattice (uniform word LM)")
    p.add_argument("--diarize", action="store_true",
                   help="also diarize the recording (per-recording UBM+TV "
                        "i-vector clustering, mogasr.diarize trained on the "
                        "recording's own VAD speech) and tag every segment "
                        "with a speaker label")
    p.add_argument("--num-speakers", type=int, default=0,
                   help="with --diarize: known speaker count (0 = find it "
                        "by the AHC distance threshold)")
    p.add_argument("--diarize-components", type=int, default=16)
    p.add_argument("--diarize-rank", type=int, default=8)
    p.add_argument("--out", help="write transcript (jsonl)")
    p.add_argument("--ctm", help="also write a CTM file (standard scoring "
                                 "format: utt channel start dur word conf)")
    args = p.parse_args()

    fcfg = FrontendConfig()
    if args.synthetic_demo:
        from mogasr.data.synthetic import make_corpus

        utts = make_corpus(4, words_per_utt=(2, 3), seed=5)
        gap = np.zeros(16000, np.float32)
        wave = np.concatenate(sum(([u.wave, gap] for u in utts), [gap]))
        sr = fcfg.sample_rate
    elif args.audio:
        from mogasr.data.audio import read_audio

        wave, sr = read_audio(args.audio, target_sr=fcfg.sample_rate)
    else:
        raise SystemExit("pass --audio FILE or --synthetic-demo")

    lex = load_lexicon(args.lexicon) if args.lexicon else synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(
        acoustic_scale=args.acoustic_scale,
        word_insertion_penalty=args.insertion_penalty,
    )
    if sum((args.aed, args.ctc, args.rnnt)) > 1:
        raise SystemExit("--aed/--ctc/--rnnt are different acoustic models")
    if args.rnnt and (args.nbest or args.ctm):
        raise SystemExit("--rnnt has no word lattice/alignment: "
                         "incompatible with --nbest/--ctm")
    if args.aed and (args.nbest or args.ctm):
        raise SystemExit("--aed has no word lattice/alignment: "
                         "incompatible with --nbest/--ctm")
    if args.ctc and args.bpe and args.nbest:
        raise SystemExit("--ctc --bpe is lexicon-free greedy decoding "
                         "(no lattice): incompatible with --nbest")
    if args.aed:
        import jax

        from mogasr.am.aed import (
            aed_decode_batch, build_aed_model, init_aed_train_state,
        )
        from mogasr.config import TrainConfig
        from mogasr.utils.checkpoint import restore_checkpoint

        if not args.nn_ckpt:
            raise SystemExit("--aed requires --nn-ckpt")
        if args.bpe:
            from mogasr.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
            n_units = bpe.n_units
        else:
            bpe = None
            n_units = lex.n_phones
        tcfg = TrainConfig(nn_hidden=args.nn_hidden, nn_layers=args.nn_layers)
        aed_model = build_aed_model(
            n_units, tcfg, chunk_frames=args.aed_chunk,
            left_chunks=args.aed_left_chunks,
        )
        template = {
            "params": init_aed_train_state(
                aed_model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)
            ).params,
        }
        aed_params = restore_checkpoint(args.nn_ckpt, template)["params"]
        gmm = None
    elif args.rnnt:
        import jax

        from mogasr.am.rnnt import (
            build_rnnt_model, init_rnnt_train_state, rnnt_greedy_decode_device,
        )
        from mogasr.config import TrainConfig
        from mogasr.utils.checkpoint import restore_checkpoint

        if not args.nn_ckpt:
            raise SystemExit("--rnnt requires --nn-ckpt")
        if args.nn_arch not in ("lstm", "blstm"):
            raise SystemExit("--rnnt needs --nn-arch lstm/blstm")
        if args.bpe:
            from mogasr.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
            n_units = bpe.n_units
        else:
            bpe = None
            n_units = lex.n_phones
        tcfg = TrainConfig(nn_arch=args.nn_arch, nn_hidden=args.nn_hidden,
                           nn_layers=args.nn_layers)
        rnnt_model = build_rnnt_model(
            n_units, tcfg, encoder_arch=args.nn_arch,
            pred_arch=args.rnnt_pred, aux_ctc=not args.rnnt_plain,
            simple_heads=args.rnnt_pruned,
        )
        template = {
            "params": init_rnnt_train_state(
                rnnt_model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)
            ).params,
        }
        rnnt_params = restore_checkpoint(args.nn_ckpt, template)["params"]
        gmm = None
    elif args.ctc:
        import jax

        from mogasr.am.ctc import make_ctc_scorer
        from mogasr.am.neural import build_model
        from mogasr.am.train_nn import init_train_state
        from mogasr.config import TrainConfig
        from mogasr.utils.checkpoint import restore_checkpoint

        if not args.nn_ckpt:
            raise SystemExit("--ctc requires --nn-ckpt")
        if args.bpe:
            from mogasr.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
            n_ctc_units = bpe.n_units
        else:
            bpe = None
            n_ctc_units = lex.n_phones
        tcfg = TrainConfig(nn_arch=args.nn_arch, nn_hidden=args.nn_hidden,
                           nn_layers=args.nn_layers)
        nn_model = build_model(args.nn_arch, n_ctc_units + 1, tcfg)
        template = {
            "params": init_train_state(
                nn_model, tcfg, fcfg.feat_dim, jax.random.key(0)
            ).params,
        }
        nn_params = restore_checkpoint(args.nn_ckpt, template)["params"]
        ctc_scorer = make_ctc_scorer(nn_model, nn_params)
        # One jitted logits closure built outside the batch loop, so the
        # forward is one dispatch per batch.
        nn_logits_fn = jax.jit(
            lambda feats, nf: nn_model.apply(nn_params, feats, nf))
        gmm = None
    else:
        gmm = load_or_random_gmm(args, fcfg.feat_dim)
    logger = make_logger(args)

    with Timer() as t:
        segments = segment_utterances(
            wave, fcfg, VadConfig(max_segment_s=args.max_segment_s)
        )
        corpus = [
            (f"seg-{i:04d}", wave[a:b], []) for i, (a, b) in enumerate(segments)
        ]
        results = []
        if corpus:
            if args.aed or args.rnnt or (args.ctc and args.bpe):
                graph = None
            elif args.ctc:
                from mogasr.am.ctc import ctc_decode_graph

                graph = ctc_decode_graph(lex, dcfg)
            else:
                graph = word_decode_graph(lex, topo, dcfg)
            # bucket ceilings must cover max_segment_s, or make_batches would
            # silently drop segments between the default 20 s ceiling and the
            # VAD cap
            max_frames = int(args.max_segment_s * 1000 / fcfg.frame_shift_ms) + 10
            bcfg = BatchConfig(
                bucket_boundaries=tuple(
                    sorted({500, 1000, 2000, max_frames})
                )
            )
            if args.nbest > 0:
                from mogasr.decoder.lattice import lattice_nbest
                from mogasr.lm.ngram import uniform_bigram
                from mogasr.pipeline import decode_batch_lattices

                nbest_lm = uniform_bigram(sorted(set(graph.labels)))
            shift_s = fcfg.frame_shift_ms / 1000.0
            for fb in featurize(corpus, fcfg, bcfg):
                if args.aed:
                    seqs = aed_decode_batch(
                        aed_model, aed_params, fb.feats, fb.n_frames,
                        beam=args.aed_beam, max_tokens=args.aed_max_tokens,
                        ctc_weight=args.aed_ctc_weight,
                    )
                    for b in range(fb.size):
                        idx = int(fb.utt_ids[b].split("-")[1])
                        a, e = segments[idx]
                        results.append({
                            "start_s": round(a / fcfg.sample_rate, 2),
                            "end_s": round(e / fcfg.sample_rate, 2),
                            "words": (bpe.decode(seqs[b]) if bpe
                                      else [lex.phones[u] for u in seqs[b]]),
                        })
                    continue
                if args.rnnt:
                    seqs = rnnt_greedy_decode_device(
                        rnnt_model, rnnt_params, fb.feats, fb.n_frames)
                    for b in range(fb.size):
                        idx = int(fb.utt_ids[b].split("-")[1])
                        a, e = segments[idx]
                        results.append({
                            "start_s": round(a / fcfg.sample_rate, 2),
                            "end_s": round(e / fcfg.sample_rate, 2),
                            "words": (bpe.decode(seqs[b]) if bpe
                                      else [lex.phones[u] for u in seqs[b]]),
                        })
                    continue
                if args.ctc and args.bpe:
                    # lexicon-free: greedy units with emission frames ->
                    # BPE word spans -> absolute word timestamps
                    from mogasr.am.ctc import ctc_greedy_decode_with_frames

                    logits = nn_logits_fn(fb.feats, fb.n_frames)
                    maxp = np.asarray(
                        jax.numpy.max(jax.nn.softmax(logits, axis=-1),
                                      axis=-1))
                    pairs_all = ctc_greedy_decode_with_frames(
                        logits, fb.n_frames)
                    for b in range(fb.size):
                        idx = int(fb.utt_ids[b].split("-")[1])
                        a, e = segments[idx]
                        seg_start = a / fcfg.sample_rate
                        pairs = pairs_all[b]
                        spans = bpe.decode_with_spans([u for u, _ in pairs])
                        results.append({
                            "start_s": round(seg_start, 2),
                            "end_s": round(e / fcfg.sample_rate, 2),
                            "words": [w for w, _i0, _i1 in spans],
                            # mean best-path posterior over the word's
                            # emission frames
                            "confidences": [
                                round(float(np.mean(
                                    [maxp[b, pairs[i][1]]
                                     for i in range(i0, i1 + 1)])), 3)
                                for _w, i0, i1 in spans
                            ],
                            "word_times": [
                                [round(seg_start + pairs[i0][1] * shift_s, 2),
                                 round(seg_start
                                       + (pairs[i1][1] + 1) * shift_s, 2)]
                                for _w, i0, i1 in spans
                            ],
                        })
                    continue
                scores = ctc_scorer(fb) if args.ctc else score_batch(fb.feats, gmm)
                out = decode_batch_with_confidence(
                    fb, scores, graph, dcfg, with_times=True
                )
                nbests = None
                if args.nbest > 0:
                    lats, _res = decode_batch_lattices(
                        fb, scores, graph, nbest_lm, dcfg
                    )
                    nbests = [
                        [{"words": h, "logp": s}
                         for h, s in lattice_nbest(lat, nbest_lm, args.nbest)]
                        for lat in lats
                    ]
                for b in range(fb.size):
                    idx = int(fb.utt_ids[b].split("-")[1])
                    a, e = segments[idx]
                    seg_start = a / fcfg.sample_rate
                    rec = {
                        "start_s": round(seg_start, 2),
                        "end_s": round(e / fcfg.sample_rate, 2),
                        "words": [w for w, _c, _t0, _t1 in out[b]],
                        "confidences": [c for _w, c, _t0, _t1 in out[b]],
                        # per-word absolute timestamps from the Viterbi spans
                        "word_times": [
                            [round(seg_start + t0 * shift_s, 2),
                             round(seg_start + t1 * shift_s, 2)]
                            for _w, _c, t0, t1 in out[b]
                        ],
                    }
                    if nbests is not None:
                        rec["nbest"] = nbests[b]
                    results.append(rec)
        if args.diarize and results:
            from mogasr.diarize import diarize_wave, train_diarizer

            seg_utts = [
                (f"d-{i:04d}", wave[a:b], [])
                for i, (a, b) in enumerate(segments)
            ]
            ubm, t_mat = train_diarizer(
                seg_utts, fcfg, n_components=args.diarize_components,
                rank=args.diarize_rank,
            )
            turns = diarize_wave(
                wave, fcfg, ubm, t_mat,
                n_speakers=args.num_speakers or None,
            )
            for r in results:
                overlap = {}
                for t0, t1, spk in turns:
                    o = min(r["end_s"], t1) - max(r["start_s"], t0)
                    if o > 0:
                        overlap[spk] = overlap.get(spk, 0.0) + o
                r["speaker"] = (max(overlap, key=overlap.get)
                                if overlap else None)
    results.sort(key=lambda r: r["start_s"])
    logger.log({
        "stage": "transcribe", "audio_s": round(len(wave) / fcfg.sample_rate, 1),
        "segments": len(segments), "wall_sec": t.seconds,
        "rtf": t.seconds / max(len(wave) / fcfg.sample_rate, 1e-9),
    })
    lines = [json.dumps(r) for r in results]
    if args.ctm:
        with open(args.ctm, "w") as f:
            for r in results:
                for w, c, (t0, t1) in zip(
                    r["words"], r["confidences"], r["word_times"]
                ):
                    f.write(
                        f"rec 1 {t0:.2f} {max(t1 - t0, 0.01):.2f} {w} {c:.3f}\n"
                    )
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    else:
        print("\n".join(lines))


if __name__ == "__main__":
    main()
