"""config[4]: full eval sweep — decode + WER + throughput, data-parallel.

Shards utterance batches over the ('data',) mesh (all visible chips), decodes
with the word-loop graph, reports WER, utterances/sec/chip and RTF
(SURVEY.md §3.5). Per-chunk hypothesis checkpointing makes a preempted sweep
resumable (SURVEY.md §5 failure-handling row)."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from cli.common import add_corpus_args, add_run_args, load_corpus, make_logger
from cli.score import load_or_random_gmm
from mogasr.config import BatchConfig, DecodeConfig, FrontendConfig, MeshConfig, TopologyConfig
from mogasr.eval.wer import corpus_wer
from mogasr.hmm.topology import build_topology
from mogasr.pipeline import decode_batch, featurize, score_batch, word_decode_graph
from mogasr.utils.metrics import Timer, trace


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the (POV, centered log-f0, delta log-f0) pitch "
                        "triple to the features (frontend/pitch.py) — must "
                        "match between training and decoding")
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--gmm-ckpt")
    p.add_argument("--bundle", metavar="DIR",
                   help="trained-system bundle dir (e.g. benchmarks/headline): "
                        "loads GMM + lexicon + topology + tied triphones + "
                        "frontend config; decodes with the CD word-loop graph")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--fmllr", action="store_true",
                   help="unsupervised two-pass per-speaker fMLLR adaptation "
                        "(single-chip path; hypothesis resume granularity is "
                        "the whole sweep, since the transforms depend on all "
                        "of a speaker's utterances)")
    p.add_argument("--mllr", action="store_true",
                   help="unsupervised two-pass per-speaker MLLR (model-space "
                        "mean) adaptation; same resume granularity as --fmllr")
    p.add_argument("--vtln", action="store_true",
                   help="unsupervised two-pass per-speaker VTLN warp "
                        "estimation (grid search over warped mel frontends)")
    p.add_argument("--consensus", action="store_true",
                   help="confusion-network consensus (MBR) decoding instead "
                        "of Viterbi 1-best: bigram lattice pass -> CN -> "
                        "argmax per slot")
    p.add_argument("--ctc", action="store_true",
                   help="evaluate a BPE-CTC neural AM (lexicon-free greedy "
                        "word decoding) instead of the GMM system: requires "
                        "--bpe and --nn-ckpt; same DP sharding + per-chunk "
                        "resume")
    p.add_argument("--rnnt", action="store_true",
                   help="evaluate a BPE-RNNT checkpoint (train_nn "
                        "--objective rnnt --bpe-merges): single-dispatch "
                        "device-greedy transducer decode per sharded batch "
                        "through the same resume/metrics protocol")
    p.add_argument("--rnnt-pred", default="stateless",
                   choices=["stateless", "lstm"],
                   help="RNN-T prediction-net arch — must match the ckpt")
    p.add_argument("--rnnt-plain", action="store_true",
                   help="the RNN-T ckpt was trained WITHOUT the aux CTC head")
    p.add_argument("--rnnt-beam", type=int, default=0, metavar="N",
                   help="with --rnnt: sweep with the ON-DEVICE monotonic "
                        "beam scan (rnnt_beam_decode_device, identical "
                        "N-best to the per-utterance reference) instead of "
                        "device-greedy — the quality-path decode through "
                        "the same sharding/resume protocol")
    p.add_argument("--rnnt-pruned", action="store_true",
                   help="ckpt trained with the pruned transducer loss "
                        "(train_nn --rnnt-pruned-band): tree has the "
                        "factored simple_am/simple_lm heads")
    p.add_argument("--am", default="gmm",
                   choices=["gmm", "mlp", "lstm", "blstm", "tdnn",
                            "conformer", "moe"],
                   help="acoustic model for the standard word-loop sweep: "
                        "gmm (default) or a trained HYBRID frame classifier "
                        "(needs --nn-ckpt; incompatible with --bundle and the "
                        "GMM adaptation flags)")
    p.add_argument("--nn-precision", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="hybrid-AM inference precision (mogasr.am.quantize)")
    p.add_argument("--aed", action="store_true",
                   help="evaluate a BPE-AED checkpoint (train_nn --objective "
                        "aed --bpe-merges): on-device batched beam search")
    p.add_argument("--aed-beam", type=int, default=4)
    p.add_argument("--aed-max-tokens", type=int, default=48)
    p.add_argument("--bpe", metavar="FILE",
                   help="bpe.json (with --ctc/--rnnt/--aed)")
    p.add_argument("--nn-ckpt",
                   help="NN checkpoint dir (with --ctc/--rnnt/--aed)")
    p.add_argument("--nn-arch", default="lstm",
                   choices=["mlp", "lstm", "blstm", "tdnn", "conformer"])
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    p.add_argument("--nn-experts", type=int, default=4,
                   help="with --am moe: expert count — must match training")
    p.add_argument("--streaming", action="store_true",
                   help="extract features through the chunked streaming front "
                        "end (BASELINE config[4]) instead of the offline batch path")
    p.add_argument("--chunk-ms", type=float, default=500.0,
                   help="streaming chunk size in milliseconds")
    args = p.parse_args()

    import jax

    from mogasr.dist import mesh as M

    nf_flags = [f for f, on in
                (("--ctc", args.ctc), ("--rnnt", args.rnnt),
                 ("--aed", args.aed)) if on]
    if len(nf_flags) > 1:
        raise SystemExit(f"pick one of {'/'.join(nf_flags)}")
    if nf_flags and (args.fmllr or args.mllr or args.vtln or args.consensus
                     or args.bundle):
        raise SystemExit(f"{nf_flags[0]} is lexicon-free decoding: "
                         "incompatible with GMM adaptation/consensus/bundle")
    if nf_flags and not (args.bpe and args.nn_ckpt):
        raise SystemExit(f"{nf_flags[0]} requires --bpe and --nn-ckpt")

    if args.am != "gmm":
        if not args.nn_ckpt:
            raise SystemExit("--am mlp/lstm/... requires --nn-ckpt")
        if args.fmllr or args.mllr or args.vtln:
            raise SystemExit("--fmllr/--mllr/--vtln are GMM adaptation: "
                             "incompatible with a hybrid --am")
        if args.bundle:
            raise SystemExit("--bundle carries a GMM system: incompatible "
                             "with a hybrid --am")
        if nf_flags:
            raise SystemExit("--ctc/--rnnt/--aed are lexicon-free sweeps: "
                             "use them without --am")
    hybrid_score = None
    bundle = None
    if args.bundle:
        from mogasr.utils.bundle import load_system

        bundle = load_system(args.bundle)
    corpus, lex = load_corpus(args)
    if bundle is not None:
        _gmm_b, topo, fcfg, _tied_b, _bmeta = bundle
        lex = topo.lexicon
    else:
        fcfg = FrontendConfig(add_pitch=args.add_pitch)
        topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(
        acoustic_scale=args.acoustic_scale,
        word_insertion_penalty=args.insertion_penalty,
    )
    logger = make_logger(args)
    mesh = M.make_mesh(MeshConfig())
    n_chips = mesh.devices.size

    # batch size must divide over chips
    bcfg = BatchConfig(batch_size=16 * n_chips)  # 16/chip amortizes dispatch
    if args.streaming:
        from mogasr.pipeline import featurize_streaming

        chunk = int(fcfg.sample_rate * args.chunk_ms / 1000.0)
        batches = featurize_streaming(corpus, fcfg, bcfg, chunk_samples=chunk)
    else:
        batches = featurize(corpus, fcfg, bcfg)
    # lexicon-free neural families share one slot: (bpe, decode_units) where
    # decode_units(sharded feats, sharded n_frames, fb) -> unit-id sequences
    neural = None
    if nf_flags:
        from mogasr.config import TrainConfig
        from mogasr.data.bpe import load_bpe
        from mogasr.utils.checkpoint import restore_checkpoint

        bpe = load_bpe(args.bpe)
        tcfg = TrainConfig(nn_arch=args.nn_arch, nn_hidden=args.nn_hidden,
                           nn_layers=args.nn_layers)
        if args.ctc:
            from mogasr.am.train_nn import build_model, init_train_state

            nn_model = build_model(args.nn_arch, bpe.n_units + 1, tcfg)
            template = {
                "params": init_train_state(
                    nn_model, tcfg, fcfg.feat_dim, jax.random.key(0)
                ).params,
            }
            nn_params = M.replicate(
                restore_checkpoint(args.nn_ckpt, template)["params"], mesh
            )

            from mogasr.am.ctc import ctc_collapse_frames, make_ctc_frames_fn

            # carries the production routing: Conformer decodes at its
            # native 25 Hz rate, and the greedy argmax is fused into the
            # forward dispatch (one dispatch and one small pull per batch)
            _ctc_frames = make_ctc_frames_fn(nn_model, nn_params)

            def decode_units(feats, n_frames, fb):
                frames, n_dec = _ctc_frames(feats, n_frames)
                return ctc_collapse_frames(frames, n_dec, bpe.n_units)
        elif args.rnnt:
            from mogasr.am.rnnt import (
                build_rnnt_model, init_rnnt_train_state,
                rnnt_greedy_decode_device,
            )

            if args.nn_arch not in ("lstm", "blstm"):
                raise SystemExit("--rnnt needs --nn-arch lstm/blstm")
            nn_model = build_rnnt_model(
                bpe.n_units, tcfg, encoder_arch=args.nn_arch,
                pred_arch=args.rnnt_pred, aux_ctc=not args.rnnt_plain,
                simple_heads=args.rnnt_pruned,
            )
            template = {
                "params": init_rnnt_train_state(
                    nn_model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)
                ).params,
            }
            nn_params = M.replicate(
                restore_checkpoint(args.nn_ckpt, template)["params"], mesh
            )

            if args.rnnt_beam > 0:
                # the fully on-device beam scan (round 5) — one dispatch
                # per sharded batch; ranked lists equal the per-utterance
                # reference (tests/test_rnnt_device_beam.py)
                from mogasr.am.rnnt import rnnt_beam_decode_device

                def decode_units(feats, n_frames, fb,
                                 _m=nn_model, _p=nn_params):
                    ranked = rnnt_beam_decode_device(
                        _m, _p, feats, n_frames, beam_size=args.rnnt_beam)
                    return [r[0][1] if r else [] for r in ranked]
            else:
                def decode_units(feats, n_frames, fb,
                                 _m=nn_model, _p=nn_params):
                    return rnnt_greedy_decode_device(_m, _p, feats, n_frames)
        else:
            import numpy as _np

            from mogasr.am.aed import (
                build_aed_model, init_aed_train_state, make_aed_decoder,
            )

            nn_model = build_aed_model(bpe.n_units, tcfg)
            template = {
                "params": init_aed_train_state(
                    nn_model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)
                ).params,
            }
            nn_params = M.replicate(
                restore_checkpoint(args.nn_ckpt, template)["params"], mesh
            )
            aed_dec = make_aed_decoder(
                nn_model, nn_params, beam=args.aed_beam,
                max_tokens=args.aed_max_tokens,
            )

            def decode_units(feats, n_frames, fb, _d=aed_dec):
                toks, n_toks, _ = (
                    _np.asarray(a) for a in _d(feats, n_frames)
                )
                return [
                    list(map(int, toks[b, : n_toks[b]]))
                    for b in range(len(toks))
                ]
        neural = (bpe, decode_units)
        gmm = graph = None
    else:
        if args.am != "gmm":
            import jax.numpy as jnp

            from mogasr.am.neural import build_model, posteriors_to_loglik
            from mogasr.am.quantize import make_quantized_logits
            from mogasr.am.train_nn import init_train_state
            from mogasr.config import TrainConfig
            from mogasr.utils.checkpoint import restore_checkpoint

            tcfg_h = TrainConfig(nn_arch=args.am, nn_hidden=args.nn_hidden,
                                 nn_layers=args.nn_layers,
                                 nn_experts=args.nn_experts)
            nn_model_h = build_model(args.am, topo.n_pdfs, tcfg_h)
            template_h = {
                "params": init_train_state(
                    nn_model_h, tcfg_h, fcfg.feat_dim, jax.random.key(0)
                ).params,
                "log_priors": jnp.zeros(topo.n_pdfs),
            }
            ck_h = restore_checkpoint(args.nn_ckpt, template_h)
            nn_params_h = M.replicate(ck_h["params"], mesh)
            log_priors_h = M.replicate(jnp.asarray(ck_h["log_priors"]), mesh)
            logits_fn_h = make_quantized_logits(
                nn_model_h, nn_params_h, args.nn_precision)

            @jax.jit
            def hybrid_score(feats, n_frames):
                return posteriors_to_loglik(
                    logits_fn_h(feats, n_frames), log_priors_h)

            gmm = None
        else:
            gmm = (bundle[0] if bundle is not None
                   else load_or_random_gmm(args, fcfg.feat_dim))
            gmm = M.replicate(gmm, mesh)
        if bundle is not None and bundle[3] is not None:
            from mogasr.hmm.triphone import word_loop_graph_cd

            graph = word_loop_graph_cd(
                bundle[3], insertion_penalty=dcfg.word_insertion_penalty)
        else:
            graph = word_decode_graph(lex, topo, dcfg)

    resume_path = os.path.join(args.run_dir, "eval_hyps.jsonl")
    done = set()
    if os.path.exists(resume_path):
        with open(resume_path) as f:
            done = {json.loads(line)["utt_id"] for line in f}

    refs, hyps = [], []
    audio_sec = sum(len(w) for _, w, _ in corpus) / fcfg.sample_rate
    prof_dir = os.path.join(args.run_dir, "profile") if args.profile else None
    with trace(prof_dir), Timer() as t:
        if args.fmllr or args.mllr or args.vtln:
            from mogasr.pipeline import (
                decode_with_fmllr, decode_with_mllr, decode_with_vtln,
            )

            if args.vtln:
                two_pass = lambda b, g, l, t, d: decode_with_vtln(
                    corpus, g, l, t, fcfg, bcfg, d
                )
            else:
                two_pass = decode_with_fmllr if args.fmllr else decode_with_mllr
            all_ids = {u for fb in batches for u in fb.utt_ids}
            if not all_ids <= done:  # skip the two-pass decode when complete
                hyp_map, _transforms = two_pass(batches, gmm, lex, topo, dcfg)
                with open(resume_path, "a") as out_f:
                    for fb in batches:
                        for b in range(fb.size):
                            uid = fb.utt_ids[b]
                            if uid in done:
                                continue
                            out_f.write(json.dumps({
                                "utt_id": uid, "ref": fb.words[b],
                                "hyp": hyp_map[uid],
                            }) + "\n")
                    out_f.flush()
        else:
            if args.consensus:
                from mogasr.decoder.confusion import (
                    confusion_network, consensus_decode,
                )
                from mogasr.lm.ngram import estimate_bigram
                from mogasr.pipeline import decode_batch_lattices

                transcripts = [fb.words[b] for fb in batches for b in range(fb.size)]
                cn_lm = estimate_bigram(transcripts, sorted(set(graph.labels)))
            with open(resume_path, "a") as out_f:
                for fb in batches:
                    if all(u in done for u in fb.utt_ids):
                        continue
                    feats = jax.device_put(fb.feats, M.data_sharding(mesh))
                    if neural is not None:
                        bpe, decode_units = neural
                        nf_s = jax.device_put(
                            fb.n_frames, M.data_sharding(mesh))
                        out = [
                            bpe.decode(seq)
                            for seq in decode_units(feats, nf_s, fb)
                        ]
                        for b in range(fb.size):
                            out_f.write(json.dumps({
                                "utt_id": fb.utt_ids[b],
                                "ref": fb.words[b], "hyp": out[b],
                            }) + "\n")
                        out_f.flush()
                        continue
                    if hybrid_score is not None:
                        nf_h = jax.device_put(
                            fb.n_frames, M.data_sharding(mesh))
                        scores = hybrid_score(feats, nf_h)
                    else:
                        scores = score_batch(feats, gmm)
                    if args.consensus:
                        lats, _ = decode_batch_lattices(fb, scores, graph, cn_lm, dcfg)
                        out = [
                            consensus_decode(confusion_network(lat, cn_lm))[0]
                            for lat in lats
                        ]
                    else:
                        out = decode_batch(fb, scores, graph, dcfg)
                    for b in range(fb.size):
                        out_f.write(json.dumps({
                            "utt_id": fb.utt_ids[b],
                            "ref": fb.words[b], "hyp": out[b],
                        }) + "\n")
                    out_f.flush()

    seen = set()
    with open(resume_path) as f:
        for line in f:
            rec = json.loads(line)
            # a batch interrupted mid-write is re-decoded in full on resume,
            # so the file may contain duplicates — first occurrence wins
            if rec["utt_id"] in seen:
                continue
            seen.add(rec["utt_id"])
            refs.append([w.lower() for w in rec["ref"]])
            hyps.append([w.lower() for w in rec["hyp"]])
    wer, counts = corpus_wer(refs, hyps)
    logger.log({
        "stage": "eval", "split": args.split, "n_chips": n_chips,
        "utts": len(refs), "wer": wer,
        "sub": counts.substitutions, "dels": counts.deletions,
        "ins": counts.insertions,
        "wall_sec": t.seconds,
        "utts_per_sec_per_chip": len(refs) / t.seconds / n_chips,
        "rtf": t.seconds / max(audio_sec, 1e-9),
    })


if __name__ == "__main__":
    main()
