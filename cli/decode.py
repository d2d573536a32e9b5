"""Free decode (word-loop or phone-loop) with the GMM or neural AM.

Covers the decode sides of configs [2] and [3]: frame-synchronous Viterbi on
device, hypotheses + WER if transcripts are available."""

from __future__ import annotations

import argparse
import json

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from cli.common import add_corpus_args, add_run_args, load_corpus, make_logger
from cli.score import load_or_random_gmm
from mogasr.config import BatchConfig, DecodeConfig, FrontendConfig, TopologyConfig
from mogasr.eval.wer import corpus_wer
from mogasr.hmm import graph as gr
from mogasr.hmm.topology import build_topology
from mogasr.pipeline import decode_batch, featurize, score_batch, word_decode_graph
from mogasr.utils.metrics import Timer


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the (POV, centered log-f0, delta log-f0) pitch "
                        "triple to the features (frontend/pitch.py) — must "
                        "match between training and decoding")
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--gmm-ckpt", help="orbax GMM checkpoint dir")
    p.add_argument("--bundle", metavar="DIR",
                   help="trained-system bundle dir (utils/bundle.py, e.g. "
                        "benchmarks/headline): loads GMM + lexicon + topology "
                        "+ tied triphones + frontend config, overriding "
                        "--gmm-ckpt/--lexicon/--num-*")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--am", default="gmm",
                   choices=["gmm", "mlp", "lstm", "blstm", "tdnn",
                            "conformer", "moe"],
                   help="acoustic model: GMM or a trained neural classifier")
    p.add_argument("--nn-ckpt", help="orbax NN checkpoint dir (from train_nn)")
    p.add_argument("--ctc", action="store_true",
                   help="the NN checkpoint is a CTC model (train_nn "
                        "--objective ctc): posterior scoring over phones+blank, "
                        "CTC-topology decode graph (word mode) or greedy "
                        "best-path phone decode (phone mode)")
    p.add_argument("--rnnt", action="store_true",
                   help="the NN checkpoint is an RNN-transducer (train_nn "
                        "--objective rnnt): frame-synchronous greedy decode "
                        "over phones (--mode phone) or BPE words (--bpe; "
                        "--am lstm/blstm picks the encoder)")
    p.add_argument("--aed", action="store_true",
                   help="the NN checkpoint is an attention encoder-decoder "
                        "(train_nn --objective aed): on-device beam search "
                        "over the Conformer+decoder (--mode phone, or word "
                        "with --bpe; --nn-hidden/--nn-layers must match "
                        "training; --am is ignored)")
    p.add_argument("--aed-beam", type=int, default=4,
                   help="beam width of the AED decoder")
    p.add_argument("--aed-ctc-weight", type=float, default=0.3,
                   help="joint decoding: rescore final AED beams with the "
                        "encoder CTC head at this weight (0 = attention only)")
    p.add_argument("--aed-max-tokens", type=int, default=64,
                   help="token budget of the jitted AED beam search")
    p.add_argument("--aed-chunk", type=int, default=0,
                   help="the checkpoint was trained with train_nn "
                        "--aed-chunk C (streaming-capable chunked encoder): "
                        "decode with the SAME chunk mask — a chunk-trained "
                        "checkpoint decoded globally is a silent "
                        "train/test mismatch")
    p.add_argument("--aed-left-chunks", type=int, default=1,
                   help="left-context chunks (must match training)")
    p.add_argument("--ivector-ckpt", metavar="DIR",
                   help="i-vector extractor checkpoint (train_nn "
                        "--ivector-dim): append per-utterance i-vectors to "
                        "the features before the neural AM — must match "
                        "training or the input distribution silently shifts")
    p.add_argument("--ivector-dim", type=int, default=16)
    p.add_argument("--ivector-components", type=int, default=64)
    p.add_argument("--bias", metavar="FILE",
                   help="with --ctc --bpe, or --rnnt --rnnt-beam N "
                        "(BPE or phone units): contextual biasing — boost the "
                        "phrases in FILE (one per line) during prefix beam "
                        "search (shallow-fusion boosting with retraction; "
                        "mogasr.decoder.biasing)")
    p.add_argument("--bias-weight", type=float, default=2.0,
                   help="per-unit log-score boost of a live phrase match")
    p.add_argument("--bias-beam", type=int, default=8,
                   help="prefix beam width used with --bias/--fusion-lm")
    p.add_argument("--fusion-lm", metavar="FILE",
                   help="unit-bigram shallow fusion (train_lm --unit-ngram "
                        "writes unit_lm.npz): with --ctc --bpe in the prefix "
                        "beam (composes with --bias); with --aed --bpe as an "
                        "on-device [V,V] row gather inside the beam scan")
    p.add_argument("--fusion-weight", type=float, default=0.5,
                   help="LM weight for --fusion-lm")
    p.add_argument("--bpe", metavar="FILE",
                   help="with --ctc/--aed/--rnnt: the checkpoint was trained on BPE "
                        "subword units (train_nn --bpe-merges; FILE is its "
                        "bpe.json) — lexicon-free word decoding")
    p.add_argument("--rnnt-pred", default="stateless", choices=["stateless", "lstm"],
                   help="prediction-network architecture of the RNN-T "
                        "checkpoint (must match training)")
    p.add_argument("--rnnt-beam", type=int, default=0,
                   help="with --rnnt: monotonic beam search width (0 = the "
                        "single-dispatch device greedy). Supports "
                        "--fusion-lm over the model's units (phones, or "
                        "BPE with --bpe)")
    p.add_argument("--rnnt-plain", action="store_true",
                   help="the RNN-T checkpoint was trained WITHOUT the "
                        "auxiliary CTC head (train_rnnt aux_ctc=False)")
    p.add_argument("--rnnt-pruned", action="store_true",
                   help="the RNN-T checkpoint was trained with the pruned "
                        "loss (train_nn --rnnt-pruned-band): the tree has "
                        "the factored simple_am/simple_lm heads")
    p.add_argument("--nn-precision", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="neural-AM inference precision (hybrid --am mlp/"
                        "lstm/...): bfloat16 = half-precision params+activations "
                        "(any arch); int8 = dynamic-activation int8 GEMMs "
                        "(mlp and lstm) — mogasr.am.quantize; scoring "
                        "epilogue and Viterbi stay f32 in every mode")
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    p.add_argument("--nn-experts", type=int, default=4,
                   help="with --am moe: expert count — must match training")
    p.add_argument("--mode", default="word", choices=["word", "phone"])
    p.add_argument("--bigram-lm", action="store_true",
                   help="decode with a bigram word LM estimated from the "
                        "corpus transcripts (word mode only)")
    p.add_argument("--grammar", metavar="FILE",
                   help="FSA-style command-grammar decoding: FILE has one "
                        "allowed word sequence per line; hypotheses are "
                        "constrained to the grammar's adjacency graph "
                        "(word mode only)")
    p.add_argument("--multi-pron", action="store_true",
                   help="expand one decode chain per pronunciation variant "
                        "(lexicons with WORD(2) alternates)")
    p.add_argument("--trigram-rescore", action="store_true",
                   help="bigram first pass -> word lattice -> exact trigram "
                        "second pass (word mode only)")
    p.add_argument("--nbest", type=int, default=0,
                   help="emit the top-N word sequences per utterance from "
                        "the lattice into --out (implies a lattice pass)")
    p.add_argument("--arpa", help="read the second-pass rescoring LM from an "
                                  "ARPA file instead of estimating it "
                                  "(with --trigram-rescore)")
    p.add_argument("--write-arpa", help="export the estimated LM (trigram if "
                                        "--trigram-rescore, else bigram) as "
                                        "an ARPA file")
    p.add_argument("--errors-out", metavar="FILE",
                   help="write an sclite-style error report: per-utterance "
                        "REF/HYP alignments + top confusion pairs")
    p.add_argument("--ci", action="store_true",
                   help="report a bootstrap 95%% confidence interval for "
                        "the corpus WER (utterance resampling, 1000 reps)")
    p.add_argument("--lattice-out", metavar="FILE",
                   help="write the word lattices as a text archive "
                        "(mogasr.decoder.lattice.write_lattices; exact "
                        "score roundtrip via read_lattices) — implies the "
                        "lattice pass (word mode)")
    p.add_argument("--consensus", default="off", choices=["off", "cn", "mbr"],
                   help="minimum-Bayes-risk decoding over the word lattice: "
                        "cn = confusion-network consensus, mbr = N-best MBR "
                        "(expected-WER minimization); implies a lattice pass")
    p.add_argument("--nnlm-rescore", metavar="DIR",
                   help="second-pass NEURAL-LM rescoring: extract N-best "
                        "from the word lattice and re-rank with the LSTM LM "
                        "trained by cli/train_lm.py (DIR is its nnlm/ ckpt; "
                        "word mode only, implies a lattice pass)")
    p.add_argument("--nnlm-weight", type=float, default=0.5,
                   help="log-linear weight of the neural-LM score against "
                        "the first-pass lattice score")
    p.add_argument("--nnlm-nbest", type=int, default=16,
                   help="N-best depth fed to the neural rescorer")
    p.add_argument("--lm-smoothing", default="addalpha", choices=["addalpha", "kn"],
                   help="n-gram estimation: add-alpha or interpolated "
                        "Kneser-Ney (continuation counts)")
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--beam", type=float, default=0.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--out", help="write hypotheses (jsonl)")
    args = p.parse_args()

    bundle = None
    if args.bundle:
        from mogasr.utils.bundle import load_system

        bundle = load_system(args.bundle)
    corpus, lex = load_corpus(args)
    if bundle is not None:
        gmm_b, topo_b, fcfg, tied_b, _bmeta = bundle
        lex = topo_b.lexicon
        topo = topo_b
        missing = sorted(
            {w.lower() for _id, _w, ws in corpus for w in ws} - set(lex.words))
        if missing:
            raise SystemExit(
                f"corpus words not in the bundle lexicon: {missing[:8]} ...")
    else:
        fcfg = FrontendConfig(add_pitch=args.add_pitch)
        topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(
        acoustic_scale=args.acoustic_scale,
        beam=args.beam,
        word_insertion_penalty=args.insertion_penalty,
    )
    logger = make_logger(args)

    # Flag-compatibility guards run BEFORE any model build/compile so a bad
    # invocation fails in milliseconds, not after minutes of jit.
    needs_lattice = (args.trigram_rescore or args.nbest > 0
                     or args.consensus != "off" or bool(args.nnlm_rescore)
                     or bool(args.lattice_out))
    if args.nnlm_rescore and args.consensus != "off":
        raise SystemExit("--nnlm-rescore re-ranks N-best lists: incompatible "
                         "with --consensus")
    if (needs_lattice or args.multi_pron) and args.mode != "word":
        raise SystemExit("--multi-pron/--trigram-rescore/--nbest/--consensus "
                         "require --mode word")
    if (args.ctc or args.rnnt) and (args.am == "gmm" or args.multi_pron):
        raise SystemExit("--ctc/--rnnt require a neural --am and no --multi-pron")
    if args.aed and (
        args.ctc or args.rnnt or args.multi_pron or needs_lattice
        or args.bigram_lm or args.grammar or args.trigram_rescore
    ):
        raise SystemExit(
            "--aed is direct beam-search decoding: incompatible with "
            "--ctc/--rnnt/--multi-pron/--bigram-lm/--grammar/lattice passes"
        )
    if args.ctc and args.bpe and (
        args.mode == "phone" or args.consensus != "off" or args.nbest > 0
        or args.bigram_lm or args.trigram_rescore or args.lattice_out
    ):
        # The lexicon-free BPE branch decodes words via the prefix beam (or
        # greedy collapse) — no lattice pass; silently ignoring these flags
        # produced meaningless PER / skipped passes.
        raise SystemExit(
            "--ctc --bpe decodes words via the prefix beam: incompatible "
            "with --mode phone, --consensus, --nbest, --bigram-lm, "
            "--trigram-rescore, --lattice-out"
        )
    if args.aed and args.bpe and args.mode != "word":
        raise SystemExit("--aed --bpe decodes words: use --mode word")
    if args.aed and not args.bpe and args.mode != "phone":
        raise SystemExit("--aed without --bpe decodes phones: use --mode phone")

    batches = featurize(corpus, fcfg, BatchConfig())

    ivec_rank = 0
    if args.ivector_ckpt:
        if args.am == "gmm" or args.aed or args.rnnt:
            raise SystemExit("--ivector-ckpt augments hybrid/CTC neural "
                             "features: use --am mlp/lstm/blstm/tdnn")
        import jax.numpy as _jnp
        import numpy as _np

        from mogasr.am.gmm import GmmSet as _Gmm
        from mogasr.am.ivector import IvectorExtractor
        from mogasr.pipeline import append_ivectors
        from mogasr.utils.checkpoint import restore_checkpoint as _restore

        K, R, D = args.ivector_components, args.ivector_dim, fcfg.feat_dim
        ck_iv = _restore(args.ivector_ckpt, {
            "ubm": _Gmm(_jnp.zeros((1, K)), _jnp.zeros((1, K, D)),
                        _jnp.ones((1, K, D))),
            "t": _jnp.zeros((K, D, R)),
        })
        batches = append_ivectors(
            batches, IvectorExtractor(ck_iv["ubm"], _np.asarray(ck_iv["t"]))
        )
        ivec_rank = R

    if args.am == "gmm" and not args.aed:
        gmm = bundle[0] if bundle is not None else load_or_random_gmm(args, fcfg.feat_dim)
        scorer = None
    else:
        import jax
        import jax.numpy as jnp

        from mogasr.am.neural import build_model
        from mogasr.am.train_nn import init_train_state
        from mogasr.config import TrainConfig
        from mogasr.pipeline import make_nn_scorer
        from mogasr.utils.checkpoint import restore_checkpoint

        if not args.nn_ckpt:
            raise SystemExit("--nn-ckpt is required with --am mlp/lstm")
        tcfg = TrainConfig(nn_arch=args.am, nn_hidden=args.nn_hidden,
                           nn_layers=args.nn_layers,
                           nn_experts=args.nn_experts)
        if args.aed:
            import numpy as _np

            from mogasr.am.aed import (
                build_aed_model, init_aed_train_state, make_aed_decoder,
            )

            if args.bpe:
                from mogasr.data.bpe import load_bpe

                bpe = load_bpe(args.bpe)
                n_aed_units = bpe.n_units
            else:
                bpe = None
                n_aed_units = lex.n_phones
            model = build_aed_model(
                n_aed_units, tcfg, chunk_frames=args.aed_chunk,
                left_chunks=args.aed_left_chunks,
            )
            template = {
                "params": init_aed_train_state(
                    model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)
                ).params,
            }
            ck = restore_checkpoint(args.nn_ckpt, template)
            aed_fusion = None
            if args.fusion_lm:
                from mogasr.am.aed import aed_fusion_matrix
                from mogasr.lm.unit_ngram import load_unit_lm

                if not args.bpe:
                    raise SystemExit("--aed --fusion-lm needs --bpe (the "
                                     "unit LM is over the BPE inventory)")
                aed_fusion = aed_fusion_matrix(
                    model, load_unit_lm(args.fusion_lm), args.fusion_weight
                )
            aed_dec = make_aed_decoder(
                model, ck["params"], beam=args.aed_beam,
                max_tokens=args.aed_max_tokens,
                ctc_weight=args.aed_ctc_weight,
                fusion=aed_fusion,
            )

            def scorer(fb, _d=aed_dec):
                toks, n_toks, _ = (_np.asarray(a) for a in _d(fb.feats, fb.n_frames))
                return [
                    list(map(int, toks[b, : n_toks[b]])) for b in range(len(toks))
                ]
        elif args.rnnt:
            from mogasr.am.rnnt import (
                build_rnnt_model, init_rnnt_train_state, rnnt_greedy_decode_device,
            )

            if args.am not in ("lstm", "blstm"):
                raise SystemExit("--rnnt needs --am lstm/blstm")
            if args.bpe:
                from mogasr.data.bpe import load_bpe

                if args.mode != "word":
                    raise SystemExit("--rnnt --bpe decodes words: use "
                                     "--mode word")
                bpe = load_bpe(args.bpe)
                n_rnnt_units = bpe.n_units
            else:
                if args.mode != "phone":
                    raise SystemExit("--rnnt without --bpe decodes phones: "
                                     "use --mode phone")
                bpe = None
                n_rnnt_units = lex.n_phones
            model = build_rnnt_model(
                n_rnnt_units, tcfg,
                encoder_arch=args.am,
                pred_arch=args.rnnt_pred,
                aux_ctc=not args.rnnt_plain,
                simple_heads=args.rnnt_pruned,
            )
            template = {
                "params": init_rnnt_train_state(
                    model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)
                ).params,
            }
            ck = restore_checkpoint(args.nn_ckpt, template)

            if args.bias and args.rnnt_beam <= 0:
                raise SystemExit("--rnnt --bias boosts phrases inside the "
                                 "beam search: add --rnnt-beam N")
            if args.rnnt_beam > 0:
                if args.fusion_lm:
                    from mogasr.lm.unit_ngram import load_unit_lm

                    ulm = load_unit_lm(args.fusion_lm)
                    if ulm.n_units != n_rnnt_units:
                        raise SystemExit(
                            "--rnnt --fusion-lm unit mismatch: LM has "
                            f"{ulm.n_units} units, model decodes "
                            f"{n_rnnt_units} (train_lm --unit-ngram with "
                            "the matching --bpe, or without it for phones)")
                if args.bias:
                    from mogasr.decoder.biasing import (
                        biaser_from_bpe, biaser_from_words, load_phrases,
                    )

                    phrases = load_phrases(args.bias)
                    _rnnt_biaser = (
                        biaser_from_bpe(bpe, phrases,
                                        weight=args.bias_weight)
                        if bpe is not None else
                        biaser_from_words(lex, phrases,
                                          weight=args.bias_weight))

                # the fully on-device beam (round 5): one jitted lax.scan
                # per batch, with fusion and biasing as precomputed-table
                # row gathers — identical ranked lists to the per-utterance
                # ext_score reference (tests/test_rnnt_device_beam.py), so
                # --fusion-lm/--bias no longer fall back to the
                # dispatch-bound per-utterance loop (VERDICT r4 item 2)
                from mogasr.am.rnnt import (
                    rnnt_beam_decode_device, rnnt_fusion_matrix,
                )

                fusion_m = (rnnt_fusion_matrix(model, ulm,
                                               args.fusion_weight)
                            if args.fusion_lm else None)
                bias_next = bias_delta = None
                if args.bias:
                    from mogasr.decoder.biasing import CompiledBiaser

                    comp = CompiledBiaser(_rnnt_biaser, n_rnnt_units)
                    bias_next, bias_delta = comp.next_state, comp.delta

                def scorer(fb, _m=model, _p=ck["params"]):
                    ranked = rnnt_beam_decode_device(
                        _m, _p, fb.feats, fb.n_frames,
                        beam_size=args.rnnt_beam, fusion=fusion_m,
                        bias_next=bias_next, bias_delta=bias_delta,
                    )
                    return [ranked[b][0][1] for b in range(fb.size)]
            else:
                def scorer(fb, _m=model, _p=ck["params"]):
                    return rnnt_greedy_decode_device(
                        _m, _p, fb.feats, fb.n_frames)
        elif args.ctc:
            from mogasr.am.ctc import make_ctc_scorer

            if args.bpe:
                from mogasr.data.bpe import load_bpe

                bpe = load_bpe(args.bpe)
                n_ctc_units = bpe.n_units
            else:
                bpe = None
                n_ctc_units = lex.n_phones
            model = build_model(args.am, n_ctc_units + 1, tcfg)
            template = {
                "params": init_train_state(model, tcfg,
                                           fcfg.feat_dim + ivec_rank,
                                           jax.random.key(0)).params,
            }
            ck = restore_checkpoint(args.nn_ckpt, template)
            scorer = make_ctc_scorer(model, ck["params"])
        else:
            model = build_model(args.am, topo.n_pdfs, tcfg)
            template = {
                "params": init_train_state(
                    model, tcfg, fcfg.feat_dim + ivec_rank, jax.random.key(0)
                ).params,
                "log_priors": jnp.zeros(topo.n_pdfs),
            }
            ck = restore_checkpoint(args.nn_ckpt, template)
            scorer = make_nn_scorer(model, ck["params"],
                                    jnp.asarray(ck["log_priors"]),
                                    precision=args.nn_precision)
        gmm = None

    pron_logp = None
    if args.aed:
        graph = None  # label-synchronous attention decode needs no graph
    elif args.rnnt:
        graph = None  # frame-synchronous transducer decode needs no graph
    elif args.ctc and args.bpe:
        graph = None  # lexicon-free: greedy units -> bpe.decode, no graph
    elif args.ctc:
        from mogasr.am.ctc import ctc_decode_graph

        # word mode: CTC-topology word loop through the shared Viterbi;
        # phone mode uses greedy best-path (no graph needed)
        graph = ctc_decode_graph(lex, dcfg) if args.mode == "word" else None
    elif args.mode == "word" and args.multi_pron:
        from mogasr.pipeline import word_decode_graph_multi

        graph, pron_logp = word_decode_graph_multi(lex, topo, dcfg)
    elif args.mode == "word" and bundle is not None and bundle[3] is not None:
        from mogasr.hmm.triphone import word_loop_graph_cd

        # context-dependent decode graph matching the bundle's tied pdfs
        graph = word_loop_graph_cd(
            bundle[3], insertion_penalty=dcfg.word_insertion_penalty)
    elif args.mode == "word":
        graph = word_decode_graph(lex, topo, dcfg)
    else:
        graph = gr.loop_graph(topo)
    lm = trigram = None
    if args.grammar:
        if args.mode != "word":
            raise SystemExit("--grammar requires --mode word")
        from mogasr.lm.ngram import grammar_bigram

        with open(args.grammar) as f:
            sentences = [line.split() for line in f if line.split()]
        lm = grammar_bigram(
            [[w.lower() for w in s] for s in sentences],
            tokens=sorted(set(graph.labels)),
        )
    elif args.bigram_lm or (needs_lattice and not (args.ctc and args.bpe)):
        # (--ctc --bpe --nnlm-rescore re-ranks the PREFIX-BEAM N-best:
        # no lattice pass, so no count LM to estimate)
        if args.mode != "word":
            raise SystemExit("--bigram-lm requires --mode word")
        from mogasr.lm.ngram import (
            estimate_bigram, estimate_bigram_kn, estimate_trigram,
            estimate_trigram_kn,
        )

        lm_tokens = sorted(set(graph.labels))
        transcripts = [fb.words[b] for fb in batches for b in range(fb.size)]
        est_bi = estimate_bigram_kn if args.lm_smoothing == "kn" else estimate_bigram
        est_tri = estimate_trigram_kn if args.lm_smoothing == "kn" else estimate_trigram
        lm = est_bi(transcripts, lm_tokens)
        if args.trigram_rescore:
            if args.arpa:
                from mogasr.lm.arpa import read_arpa_trigram

                trigram = read_arpa_trigram(args.arpa, tokens=lm_tokens)
            else:
                trigram = est_tri(transcripts, lm_tokens)
        if args.write_arpa:
            from mogasr.lm.arpa import write_arpa

            write_arpa(args.write_arpa, trigram if trigram is not None else lm)

    nnlm = None
    if args.nnlm_rescore:
        from mogasr.lm.neural import load_nnlm

        nnlm = load_nnlm(args.nnlm_rescore)  # (model, params, vocab)

    refs, hyps, ids, nbest_lists = [], [], [], []
    wrote_lattices = False
    audio_sec = sum(len(w) for _, w, _ in corpus) / fcfg.sample_rate
    with Timer() as t:
        for fb in batches:
            if args.aed:
                seqs = scorer(fb)
                out = (
                    [bpe.decode(s) for s in seqs] if bpe is not None
                    else [[lex.phones[u] for u in s] for s in seqs]
                )
                for b in range(fb.size):
                    ids.append(fb.utt_ids[b])
                    refs.append([w.lower() for w in fb.words[b]])
                    hyps.append([w.lower() for w in out[b]])
                continue
            if args.rnnt:
                out = (
                    [bpe.decode(seq) for seq in scorer(fb)] if bpe is not None
                    else [[lex.phones[u] for u in seq] for seq in scorer(fb)]
                )
                for b in range(fb.size):
                    ids.append(fb.utt_ids[b])
                    refs.append([w.lower() for w in fb.words[b]])
                    hyps.append([w.lower() for w in out[b]])
                continue
            if args.ctc and args.bpe:
                from mogasr.am.ctc import ctc_greedy_decode

                if args.bias or args.fusion_lm or nnlm is not None:
                    # the ON-DEVICE batched prefix beam (round 5): one
                    # jitted lax.scan per batch, fusion/biasing as
                    # precomputed-table gathers — ranked lists equal the
                    # per-utterance dict reference
                    # (tests/test_ctc_device_beam.py, f32 contract there)
                    from mogasr.am.ctc import (
                        ctc_fusion_matrix, ctc_prefix_beam_decode_device,
                    )

                    bias_next = bias_delta = fusion_m = None
                    if args.bias:
                        from mogasr.decoder.biasing import (
                            CompiledBiaser, biaser_from_bpe, load_phrases,
                        )

                        comp = CompiledBiaser(biaser_from_bpe(
                            bpe, load_phrases(args.bias),
                            weight=args.bias_weight,
                        ), bpe.n_units)
                        bias_next, bias_delta = comp.next_state, comp.delta
                    if args.fusion_lm:
                        from mogasr.lm.unit_ngram import load_unit_lm

                        fusion_m = ctc_fusion_matrix(
                            bpe.n_units, load_unit_lm(args.fusion_lm),
                            args.fusion_weight)
                    beam_sz = max(
                        args.bias_beam,
                        args.nnlm_nbest if nnlm is not None else 0,
                    )
                    lp_dev = scorer(fb)
                    ranked = ctc_prefix_beam_decode_device(
                        lp_dev, fb.n_frames, beam_size=beam_sz,
                        u_cap=int(lp_dev.shape[1]), fusion=fusion_m,
                        bias_next=bias_next, bias_delta=bias_delta,
                    )[: fb.size]
                    if nnlm is not None:
                        # second pass: neural word LM over the prefix-beam
                        # N-best (first-pass score = fused beam logp)
                        from mogasr.lm.neural import rescore_nbest_nnlm

                        nbest = [
                            [(bpe.decode(seq), s)
                             for s, seq in r[: args.nnlm_nbest]]
                            for r in ranked
                        ]
                        rescored = rescore_nbest_nnlm(
                            nnlm[0], nnlm[1], nnlm[2], nbest,
                            weight=args.nnlm_weight,
                        )
                        out = [r[0][0] if r else [] for r in rescored]
                    else:
                        out = [bpe.decode(r[0][1]) for r in ranked]
                else:
                    out = [
                        bpe.decode(seq)
                        for seq in ctc_greedy_decode(scorer(fb), fb.n_frames)
                    ]
                for b in range(fb.size):
                    ids.append(fb.utt_ids[b])
                    refs.append([w.lower() for w in fb.words[b]])
                    hyps.append([w.lower() for w in out[b]])
                continue
            scores = scorer(fb) if scorer is not None else score_batch(fb.feats, gmm)
            if needs_lattice:
                from mogasr.decoder.lattice import lattice_nbest, rescore_lattice
                from mogasr.pipeline import decode_batch_lattices

                lats, _ = decode_batch_lattices(
                    fb, scores, graph, lm, dcfg, chain_entry_logp=pron_logp
                )
                if args.lattice_out:
                    from mogasr.decoder.lattice import write_lattices

                    write_lattices(
                        args.lattice_out,
                        [(fb.utt_ids[b], lats[b]) for b in range(fb.size)],
                        append=wrote_lattices,
                    )
                    wrote_lattices = True
                second = trigram if trigram is not None else lm
                if args.consensus == "cn":
                    from mogasr.decoder.confusion import (
                        confusion_network, consensus_decode,
                    )

                    out = [
                        consensus_decode(confusion_network(lat, second))[0]
                        for lat in lats
                    ]
                elif args.consensus == "mbr":
                    from mogasr.decoder.confusion import mbr_nbest_decode

                    out = [
                        mbr_nbest_decode(lat, second, n=max(args.nbest, 16))[0]
                        for lat in lats
                    ]
                elif nnlm is not None:
                    from mogasr.lm.neural import rescore_nbest_nnlm

                    depth = max(args.nnlm_nbest, args.nbest)
                    rescored = rescore_nbest_nnlm(
                        nnlm[0], nnlm[1], nnlm[2],
                        [lattice_nbest(lat, second, depth) for lat in lats],
                        weight=args.nnlm_weight,
                    )
                    out = [lst[0][0] if lst else [] for lst in rescored]
                    if args.nbest > 0:
                        nbest_lists.extend(
                            [{"hyp": h, "logp": s} for h, s in lst[: args.nbest]]
                            for lst in rescored
                        )
                else:
                    out = [rescore_lattice(lat, second)[0] for lat in lats]
                if args.nbest > 0 and nnlm is None:
                    nbest_lists.extend(
                        [
                            [{"hyp": [w.lower() for w in h], "logp": s}
                             for h, s in lattice_nbest(lat, second, args.nbest)]
                            for lat in lats
                        ]
                    )
            elif lm is not None:
                from mogasr.decoder.lm_viterbi import path_to_tokens_lm, viterbi_lm

                res = viterbi_lm(
                    scores, graph, lm, fb.n_frames,
                    acoustic_scale=args.acoustic_scale,
                    insertion_penalty=args.insertion_penalty,
                    chain_entry_logp=pron_logp,
                )
                toks = path_to_tokens_lm(res, graph)
                out = [[w for w in h if w not in ("<sil>", "sil")] for h in toks]
            elif args.ctc and args.mode == "phone":
                from mogasr.am.ctc import ctc_greedy_decode

                out = [
                    [lex.phones[u] for u in seq]
                    for seq in ctc_greedy_decode(scores, fb.n_frames)
                ]
            else:
                out = decode_batch(fb, scores, graph, dcfg)
            for b in range(fb.size):
                ids.append(fb.utt_ids[b])
                refs.append([w.lower() for w in fb.words[b]])
                hyps.append([w.lower() for w in out[b]])
    rec = {
        "stage": "decode", "mode": args.mode, "utts": len(ids),
        "wall_sec": t.seconds, "rtf": t.seconds / max(audio_sec, 1e-9),
        "utts_per_sec": len(ids) / t.seconds,
    }
    if any(refs) and args.mode == "word":
        wer, counts = corpus_wer(refs, hyps)
        rec.update(wer=wer, sub=counts.substitutions, dels=counts.deletions,
                   ins=counts.insertions)
        if args.ci:
            from mogasr.eval.wer import wer_bootstrap_ci

            _w, lo, hi = wer_bootstrap_ci(refs, hyps)
            rec.update(wer_ci95=[round(lo, 4), round(hi, 4)])
        if args.errors_out:
            from mogasr.eval.wer import error_report

            with open(args.errors_out, "w") as f:
                f.write(error_report(refs, hyps, ids))
    elif any(refs) and args.mode == "phone":
        # phone error rate: expand reference words to phones (no silences)
        phone_refs = [
            [lex.phones[p] for p in lex.words_to_phone_ids(r, interword_sil=False, edge_sil=False, oov="skip")]
            for r in refs
        ]
        per, counts = corpus_wer(phone_refs, hyps)
        rec.update(per=per, sub=counts.substitutions, dels=counts.deletions,
                   ins=counts.insertions)
    logger.log(rec)
    if args.out:
        with open(args.out, "w") as f:
            for i, (utt_id, hyp) in enumerate(zip(ids, hyps)):
                rec_out = {"utt_id": utt_id, "hyp": hyp}
                if nbest_lists:
                    rec_out["nbest"] = nbest_lists[i]
                f.write(json.dumps(rec_out) + "\n")


if __name__ == "__main__":
    main()
