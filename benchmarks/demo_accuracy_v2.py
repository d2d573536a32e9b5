"""Accuracy demonstration on the DISCRIMINATIVE (v2) synthetic corpus.

Round-1's v1 corpus saturated: mono GMM, CD, LM, MMI, sMBR, adaptation all
tied at 1.45% held-out WER, so none of the advanced components could show a
win (round-1 VERDICT item 3).  The v2 corpus (mogasr/data/synthetic.py) adds
coarticulation, per-speaker vocal-tract scaling + channel tilt, additive
noise, and a ~300-word vocabulary — this script demonstrates that on that
task the component ladder separates:

    mono GMM  <  +bigram LM  <  +trigram rescore / consensus
    mono      <  tied triphones (coarticulation signal)
    SI decode <  VTLN / fMLLR speaker adaptation
    ML GMM    <  MMI / sMBR discriminative refinement (criterion AND WER)

Writes benchmarks/results_accuracy_v2.json.  Deterministic.

    python benchmarks/demo_accuracy_v2.py [--cpu] [--probe]
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
    p.add_argument("--probe", action="store_true",
                   help="fast subset: mono/LM/CD rows only")
    p.add_argument("--train-utts", type=int, default=240)
    p.add_argument("--test-utts", type=int, default=60)
    p.add_argument("--vocab", type=int, default=300)
    p.add_argument("--speakers", type=int, default=12)
    p.add_argument("--target-pdfs", type=int, default=400)
    p.add_argument("--components", type=int, default=8)
    p.add_argument("--e2e", action="store_true",
                   help="also train + score the AED end-to-end family")
    p.add_argument("--e2e-steps", type=int, default=800)
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from mogasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np
    import jax.numpy as jnp

    from mogasr import pipeline as pipe
    from mogasr.config import (
        BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TopologyConfig,
        TrainConfig,
    )
    from mogasr.data import synthetic as syn
    from mogasr.decoder.lm_viterbi import path_to_tokens_lm, viterbi_lm
    from mogasr.eval.wer import corpus_wer
    from mogasr.hmm.lexicon import make_lexicon
    from mogasr.hmm.topology import build_topology
    from mogasr.lm.ngram import estimate_bigram_kn

    t_start = time.time()
    fcfg = FrontendConfig()
    bcfg = BatchConfig(batch_size=12, bucket_boundaries=(250, 400, 550))
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)

    word_lex = syn.extended_lexicon(args.vocab)
    lex = make_lexicon(word_lex)
    topo = build_topology(lex, TopologyConfig())
    speakers = syn.make_speakers(args.speakers)
    style = syn.CorpusStyle()

    # Held-out utterances use the SAME speakers (per-speaker adaptation needs
    # them) but disjoint word sequences (seed).
    train = syn.make_corpus_v2(args.train_utts, lexicon=word_lex,
                               speakers=speakers, style=style, seed=100)
    test = syn.make_corpus_v2(args.test_utts, lexicon=word_lex,
                              speakers=speakers, style=style, seed=999)
    spk_of = {u.utt_id: u.speaker for u in train + test}
    speaker_of = lambda uid: spk_of.get(uid, "g")

    tb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in train], fcfg, bcfg)
    eb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in test], fcfg, bcfg)
    refs = [[w.lower() for w in fb.words[b]] for fb in eb for b in range(fb.size)]

    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=args.components,
                     feat_dim=fcfg.feat_dim)
    res = pipe.train_gmm(
        tb, lex, topo, gcfg, TrainConfig(num_em_iters=10),
        reestimate_transitions=True,
    )
    gmm, topo_t = res.gmm, res.topo
    results = {
        "corpus": "v2 (coarticulated, multi-speaker, noisy)",
        "train_utts": args.train_utts, "test_utts": args.test_utts,
        "vocab": args.vocab, "speakers": args.speakers,
        "gmm": f"{gmm.n_states}x{gmm.n_components}",
        "em_loglik_first": round(res.history[0], 3),
        "em_loglik_last": round(res.history[-1], 3),
    }

    def report(key, wer):
        results[key] = round(wer, 4)
        print(f"  {key}: {wer:.4f}  [{time.time()-t_start:.0f}s]", flush=True)

    # (a) mono unigram
    m = pipe.evaluate(eb, gmm, lex, topo_t, dcfg)
    report("heldout_wer_gmm_unigram", m["wer"])

    # (b) bigram LM (Kneser-Ney, train transcripts only)
    graph = pipe.word_decode_graph(lex, topo_t, dcfg)
    train_text = [fb.words[b] for fb in tb for b in range(fb.size)]
    lm = estimate_bigram_kn(train_text, graph.labels)
    hyps = []
    for fb in eb:
        scores = pipe.score_batch(fb.feats, gmm)
        r = viterbi_lm(scores, graph, lm, fb.n_frames, acoustic_scale=1.0,
                       insertion_penalty=dcfg.word_insertion_penalty)
        toks = path_to_tokens_lm(r, graph)
        hyps.extend([[w.lower() for w in h if w != "<sil>"] for h in toks[: fb.size]])
    report("heldout_wer_gmm_bigram", corpus_wer(refs, hyps)[0])

    # (c) tied triphones — the coarticulation payoff
    from mogasr.hmm import triphone as tri

    tied, res_cd = pipe.train_triphone(
        tb, lex, topo_t, gcfg, TrainConfig(num_em_iters=8), gmm,
        target_pdfs=args.target_pdfs, min_occ=20.0,
    )
    results["tied_pdfs"] = tied.n_pdfs
    graph_cd = tri.word_loop_graph_cd(
        tied, insertion_penalty=dcfg.word_insertion_penalty)
    refs_cd, hyps_cd = [], []
    for fb in eb:
        scores = pipe.score_batch(fb.feats, res_cd.gmm)
        out = pipe.decode_batch(fb, scores, graph_cd, dcfg)
        for b in range(fb.size):
            refs_cd.append([w.lower() for w in fb.words[b]])
            hyps_cd.append([w.lower() for w in out[b]])
    report("heldout_wer_triphone", corpus_wer(refs_cd, hyps_cd)[0])

    if not args.probe:
        # (d) trigram lattice rescoring over the bigram first pass
        from mogasr.decoder.lattice import rescore_lattice
        from mogasr.lm.ngram import estimate_trigram_kn

        tri_lm = estimate_trigram_kn(train_text, graph.labels)
        hyps_tri = []
        for fb in eb:
            scores = pipe.score_batch(fb.feats, gmm)
            lats, _ = pipe.decode_batch_lattices(fb, scores, graph, lm, dcfg)
            hyps_tri.extend(
                [[w.lower() for w in rescore_lattice(lat, tri_lm)[0]]
                 for lat in lats]
            )
        report("heldout_wer_gmm_trigram_rescore", corpus_wer(refs, hyps_tri)[0])

        # (e) consensus (confusion-network) decoding of the same lattices
        from mogasr.decoder.confusion import confusion_network, consensus_decode

        hyps_cn = []
        for fb in eb:
            scores = pipe.score_batch(fb.feats, gmm)
            lats, _ = pipe.decode_batch_lattices(fb, scores, graph, lm, dcfg)
            hyps_cn.extend(
                [[w.lower() for w in consensus_decode(confusion_network(lat, lm))[0]]
                 for lat in lats]
            )
        report("heldout_wer_gmm_consensus", corpus_wer(refs, hyps_cn)[0])

        # (e2) neural-LM N-best rescoring over the same bigram lattices —
        # the unbounded-context continuation of the LM ladder
        from mogasr.decoder.lattice import lattice_nbest
        from mogasr.lm import neural as NL

        vocab_nl = NL.vocab_from_transcripts(train_text)
        nnlm_model, nnlm_params = NL.train_nnlm(
            train_text, vocab_nl,
            TrainConfig(nn_hidden=64, nn_layers=1, lr=5e-3, num_nn_steps=400),
        )
        results["nnlm_heldout_ppl"] = round(NL.nnlm_perplexity(
            nnlm_model, nnlm_params, vocab_nl,
            [[w.lower() for w in r] for r in refs]), 2)
        hyps_nl = []
        for fb in eb:
            scores = pipe.score_batch(fb.feats, gmm)
            lats, _ = pipe.decode_batch_lattices(fb, scores, graph, lm, dcfg)
            rescored = NL.rescore_nbest_nnlm(
                nnlm_model, nnlm_params, vocab_nl,
                [lattice_nbest(lat, lm, 16) for lat in lats], weight=0.5,
            )
            hyps_nl.extend([lst[0][0] if lst else [] for lst in rescored])
        report("heldout_wer_gmm_nnlm_rescore", corpus_wer(refs, hyps_nl)[0])

        # (f) MMI refinement of the ML mono GMM
        from mogasr.am.mmi import train_mmi

        gmm_mmi, mmi_hist = train_mmi(tb, lex, topo_t, gmm, n_iters=4,
                                      acoustic_scale=0.1)
        results["mmi_criterion_first"] = round(mmi_hist[0], 5)
        results["mmi_criterion_last"] = round(mmi_hist[-1], 5)
        m_mmi = pipe.evaluate(eb, gmm_mmi, lex, topo_t, dcfg)
        report("heldout_wer_gmm_mmi", m_mmi["wer"])

        # (g) sMBR refinement
        from mogasr.am.smbr import train_smbr

        gmm_smbr, smbr_hist = train_smbr(tb, lex, topo_t, gmm, n_iters=4,
                                         acoustic_scale=0.1)
        results["smbr_expected_acc_first"] = round(smbr_hist[0], 5)
        results["smbr_expected_acc_last"] = round(smbr_hist[-1], 5)
        m_smbr = pipe.evaluate(eb, gmm_smbr, lex, topo_t, dcfg)
        report("heldout_wer_gmm_smbr", m_smbr["wer"])

        def hyp_list(hyp_map):
            # adaptation decoders return {utt_id: words}; order like refs
            return [
                [w.lower() for w in hyp_map[fb.utt_ids[b]]]
                for fb in eb for b in range(fb.size)
            ]

        # (h) VTLN speaker adaptation (formant-scale recovery)
        hyps_v, warps = pipe.decode_with_vtln(
            [(u.utt_id, u.wave, u.words) for u in test], gmm, lex, topo_t,
            fcfg, bcfg, dcfg, speaker_of=speaker_of,
        )
        results["vtln_warps"] = {k: round(v, 3) for k, v in warps.items()}
        report("heldout_wer_vtln", corpus_wer(refs, hyp_list(hyps_v))[0])

        # (i) fMLLR speaker adaptation (channel/tilt recovery)
        hyps_f, _W = pipe.decode_with_fmllr(
            eb, gmm, lex, topo_t, dcfg, speaker_of=speaker_of)
        report("heldout_wer_fmllr", corpus_wer(refs, hyp_list(hyps_f))[0])

        # (i2) SAT: fMLLR inside the EM loop (train_sat), then unsupervised
        # two-pass adapted decode with the SAT model
        gmm_sat, _W_train, sat_hist = pipe.train_sat(
            tb, lex, topo_t, gcfg, gmm, speaker_of=speaker_of, n_iters=3)
        results["sat_loglik_first"] = round(sat_hist[0], 4)
        results["sat_loglik_last"] = round(sat_hist[-1], 4)
        hyps_s, _ = pipe.decode_with_fmllr(
            eb, gmm_sat, lex, topo_t, dcfg, speaker_of=speaker_of, si_gmm=gmm)
        report("heldout_wer_sat", corpus_wer(refs, hyp_list(hyps_s))[0])

        # (j) hybrid MLP on CD alignments, for the neural row
        from mogasr.am.neural import build_model, state_priors
        from mogasr.am.train_nn import init_train_state, make_train_step

        labeled = []
        for fb in tb:
            _r, labels, _ = pipe.align_batch(fb, gmm, lex, topo_t)
            labeled.append((fb, labels))
        tcfg = TrainConfig(nn_hidden=256, nn_layers=3, nn_context=4, lr=2e-3,
                           num_nn_steps=600)
        model = build_model("mlp", topo.n_pdfs, tcfg)
        state = init_train_state(model, tcfg, fcfg.feat_dim, jax.random.key(0))
        step = make_train_step(model, tcfg)
        for i in range(tcfg.num_nn_steps):
            fb, labels = labeled[i % len(labeled)]
            state, metrics = step(state, fb.feats, fb.n_frames, labels)
        results["nn_final_frame_acc"] = round(float(metrics["frame_acc"]), 4)
        all_labels = np.concatenate(
            [np.asarray(l).reshape(-1) for _, l in labeled])
        scorer = pipe.make_nn_scorer(
            model, state.params,
            jnp.asarray(state_priors(all_labels, topo.n_pdfs)))
        m_nn = pipe.evaluate(eb, None, lex, topo_t, dcfg, scorer=scorer)
        report("heldout_wer_mlp_unigram", m_nn["wer"])

        # (k) the same MLP with i-vector-augmented features — speaker-aware
        # hybrid training (the v2 corpus has per-speaker vocal-tract scaling
        # and channel tilt, exactly what a per-utterance i-vector captures)
        from mogasr.am.ivector import train_ivector_extractor
        from mogasr.pipeline import append_ivectors

        extractor = train_ivector_extractor(tb, n_components=32, rank=8)
        tb_iv = append_ivectors(tb, extractor)
        eb_iv = append_ivectors(eb, extractor)
        model_iv = build_model("mlp", topo.n_pdfs, tcfg)
        state_iv = init_train_state(
            model_iv, tcfg, tb_iv[0].feats.shape[-1], jax.random.key(0)
        )
        step_iv = make_train_step(model_iv, tcfg)
        for i in range(tcfg.num_nn_steps):
            fb_iv, (_fb, labels) = tb_iv[i % len(tb_iv)], labeled[i % len(labeled)]
            state_iv, m_i = step_iv(state_iv, fb_iv.feats, fb_iv.n_frames, labels)
        scorer_iv = pipe.make_nn_scorer(
            model_iv, state_iv.params,
            jnp.asarray(state_priors(all_labels, topo.n_pdfs)))
        m_nn_iv = pipe.evaluate(eb_iv, None, lex, topo_t, dcfg, scorer=scorer_iv)
        report("heldout_wer_mlp_ivector", m_nn_iv["wer"])

    if args.e2e:
        # (m) attention encoder-decoder trained on v2 phone targets —
        # the end-to-end family's accuracy row (decode: on-device beam 4
        # with joint-CTC rescoring; PER-oriented phone output scored as
        # word-free phone WER against the expanded references)
        from mogasr.am.aed import aed_decode_batch, build_aed_model
        from mogasr.pipeline import train_aed

        tcfg_aed = TrainConfig(nn_hidden=192, nn_layers=2, lr=2e-3,
                               num_nn_steps=args.e2e_steps)
        aed_model, aed_params = train_aed(tb, lex, tcfg_aed)
        phone_refs, phone_hyps = [], []
        for fb in eb:
            seqs = aed_decode_batch(
                aed_model, aed_params, fb.feats, fb.n_frames,
                beam=4, max_tokens=48, ctc_weight=0.3,
            )
            for b in range(fb.size):
                phone_refs.append([
                    lex.phones[p] for p in lex.words_to_phone_ids(
                        fb.words[b], interword_sil=False, edge_sil=False)
                ])
                phone_hyps.append([lex.phones[u] for u in seqs[b]])
        report("heldout_per_aed", corpus_wer(phone_refs, phone_hyps)[0])

        # (n) MWER fine-tuning of the same AED — the e2e family's
        # discriminative row (criterion = expected edit distance over the
        # model's own N-best; should move the criterion AND the PER)
        from mogasr.am.ctc import ctc_labels_from_words
        from mogasr.pipeline import finetune_aed_mwer

        aed_params_mwer, mwer_hist = finetune_aed_mwer(
            aed_model, aed_params, tb,
            lambda words: ctc_labels_from_words(lex, words, False),
            TrainConfig(lr=2e-4, num_nn_steps=max(args.e2e_steps // 4, 40)),
        )
        results["aed_mwer_risk_first"] = round(mwer_hist[0], 4)
        results["aed_mwer_risk_last"] = round(mwer_hist[-1], 4)
        phone_hyps_m = []
        for fb in eb:
            seqs = aed_decode_batch(
                aed_model, aed_params_mwer, fb.feats, fb.n_frames,
                beam=4, max_tokens=48, ctc_weight=0.3,
            )
            for b in range(fb.size):
                phone_hyps_m.append([lex.phones[u] for u in seqs[b]])
        report("heldout_per_aed_mwer", corpus_wer(phone_refs, phone_hyps_m)[0])

    results["wall_s"] = round(time.time() - t_start, 1)
    out_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results_accuracy_v2.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
