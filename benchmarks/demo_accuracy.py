"""Accuracy demonstration: train on synthetic corpus, evaluate HELD-OUT WER.

The "matched WER" side of the judged metric (bench.py covers speed): trains
the monophone GMM-HMM with EM + splitting + transition re-estimation on 48
utterances, then decodes 24 unseen utterances with (a) unigram loop decode,
(b) bigram-LM decode, and (c) the hybrid MLP acoustic model. Writes
benchmarks/results_accuracy.json.

Deterministic; runs on CPU or GPU (pass --cpu to force CPU).

    python benchmarks/demo_accuracy.py [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--train-utts", type=int, default=48)
    p.add_argument("--test-utts", type=int, default=24)
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    from mogasr import pipeline as pipe
    from mogasr.am.neural import build_model, state_priors
    from mogasr.am.train_nn import init_train_state, make_train_step
    from mogasr.config import (
        BatchConfig, DecodeConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig,
    )
    from mogasr.data.synthetic import make_corpus
    from mogasr.decoder.lm_viterbi import path_to_tokens_lm, viterbi_lm
    from mogasr.eval.wer import corpus_wer
    from mogasr.hmm.lexicon import synthetic_lexicon
    from mogasr.hmm.topology import build_topology
    from mogasr.lm.ngram import estimate_bigram

    fcfg = FrontendConfig()
    bcfg = BatchConfig(batch_size=8, bucket_boundaries=(250, 400))
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())

    train = make_corpus(args.train_utts, words_per_utt=(2, 4), seed=100)
    test = make_corpus(args.test_utts, words_per_utt=(2, 4), seed=999)
    tb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in train], fcfg, bcfg)
    eb = pipe.featurize([(u.utt_id, u.wave, u.words) for u in test], fcfg, bcfg)

    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=4, feat_dim=fcfg.feat_dim)
    res = pipe.train_gmm(
        tb, lex, topo, gcfg, TrainConfig(num_em_iters=8), reestimate_transitions=True
    )
    gmm, topo_t = res.gmm, res.topo
    results = {
        "train_utts": args.train_utts,
        "test_utts": args.test_utts,
        "gmm": f"{gmm.n_states}x{gmm.n_components}",
        "em_loglik_first": round(res.history[0], 3),
        "em_loglik_last": round(res.history[-1], 3),
    }

    refs = [[w.lower() for w in fb.words[b]] for fb in eb for b in range(fb.size)]

    # (a) unigram loop decode on held-out
    m = pipe.evaluate(eb, gmm, lex, topo_t, dcfg)
    results["heldout_wer_gmm_unigram"] = round(m["wer"], 4)

    # (b) bigram LM (trained on the TRAIN transcripts only)
    graph = pipe.word_decode_graph(lex, topo_t, dcfg)
    lm = estimate_bigram(
        [fb.words[b] for fb in tb for b in range(fb.size)], graph.labels, alpha=0.2
    )
    hyps = []
    for fb in eb:
        scores = pipe.score_batch(fb.feats, gmm)
        r = viterbi_lm(scores, graph, lm, fb.n_frames, acoustic_scale=1.0,
                       insertion_penalty=dcfg.word_insertion_penalty)
        toks = path_to_tokens_lm(r, graph)
        hyps.extend([[w.lower() for w in h if w != "<sil>"] for h in toks[: fb.size]])
    wer_lm, _ = corpus_wer(refs, hyps)
    results["heldout_wer_gmm_bigram"] = round(wer_lm, 4)

    # (b2) trigram lattice rescoring: bigram first pass -> word lattices ->
    # exact second-pass search under an interpolated trigram (train text only)
    from mogasr.decoder.lattice import rescore_lattice
    from mogasr.lm.ngram import estimate_trigram

    tri_lm = estimate_trigram(
        [fb.words[b] for fb in tb for b in range(fb.size)], graph.labels
    )
    hyps_tri = []
    for fb in eb:
        scores = pipe.score_batch(fb.feats, gmm)
        lats, _ = pipe.decode_batch_lattices(fb, scores, graph, lm, dcfg)
        hyps_tri.extend(
            [[w.lower() for w in rescore_lattice(lat, tri_lm)[0]] for lat in lats]
        )
    results["heldout_wer_gmm_trigram_rescore"] = round(
        corpus_wer(refs, hyps_tri)[0], 4
    )

    # (b3) MMI discriminative refinement of the ML GMM (dense denominator)
    from mogasr.am.mmi import train_mmi

    gmm_mmi, mmi_hist = train_mmi(tb, lex, topo_t, gmm, n_iters=3, acoustic_scale=0.1)
    m_mmi = pipe.evaluate(eb, gmm_mmi, lex, topo_t, dcfg)
    results["mmi_criterion_first"] = round(mmi_hist[0], 5)
    results["mmi_criterion_last"] = round(mmi_hist[-1], 5)
    results["heldout_wer_gmm_mmi"] = round(m_mmi["wer"], 4)

    # (b4) sMBR discriminative refinement (expected frame accuracy objective)
    from mogasr.am.smbr import train_smbr

    gmm_smbr, smbr_hist = train_smbr(tb, lex, topo_t, gmm, n_iters=3, acoustic_scale=0.1)
    m_smbr = pipe.evaluate(eb, gmm_smbr, lex, topo_t, dcfg)
    results["smbr_expected_acc_first"] = round(smbr_hist[0], 5)
    results["smbr_expected_acc_last"] = round(smbr_hist[-1], 5)
    results["heldout_wer_gmm_smbr"] = round(m_smbr["wer"], 4)

    # (b5) consensus (confusion-network MBR) decoding of the bigram lattices
    from mogasr.decoder.confusion import confusion_network, consensus_decode

    hyps_cn = []
    for fb in eb:
        scores = pipe.score_batch(fb.feats, gmm)
        lats, _ = pipe.decode_batch_lattices(fb, scores, graph, lm, dcfg)
        hyps_cn.extend(
            [[w.lower() for w in consensus_decode(confusion_network(lat, lm))[0]]
             for lat in lats]
        )
    results["heldout_wer_gmm_consensus"] = round(corpus_wer(refs, hyps_cn)[0], 4)

    # (b6) alignment-free CTC system (no GMM anywhere in its training path)
    from mogasr.am import ctc as C

    ctc_tcfg = TrainConfig(
        nn_hidden=128, nn_layers=2, nn_context=3, lr=3e-3, num_nn_steps=300
    )
    ctc_model, ctc_params = pipe.train_ctc(tb, lex, ctc_tcfg, arch="mlp")
    ctc_dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=0.0)
    m_ctc = pipe.evaluate(
        eb, None, lex, None, ctc_dcfg,
        scorer=C.make_ctc_scorer(ctc_model, ctc_params),
        graph=C.ctc_decode_graph(lex, ctc_dcfg),
    )
    results["heldout_wer_ctc"] = round(m_ctc["wer"], 4)

    # (b7) RNN-transducer (alignment-free, streaming-native): held-out PER
    from mogasr.am.rnnt import rnnt_greedy_decode_device as rnnt_greedy_decode

    # low-data transducer recipe: stateless prediction net +
    # auxiliary CTC loss (pipe.train_rnnt defaults) — the LSTM prediction
    # net without aux supervision memorizes this 48-utt set (PER 0.87)
    rnnt_tcfg = TrainConfig(nn_hidden=128, nn_layers=2, lr=3e-3, num_nn_steps=800)
    rnnt_model, rnnt_params = pipe.train_rnnt(tb, lex, rnnt_tcfg)

    def phone_refs_hyps(decode_fn):
        refs_p, hyps_p = [], []
        for fb in eb:
            out = decode_fn(fb)
            for b in range(fb.size):
                refs_p.append([
                    lex.phones[p]
                    for p in C.ctc_labels_from_words(lex, fb.words[b])
                ])
                hyps_p.append([lex.phones[p] for p in out[b]])
        return refs_p, hyps_p

    refs_p, hyps_p = phone_refs_hyps(
        lambda fb: rnnt_greedy_decode(rnnt_model, rnnt_params, fb.feats, fb.n_frames)
    )
    results["heldout_per_rnnt"] = round(corpus_wer(refs_p, hyps_p)[0], 4)

    # CTC greedy phone decode on the same metric, for comparison
    refs_p, hyps_p = phone_refs_hyps(
        lambda fb: C.ctc_greedy_decode(
            ctc_model.apply(ctc_params, fb.feats, fb.n_frames), fb.n_frames
        )
    )
    results["heldout_per_ctc_greedy"] = round(corpus_wer(refs_p, hyps_p)[0], 4)

    # (b8) lexicon-free BPE-CTC: greedy subword units -> words, no graph
    from mogasr.data.bpe import train_bpe

    bpe = train_bpe([fb.words[b] for fb in tb for b in range(fb.size)], n_merges=60)
    bpe_model, bpe_params = pipe.train_ctc_bpe(tb, bpe, ctc_tcfg, arch="mlp")
    refs_w, hyps_w = [], []
    for fb in eb:
        out = C.ctc_greedy_decode(
            bpe_model.apply(bpe_params, fb.feats, fb.n_frames), fb.n_frames
        )
        for b in range(fb.size):
            refs_w.append([w.lower() for w in fb.words[b]])
            hyps_w.append(bpe.decode(out[b]))
    results["heldout_wer_ctc_bpe_lexfree"] = round(corpus_wer(refs_w, hyps_w)[0], 4)

    # (c) hybrid MLP AM trained on GMM alignments
    labeled = []
    for fb in tb:
        _r, labels, _ = pipe.align_batch(fb, gmm, lex, topo_t)
        labeled.append((fb, labels))
    tcfg = TrainConfig(nn_hidden=128, nn_layers=2, nn_context=3, lr=2e-3, num_nn_steps=300)
    model = build_model("mlp", topo.n_pdfs, tcfg)
    state = init_train_state(model, tcfg, fcfg.feat_dim, jax.random.key(0))
    step = make_train_step(model, tcfg)
    for i in range(tcfg.num_nn_steps):
        fb, labels = labeled[i % len(labeled)]
        state, metrics = step(state, fb.feats, fb.n_frames, labels)
    results["nn_final_frame_acc"] = round(float(metrics["frame_acc"]), 4)
    all_labels = np.concatenate([np.asarray(l).reshape(-1) for _, l in labeled])
    scorer = pipe.make_nn_scorer(
        model, state.params, jnp.asarray(state_priors(all_labels, topo.n_pdfs))
    )
    m_nn = pipe.evaluate(eb, None, lex, topo_t, dcfg, scorer=scorer)
    results["heldout_wer_mlp_unigram"] = round(m_nn["wer"], 4)

    # (d) tied-triphone system
    from mogasr.hmm import triphone as tri

    # ~120 pdfs: on 48 training utterances, more tied states starve each pdf
    # of data (200 pdfs measured 10% WER vs 1.4% monophone on this corpus)
    tied, res_cd = pipe.train_triphone(
        tb, lex, topo_t, gcfg, TrainConfig(num_em_iters=6), gmm,
        target_pdfs=120, min_occ=20.0,
    )
    graph_cd = tri.word_loop_graph_cd(tied, insertion_penalty=dcfg.word_insertion_penalty)
    refs_cd, hyps_cd = [], []
    for fb in eb:
        scores = pipe.score_batch(fb.feats, res_cd.gmm)
        out = pipe.decode_batch(fb, scores, graph_cd, dcfg)
        for b in range(fb.size):
            refs_cd.append([w.lower() for w in fb.words[b]])
            hyps_cd.append([w.lower() for w in out[b]])
    results["tied_pdfs"] = tied.n_pdfs
    results["heldout_wer_triphone"] = round(corpus_wer(refs_cd, hyps_cd)[0], 4)

    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results_accuracy.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
