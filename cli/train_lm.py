"""Neural language-model training (LSTM or Transformer) over corpus
transcripts.

Trains a mogasr.lm.neural model on the training-split transcripts, reports
held-out perplexity next to a Kneser-Ney bigram baseline on the same split,
and saves the checkpoint + vocabulary for second-pass N-best rescoring
(``cli/decode.py --nnlm-rescore``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from cli.common import add_corpus_args, add_run_args, load_corpus, make_logger
from mogasr.config import TrainConfig
from mogasr.utils.metrics import Timer


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_corpus_args(p)
    add_run_args(p)
    p.add_argument("--nnlm-arch", default="lstm",
                   choices=["lstm", "transformer"],
                   help="neural LM architecture: recurrent (unbounded "
                        "context, O(U) scan) or causal Transformer "
                        "(GEMM-parallel over positions — the accelerator-friendly "
                        "default for offline rescoring)")
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--heldout-frac", type=float, default=0.1,
                   help="fraction of transcripts held out for perplexity")
    p.add_argument("--unit-ngram", action="store_true",
                   help="instead of the neural word LM, estimate a KN "
                        "bigram over UNIT ids for shallow fusion "
                        "(decode/stream/serve --fusion-lm): BPE units with "
                        "--bpe, else lexicon PHONE ids (decode --rnnt "
                        "--rnnt-beam fusion)")
    p.add_argument("--bpe", metavar="FILE", help="bpe.json (with --unit-ngram)")
    p.add_argument("--kn-discount", type=float, default=0.75)
    args = p.parse_args()

    corpus, lex = load_corpus(args)
    logger = make_logger(args)

    from mogasr.lm import neural as NL
    from mogasr.lm.ngram import estimate_bigram_kn, sequence_logp

    transcripts = [[w.lower() for w in words] for _, _, words in corpus]
    n_held = max(1, int(len(transcripts) * args.heldout_frac))
    train, held = transcripts[:-n_held], transcripts[-n_held:]

    if args.unit_ngram:
        from mogasr.lm.unit_ngram import (
            estimate_unit_bigram, save_unit_lm, unit_perplexity,
        )

        if args.bpe:
            from mogasr.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
            encode, n_units, kind = bpe.encode, bpe.n_units, "bpe"
        else:
            # phone expansion needs lexicon-cased words, not the lowercased
            # word-LM view
            raw = [list(words) for _, _, words in corpus]
            train, held = raw[:-n_held], raw[-n_held:]
            encode = lambda s: lex.words_to_phone_ids(s, oov="sil")
            n_units, kind = lex.n_phones, "phone"
        with Timer() as t:
            lm = estimate_unit_bigram(
                [encode(s) for s in train], n_units,
                discount=args.kn_discount,
            )
        ppl = unit_perplexity(lm, [encode(s) for s in held])
        out = os.path.join(os.path.abspath(args.run_dir), "unit_lm.npz")
        save_unit_lm(out, lm)
        logger.log({
            "stage": "train_unit_lm_done", "wall_sec": t.seconds,
            "heldout_unit_ppl": round(ppl, 3), "n_units": n_units,
            "units": kind, "train_sents": len(train),
        })
        print(f"saved {kind}-unit bigram LM to {out} "
              f"(held-out unit ppl {ppl:.2f}, V={n_units})")
        return
    vocab = NL.vocab_from_transcripts(train)
    # guard: held-out OOVs go to <unk> in the neural model but would KeyError
    # in the count-based baseline — restrict the baseline to in-vocab rows
    known = set(vocab.tokens)
    held_iv = [s for s in held if all(w in known for w in s)]

    cfg = TrainConfig(nn_hidden=args.hidden, nn_layers=args.layers,
                      lr=args.lr, num_nn_steps=args.steps)
    with Timer() as t:
        model, params = NL.train_nnlm(
            train, vocab, cfg, batch_size=args.batch_size,
            arch=args.nnlm_arch, logger=logger,
        )
    ppl = NL.nnlm_perplexity(model, params, vocab, held)

    kn_ppl = None
    if held_iv:
        kn = estimate_bigram_kn(train, list(vocab.tokens))
        nll, n_tok = 0.0, 0
        for s in held_iv:
            nll -= sequence_logp(kn, s)
            n_tok += len(s) + 1  # eos counts, matching nnlm_perplexity
        kn_ppl = float(np.exp(nll / n_tok))

    ckpt = os.path.join(os.path.abspath(args.run_dir), "nnlm")
    NL.save_nnlm(ckpt, model, params, vocab)
    logger.log({
        "stage": "train_nnlm_done", "arch": args.nnlm_arch,
        "steps": args.steps,
        "wall_sec": t.seconds, "heldout_ppl": round(ppl, 3),
        "kn_bigram_ppl": round(kn_ppl, 3) if kn_ppl is not None else None,
        "vocab": vocab.n_tokens, "train_sents": len(train),
    })
    print(f"saved neural LM to {ckpt} (held-out ppl {ppl:.2f}"
          + (f", KN bigram baseline {kn_ppl:.2f})" if kn_ppl else ")"))


if __name__ == "__main__":
    main()
