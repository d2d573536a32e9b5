"""Shared CLI plumbing: corpus loading, config overrides, run dirs."""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from mogasr.config import PipelineConfig, override
from mogasr.hmm.lexicon import Lexicon, load_lexicon, synthetic_lexicon
from mogasr.utils.compile_cache import enable_compile_cache
from mogasr.utils.metrics import RunLogger

enable_compile_cache()


def add_corpus_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--librispeech-root", help="LibriSpeech root directory")
    p.add_argument("--split", default="dev-clean", help="corpus split name")
    p.add_argument(
        "--synthetic", type=int, default=0, metavar="N",
        help="use N synthetic utterances instead of a real corpus",
    )
    p.add_argument("--synthetic-seed", type=int, default=0)
    p.add_argument(
        "--synthetic-v2", type=int, default=0, metavar="N",
        help="use N v2 (coarticulated multi-speaker noisy, 300-word phrase "
             "language) synthetic utterances — the corpus the headline "
             "bundle is trained on",
    )
    p.add_argument("--manifest", metavar="FILE",
                   help="JSONL manifest corpus: one {'audio': PATH, 'text': "
                        "WORDS[, 'id': ID]} per line; relative audio paths "
                        "resolve against the manifest dir; wav + flac "
                        "(mogasr.data.manifest); requires --lexicon")
    p.add_argument("--lexicon", help="Kaldi-style lexicon.txt (word phone...)")
    p.add_argument("--max-utts", type=int, default=0, help="limit corpus size")


def add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--run-dir", default="runs/default", help="metrics/ckpt dir")
    p.add_argument("--profile", action="store_true", help="emit jax profiler trace")


def add_augment_args(p: argparse.ArgumentParser) -> None:
    """Training-time waveform augmentation (mogasr.data.augment)."""
    p.add_argument("--speed-perturb", action="store_true",
                   help="Kaldi-style 3-way speed perturbation (0.9/1.0/1.1): "
                        "triples the training corpus")
    p.add_argument("--aug-snr", metavar="LO,HI",
                   help="additive white noise at a per-utterance SNR drawn "
                        "uniformly from [LO, HI] dB")
    p.add_argument("--aug-gain", metavar="LO,HI",
                   help="random volume perturbation, gain drawn uniformly "
                        "from [LO, HI] dB")


def apply_augmentation(corpus, args):
    """Expand/perturb the corpus per the add_augment_args flags."""
    if not (getattr(args, "speed_perturb", False) or args.aug_snr or args.aug_gain):
        return corpus
    from mogasr.data.augment import augment_corpus

    def _range(s):
        lo, hi = (float(x) for x in s.split(","))
        return (lo, hi)

    return augment_corpus(
        corpus,
        speed_factors=(0.9, 1.0, 1.1) if args.speed_perturb else (1.0,),
        snr_db_range=_range(args.aug_snr) if args.aug_snr else None,
        gain_db_range=_range(args.aug_gain) if args.aug_gain else None,
        seed=getattr(args, "synthetic_seed", 0),
    )


def load_corpus(args) -> Tuple[List[Tuple[str, np.ndarray, List[str]]], Lexicon]:
    """Returns ([(utt_id, wave, words)], lexicon)."""
    if getattr(args, "synthetic_v2", 0) > 0:
        from mogasr.data.synthetic import extended_lexicon, make_corpus_v2
        from mogasr.hmm.lexicon import make_lexicon

        wl = extended_lexicon()
        utts = make_corpus_v2(args.synthetic_v2, lexicon=wl,
                              seed=args.synthetic_seed)
        corpus = [(u.utt_id, u.wave, u.words) for u in utts]
        lex = make_lexicon(wl)
    elif args.synthetic > 0:
        from mogasr.data.synthetic import make_corpus

        utts = make_corpus(args.synthetic, seed=args.synthetic_seed)
        corpus = [(u.utt_id, u.wave, u.words) for u in utts]
        lex = synthetic_lexicon()
    elif getattr(args, "manifest", None):
        from mogasr.data.manifest import read_manifest

        corpus = read_manifest(
            args.manifest, max_utts=getattr(args, "max_utts", 0) or 0
        )
        if args.lexicon:
            lex = load_lexicon(args.lexicon)
        else:
            raise SystemExit("--lexicon is required with --manifest")
    elif args.librispeech_root:
        from mogasr.data.librispeech import LibriSpeech

        ls = LibriSpeech(args.librispeech_root, args.split)
        corpus = [
            (utt_id, wave, text.lower().split())
            for utt_id, wave, text in ls
        ]
        if args.lexicon:
            lex = load_lexicon(args.lexicon)
        else:
            raise SystemExit("--lexicon is required with --librispeech-root")
    else:
        raise SystemExit("pass --synthetic N, --synthetic-v2 N, --manifest FILE, or --librispeech-root DIR")
    if args.max_utts:
        corpus = corpus[: args.max_utts]
    return corpus, lex


def make_logger(args) -> RunLogger:
    return RunLogger(args.run_dir)
