"""config[2] training side: monophone GMM-HMM EM training with realignment.

featurize -> flat start -> EM with mixture splitting -> checkpoint.
"""

from __future__ import annotations

import argparse
import os

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from cli.common import (
    add_augment_args, add_corpus_args, add_run_args, apply_augmentation,
    load_corpus, make_logger,
)
from mogasr.config import BatchConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig
from mogasr.hmm.topology import build_topology
from mogasr.pipeline import featurize, train_gmm
from mogasr.utils.metrics import Timer


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--add-pitch", action="store_true",
                   help="append the (POV, centered log-f0, delta log-f0) pitch "
                        "triple to the features (frontend/pitch.py) — must "
                        "match between training and decoding")
    add_corpus_args(p)
    add_run_args(p)
    add_augment_args(p)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--mode", default="viterbi", choices=["viterbi", "baum-welch"],
                   help="hard (Viterbi) EM or full Baum-Welch soft EM")
    p.add_argument("--triphones", type=int, default=0, metavar="N_PDFS",
                   help="after monophone training, build a tied-triphone "
                        "system with ~N_PDFS states and run CD EM")
    p.add_argument("--mmi", type=int, default=0, metavar="ITERS",
                   help="discriminative MMI refinement iterations after ML "
                        "training (dense denominator, extended Baum-Welch)")
    p.add_argument("--smbr", type=int, default=0, metavar="ITERS",
                   help="discriminative sMBR refinement iterations after ML "
                        "training (expected frame accuracy, I-smoothed EBW)")
    p.add_argument("--disc-acoustic-scale", type=float, default=0.1,
                   help="acoustic scale (kappa) for --mmi/--smbr")
    p.add_argument("--bundle-out", metavar="DIR",
                   help="export the trained system (GMM + lexicon + topology "
                        "[+ tied triphones] + frontend config) as a deployable "
                        "bundle dir for decode/eval --bundle (utils/bundle.py)")
    p.add_argument("--lda", type=int, default=0, metavar="CONTEXT",
                   help="after monophone training, train a splice(+-CONTEXT)"
                        "->LDA->MLLT system bootstrapped from its alignments")
    p.add_argument("--lda-dim", type=int, default=40,
                   help="LDA projection dimension (with --lda)")
    args = p.parse_args()

    corpus, lex = load_corpus(args)
    corpus = apply_augmentation(corpus, args)
    fcfg = FrontendConfig(add_pitch=args.add_pitch)
    topo = build_topology(lex, TopologyConfig())
    gcfg = GmmConfig(
        n_states=topo.n_pdfs, n_components=args.num_components, feat_dim=fcfg.feat_dim
    )
    tcfg = TrainConfig(num_em_iters=args.num_iters)
    logger = make_logger(args)

    with Timer() as t:
        batches = featurize(corpus, fcfg, BatchConfig())
        gmm, history = train_gmm(
            batches, lex, topo, gcfg, tcfg, logger=logger, mode=args.mode,
            ckpt_dir=os.path.join(os.path.abspath(args.run_dir), "em_ckpt"),
        )
    logger.log({
        "stage": "train_gmm_done", "iters": len(history),
        "final_avg_loglik": history[-1], "wall_sec": t.seconds,
        "K": gmm.n_components, "S": gmm.n_states,
    })
    if args.mmi > 0:
        from mogasr.am.mmi import train_mmi

        with Timer() as tm:
            gmm, mmi_hist = train_mmi(
                batches, lex, topo, gmm, n_iters=args.mmi,
                acoustic_scale=args.disc_acoustic_scale, logger=logger,
            )
        logger.log({
            "stage": "train_mmi_done", "iters": len(mmi_hist),
            "criterion_first": mmi_hist[0], "criterion_last": mmi_hist[-1],
            "wall_sec": tm.seconds,
        })
    if args.smbr > 0:
        from mogasr.am.smbr import train_smbr

        with Timer() as ts:
            gmm, smbr_hist = train_smbr(
                batches, lex, topo, gmm, n_iters=args.smbr,
                acoustic_scale=args.disc_acoustic_scale, logger=logger,
            )
        logger.log({
            "stage": "train_smbr_done", "iters": len(smbr_hist),
            "expected_acc_first": smbr_hist[0], "expected_acc_last": smbr_hist[-1],
            "wall_sec": ts.seconds,
        })

    from mogasr.utils.checkpoint import save_checkpoint  # orbax, checkpoints only

    ckpt = os.path.join(os.path.abspath(args.run_dir), "gmm")
    save_checkpoint(ckpt, gmm._asdict(), step=len(history))
    print(f"saved GMM ({gmm.n_states} states x {gmm.n_components} comps) to {ckpt}")

    if args.lda > 0:
        import numpy as np

        from mogasr.pipeline import train_lda_mllt

        with Timer() as tl:
            sys_lda = train_lda_mllt(
                corpus, lex, topo, fcfg, BatchConfig(), gcfg, tcfg, gmm,
                context=args.lda, lda_dim=args.lda_dim, logger=logger,
                mode=args.mode,
            )
        logger.log({
            "stage": "train_lda_mllt_done", "context": args.lda,
            "lda_dim": args.lda_dim,
            "final_avg_loglik": sys_lda.history[-1], "wall_sec": tl.seconds,
        })
        lda_ckpt = os.path.join(os.path.abspath(args.run_dir), "gmm_lda")
        save_checkpoint(
            lda_ckpt,
            {
                **sys_lda.gmm._asdict(),
                "lda_transform": np.asarray(sys_lda.transform),
                "lda_context": np.asarray([args.lda], np.int32),
            },
            step=len(sys_lda.history),
        )
        print(f"saved LDA+MLLT GMM ({args.lda_dim}-dim, context "
              f"+-{args.lda}) to {lda_ckpt}")

    if args.triphones > 0:
        from mogasr.pipeline import train_triphone

        with Timer() as t2:
            tied, res = train_triphone(
                batches, lex, topo, gcfg, tcfg, gmm, target_pdfs=args.triphones,
                logger=logger, mode=args.mode,
            )
        logger.log({
            "stage": "train_cd_done", "tied_pdfs": tied.n_pdfs,
            "final_avg_loglik": res.history[-1], "wall_sec": t2.seconds,
        })
        cd_ckpt = os.path.join(os.path.abspath(args.run_dir), "gmm_cd")
        save_checkpoint(cd_ckpt, res.gmm._asdict(), step=len(res.history))
        print(f"saved CD GMM ({tied.n_pdfs} tied pdfs) to {cd_ckpt}")

    if args.bundle_out:
        from mogasr.utils.bundle import save_system

        if args.triphones > 0:
            save_system(args.bundle_out, res.gmm, topo, fcfg, tied=tied,
                        meta={"source": "cli/train_gmm.py",
                              "final_avg_loglik": res.history[-1]})
        else:
            save_system(args.bundle_out, gmm, topo, fcfg,
                        meta={"source": "cli/train_gmm.py",
                              "final_avg_loglik": history[-1]})
        print(f"wrote deployable bundle to {args.bundle_out} "
              f"(decode/eval --bundle)")


if __name__ == "__main__":
    main()
