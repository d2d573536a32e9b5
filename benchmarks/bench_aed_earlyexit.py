"""AED engine finals: early-exit beam vs fixed-scan A/B + tick/final profile.

Round-3 VERDICT item 3: the AED engine served 48.4 realtime streams at
capacity 64 — the only engine below capacity-realtime — with no artifact
isolating why. This benchmark (a) profiles where an epoch's time goes
(chunk ticks vs partials vs drain finalization), and (b) A/Bs the round-4
fix: `make_aed_decoder(early_exit=True)` stops the attention-beam final as
soon as every beam has emitted eos instead of paying the worst-case token
budget `aed_final_max_tokens(T) = 2 + T/4` (~322 sequential steps for a
12 s session, ~5-10x a real transcript; each step recomputes the causal
decoder over the full buffer, so the budget multiplies the whole final).
Hypotheses are bitwise-identical (tests/test_aed.py::
test_early_exit_beam_equals_full_scan).

Protocol: interleaved epochs across the two arms, multi-second
windows, median; full session lifecycle per epoch.

    python benchmarks/bench_aed_earlyexit.py --capacity 64 --epochs 3
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "results_aed_earlyexit_ab.json")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--utt-seconds", type=float, default=12.0)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--aed-chunk", type=int, default=8)
    p.add_argument("--partial-every", type=int, default=8)
    p.add_argument("--train-steps", type=int, default=0,
                   help="train the AED on the synthetic corpus first (BPE "
                        "units to keep V~300). Early-exit finals are "
                        "weight-DEPENDENT: random weights never emit eos, "
                        "so only a trained model shows the real final "
                        "cost; a trained arm is the honest measurement.")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=None,
                   help="output JSON filename under benchmarks/ (default "
                        "results_aed_earlyexit_ab.json)")
    args = p.parse_args()

    from mogasr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from mogasr.am import aed as A
    from mogasr.config import FrontendConfig, TrainConfig
    from mogasr.data import synthetic as syn
    from mogasr.serving.engine import BatchedAedEngine

    import dataclasses

    fcfg = dataclasses.replace(
        FrontendConfig(), cmvn="sliding", cmvn_window=600)
    sr, hop = fcfg.sample_rate, fcfg.frame_shift

    V_AED = 300
    tcfg = TrainConfig(nn_hidden=256, nn_layers=4,
                       num_nn_steps=max(args.train_steps, 1))
    if args.train_steps > 0:
        from mogasr import pipeline as pipe
        from mogasr.config import BatchConfig
        from mogasr.data.bpe import train_bpe
        from mogasr.hmm.lexicon import synthetic_lexicon

        lex = synthetic_lexicon()
        train_utts = syn.make_corpus(48, words_per_utt=(4, 7), seed=5)
        batches = pipe.featurize(
            [(u.utt_id, u.wave, u.words) for u in train_utts],
            dataclasses.replace(fcfg, cmvn="sliding", cmvn_window=600),
            BatchConfig(batch_size=16, bucket_boundaries=(250, 400, 600)),
        )
        transcripts = [fb.words[b] for fb in batches for b in range(fb.size)]
        bpe = train_bpe(transcripts, n_merges=max(V_AED - 30, 1))
        print(f"training AED (BPE V={bpe.n_units}) for "
              f"{args.train_steps} steps ...", flush=True)
        model, params = pipe.train_aed_bpe(
            batches, bpe, tcfg, chunk_frames=args.aed_chunk, left_chunks=1)
    else:
        model = A.build_aed_model(
            V_AED, tcfg, chunk_frames=args.aed_chunk, left_chunks=1)
        params = A.init_aed_train_state(
            model, tcfg, fcfg.feat_dim, 4, jax.random.key(2)).params

    engines = {
        # round-4 production: deferred logp absorption (sync once per
        # partial boundary, not per tick) + early-exit finals
        "deferred": BatchedAedEngine(
            model, params, fcfg, capacity=args.capacity, beam=4,
            ctc_weight=0.3, final_early_exit=True, defer_absorb=True),
        # round-3 production: per-tick pull + fixed-scan finals
        "immediate": BatchedAedEngine(
            model, params, fcfg, capacity=args.capacity, beam=4,
            ctc_weight=0.3, final_early_exit=False, defer_absorb=False),
    }
    tick_frames = engines["deferred"].tick_frames
    tick_samples = tick_frames * hop
    n_tick = int(args.utt_seconds * sr) // tick_samples

    rng = np.random.default_rng(7)
    waves = []
    for b in range(args.capacity):
        w = np.concatenate([
            u.wave for u in syn.make_corpus(
                4, words_per_utt=(4, 7), seed=100 + b)])
        reps = int(np.ceil(n_tick * tick_samples / len(w)))
        waves.append(np.tile(w, reps)[: n_tick * tick_samples]
                     .astype(np.float32))

    def run_epoch(eng):
        """-> (frames, t_ticks, t_partials, t_drain_final)"""
        sids = [f"s{e}" for e in range(args.capacity)]
        for sid in sids:
            assert eng.start(sid)
        base = eng.frames_decoded
        t_ticks = t_part = 0.0
        for t in range(n_tick):
            for b, sid in enumerate(sids):
                eng.feed(sid,
                         waves[b][t * tick_samples:(t + 1) * tick_samples])
            t0 = time.perf_counter()
            eng.tick()
            t_ticks += time.perf_counter() - t0
            if args.partial_every and (t + 1) % args.partial_every == 0:
                t0 = time.perf_counter()
                eng.partials(sids)
                t_part += time.perf_counter() - t0
        for sid in sids:
            eng.end(sid)
        t0 = time.perf_counter()
        while not all(eng.drained(sid) for sid in sids):
            eng.tick()
        eng.finalize_many(sids)
        t_final = time.perf_counter() - t0
        return eng.frames_decoded - base, t_ticks, t_part, t_final

    for name, eng in engines.items():
        t0 = time.perf_counter()
        run_epoch(eng)
        print(f"warmup [{name}]: {time.perf_counter() - t0:.1f} s",
              flush=True)

    rates = {n: [] for n in engines}
    profiles = {n: [] for n in engines}
    for e in range(args.epochs):
        for name, eng in engines.items():
            t0 = time.perf_counter()
            frames, t_ticks, t_part, t_final = run_epoch(eng)
            dt = time.perf_counter() - t0
            rates[name].append(frames / dt)
            profiles[name].append({
                "ticks_s": round(t_ticks, 2),
                "partials_s": round(t_part, 2),
                "drain_final_s": round(t_final, 2),
                "total_s": round(dt, 2),
            })
            print(f"  epoch {e} [{name}]: {frames / dt:.0f} frames/s "
                  f"(ticks {t_ticks:.1f}s partials {t_part:.1f}s "
                  f"final {t_final:.1f}s)", flush=True)

    med = {n: statistics.median(rs) for n, rs in rates.items()}
    row = {
        "metric": "aed_engine_finals_ab",
        "capacity": args.capacity,
        "utt_seconds": args.utt_seconds,
        "streams_realtime": {
            n: round(m / (sr / hop), 1) for n, m in med.items()},
        "frames_per_sec": {n: round(m, 1) for n, m in med.items()},
        "epoch_rates": {n: [round(r, 1) for r in rs]
                        for n, rs in rates.items()},
        "profiles": profiles,
        "speedup": round(med["deferred"] / med["immediate"], 2),
        "train_steps": args.train_steps,
        "backend": jax.default_backend(),
        # record the model's ACTUAL vocab: BPE merge training saturates on
        # the synthetic corpus's limited symbol inventory (V=99 observed),
        # well below the V_AED=300 target — the in-session A/B arms share
        # the model so the ratio is fair, but absolute stream counts are
        # for the actual vocab, not 300
        "model": (f"conformer d=256 L=4 V={model.vocab} "
                  f"chunk={args.aed_chunk}"),
        "note": "identical hypotheses both arms (deferred absorption "
                "replays the same logps; eos-saturated final steps are "
                "no-ops — both tested on CPU). NOTE early-exit finals are "
                "weight-DEPENDENT: this harness's random weights rarely "
                "emit eos, so its final-time gain here is ~none; trained "
                "models exit at transcript length (~5-10x fewer steps).",
    }
    out_path = (os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             args.out) if args.out else OUT)
    with open(out_path, "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
