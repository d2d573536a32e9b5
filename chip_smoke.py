"""Smoke test of the GMM-HMM system on an NVIDIA GPU, through its entry points.

Run from the root of a checkout on a machine with a GPU:

    python chip_smoke.py               # one card, four phases
    python chip_smoke.py --four-cards  # the data-parallel eval path on 4 cards

Phases (one card), each compared with the plain reference:
  1. GMM scorer parity at real widths: the headline model on 32768 frames of
     real features, and a random 1000 x 256 x 39 model on 8192 frames,
     against gmm_loglik at float32 "highest" on the CPU and the float64
     oracle on 256 rows.
  2. The headline decode end to end (the path bench.py times): utt/s, RTF
     and WER; float32 hypotheses equal the CPU plain path's on the first 64
     utterances; the production setting's WER is within 0.2 points of
     float32's.
  3. Three EM iterations of pipeline.train_gmm on 32 synthetic utterances:
     per-frame log-likelihood does not decrease and matches a CPU run.
  4. The GMM serving engine at capacity 64 (device feature path) answers 8
     sessions of about 3 s; every final equals the per-session decode.

--four-cards runs only the ('data',) mesh eval sweep and the sharded
decode/EM steps over 4 GPUs, each against one card.

Fails (exit 1, no result line) when JAX finds no GPU. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HALF = "float16"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def importable(module: str) -> bool:
    """Whether `module` imports, tried in a child that stays off the GPU."""
    out = subprocess.run(
        [sys.executable, "-c", f"import {module}"], capture_output=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    return out.returncode == 0


# ---------------------------------------------------------------- phase 1


def _oracle(x, gmm, mode, rows_per_chunk=8):
    from mogasr.am.gmm import gmm_loglik_np

    w, mu, var = map(np.asarray, gmm)
    return np.concatenate([
        gmm_loglik_np(x[i:i + rows_per_chunk], w, mu, var, mode=mode)
        for i in range(0, len(x), rows_per_chunk)])


def _scorer_case(name, x_np, gmm):
    import jax
    import jax.numpy as jnp

    from mogasr.am.gmm import gmm_loglik
    from mogasr.am.gmm_pallas import score_frames

    cpu = jax.devices("cpu")[0]
    x_cpu, gmm_cpu = jax.device_put((jnp.asarray(x_np), gmm), cpu)
    x = jnp.asarray(x_np)
    for mode in ("sum", "max"):
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jax.jit(lambda a, g: gmm_loglik(a, g, mode=mode))(
                x_cpu, gmm_cpu))
        oracle = _oracle(x_np[:256], gmm, mode)
        for dt in ("float32", HALF):
            fn = jax.jit(lambda a, g: score_frames(a, g, dt, mode))
            hlo = fn.lower(x, gmm).as_text()
            check("xla.gpu.triton" in hlo, f"{name}: the scorer did not lower "
                  "to the Triton kernel")
            got = np.asarray(fn(x, gmm))
            check(got.shape == ref.shape and np.isfinite(got).all(),
                  f"{name} {dt}/{mode}: shape {got.shape} or non-finite values")
            d = np.abs(got - ref)
            rel = d / np.maximum(np.abs(ref), 1e-30)
            d_or = np.abs(got[:256] - oracle)
            agree = float(np.mean(got.argmax(1) == ref.argmax(1)))
            print(f"  {name} {dt}/{mode}: scorer=triton-kernel "
                  f"max_abs={d.max():.3g} max_rel={rel.max():.3g} "
                  f"vs_oracle_max_abs={d_or.max():.3g} argmax_agree={agree:.5f}")
            if dt == "float32":
                check(np.allclose(got, ref, atol=1e-3, rtol=1e-4),
                      f"{name} float32/{mode}: outside atol=1e-3 rtol=1e-4")
                check(np.allclose(got[:256], oracle, atol=1e-3, rtol=1e-4),
                      f"{name} float32/{mode}: outside tolerance of the oracle")
            else:
                check(d.max() <= 0.5, f"{name} {dt}/{mode}: max |d| > 0.5 nats")
                check(agree >= 0.99, f"{name} {dt}/{mode}: best state agrees "
                      f"on {agree:.4f} < 0.99 of frames")


def phase_scorer(head):
    import jax.numpy as jnp

    from mogasr import pipeline as pipe
    from mogasr.am.gmm import GmmSet

    gmm, graph, fcfg, dcfg, bcfg, utts, _meta = head
    rows, n = [], 0
    for fb in pipe.featurize_iter(
            [(u.utt_id, u.wave, u.words) for u in utts[:160]], fcfg, bcfg):
        feats, nf = np.asarray(fb.feats), np.asarray(fb.n_frames)
        for b in range(fb.size):
            rows.append(feats[b, : nf[b]])
            n += int(nf[b])
    x = np.concatenate(rows)[:32768]
    check(x.shape[0] == 32768, f"only {x.shape[0]} real frames")
    _scorer_case("headline 1168x16x39 N=32768", x, gmm)

    rng = np.random.default_rng(7)
    S, K, D = 1000, 256, 39
    big = GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        jnp.asarray(rng.standard_normal((S, K, D)).astype(np.float32)),
        jnp.asarray((0.5 + rng.random((S, K, D))).astype(np.float32)),
    )
    xb = np.random.default_rng(1).standard_normal((8192, D)).astype(np.float32)
    _scorer_case("random 1000x256x39 N=8192", xb, big)


# ---------------------------------------------------------------- phase 2


def phase_decode(head, card):
    import jax

    import bench
    from mogasr.config import BatchConfig
    from mogasr.eval.wer import corpus_wer

    gmm, graph, fcfg, dcfg, bcfg, utts, _meta = head
    audio_s = sum(len(u.wave) for u in utts) / fcfg.sample_rate
    prepared = bench.prepare_batches(utts, fcfg, bcfg)
    hyps_by_setting = {}
    for dt, mode in (("float32", "sum"), (bench.SCORE_DTYPE, bench.SCORE_MODE)):
        run = bench.make_decoder(gmm, graph, dcfg, bcfg.batch_size, dt, mode)
        t0 = time.perf_counter()
        dt_s, _times, outs = bench.time_decode(run, prepared)
        total = time.perf_counter() - t0
        refs, hyps = bench.hypotheses(outs, prepared, graph, bcfg.batch_size)
        wer, _ = corpus_wer(refs, hyps)
        ids = [i for (_w, _n, _f, b) in prepared for i in b.utt_ids]
        hyps_by_setting[(dt, mode)] = (dict(zip(ids, hyps)), wer)
        print(f"  headline decode {dt}/{mode} on {card}: "
              f"{len(utts) / dt_s:.2f} utt/s, RTF {dt_s / audio_s:.3g}, "
              f"WER {100 * wer:.3f}% ({len(utts)} utts, {audio_s:.1f} s audio; "
              f"{total:.1f} s with compile and warm-up)")

    # the CPU plain path on the first 64 utterances
    cpu = jax.devices("cpu")[0]
    first64 = utts[:64]
    with jax.default_device(cpu):
        cbcfg = BatchConfig(batch_size=64, bucket_boundaries=bcfg.bucket_boundaries)
        cprep = bench.prepare_batches(first64, fcfg, cbcfg)
        crun = bench.make_decoder(gmm, graph, dcfg, 64, "float32", "sum")
        couts = [crun(w, n, f) for (w, n, f, _b) in cprep]
        _crefs, chyps = bench.hypotheses(couts, cprep, graph, 64)
    cids = [i for (_w, _n, _f, b) in cprep for i in b.utt_ids]
    gpu32 = hyps_by_setting[("float32", "sum")][0]
    diff = [i for i, h in zip(cids, chyps) if gpu32[i] != h]
    print(f"  float32 hypotheses equal to the CPU plain path on "
          f"{len(cids) - len(diff)}/{len(cids)} utterances")
    check(not diff, f"GPU float32 words differ from the CPU path on {diff[:5]}")
    w32 = hyps_by_setting[("float32", "sum")][1]
    wprod = hyps_by_setting[(bench.SCORE_DTYPE, bench.SCORE_MODE)][1]
    check(abs(wprod - w32) <= 0.002, f"production WER {wprod:.4f} vs float32 "
          f"{w32:.4f}: more than 0.2 points apart")


# ---------------------------------------------------------------- phase 3


def _train(n_iters):
    from mogasr import pipeline as pipe
    from mogasr.config import (
        BatchConfig, FrontendConfig, GmmConfig, TopologyConfig, TrainConfig,
    )
    from mogasr.data.synthetic import make_corpus
    from mogasr.hmm.lexicon import synthetic_lexicon
    from mogasr.hmm.topology import build_topology

    fcfg = FrontendConfig()
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    utts = make_corpus(32, words_per_utt=(2, 4), seed=3)
    batches = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg,
                             BatchConfig(batch_size=16, bucket_boundaries=(250, 400)))
    gcfg = GmmConfig(n_states=topo.n_pdfs, n_components=1, feat_dim=fcfg.feat_dim)
    return pipe.train_gmm(batches, lex, topo, gcfg,
                          TrainConfig(num_em_iters=n_iters)).history


def phase_train():
    import jax

    hist = _train(3)
    with jax.default_device(jax.devices("cpu")[0]):
        hist_cpu = _train(3)
    print(f"  EM per-frame loglik GPU {hist}, CPU {hist_cpu}")
    check(len(hist) == 3 and np.isfinite(hist).all(), "EM history malformed")
    for a, b in zip(hist, hist[1:]):
        check(b >= a - 1e-5 * abs(a), f"EM loglik decreased: {hist}")
    check(np.allclose(hist, hist_cpu, rtol=1e-3, atol=0),
          f"EM loglik GPU {hist} vs CPU {hist_cpu}")


# ---------------------------------------------------------------- phase 4


def _words_of(graph, path, entered):
    toks = []
    for t in range(path.shape[0]):
        j = path[t]
        if j < 0:
            break
        if entered[t]:
            w = graph.labels[graph.chain_id[j]]
            if w not in ("<sil>", "sil"):
                toks.append(w)
    return toks


def _dedicated(graph, score_fn, fcfg, dcfg, wave, chunk=3000):
    """Per-session reference: StreamingFrontend + OnlineDecoder."""
    import jax.numpy as jnp

    from mogasr.decoder.online import OnlineDecoder
    from mogasr.frontend.streaming import StreamingFrontend
    from mogasr.hmm import graph as gr

    fe = StreamingFrontend(fcfg)
    graphs = {k: jnp.asarray(v) for k, v in gr.batch_graphs([graph]).items()}
    dec = OnlineDecoder(graphs, acoustic_scale=dcfg.acoustic_scale)
    pieces = [fe.process(wave[i:i + chunk]) for i in range(0, len(wave), chunk)]
    pieces.append(fe.finalize())
    for feats in pieces:
        if feats.size:
            dec.process(score_fn(jnp.asarray(feats[None])),
                        np.asarray([feats.shape[0]]))
    path, entered, _ = dec.finalize()
    return _words_of(graph, path[0], entered[0])


def phase_serve(head):
    import dataclasses

    from mogasr import pipeline as pipe
    from mogasr.serving.engine import BatchedSessionEngine

    gmm, graph, fcfg, dcfg, _bcfg, utts, _meta = head
    fcfg = dataclasses.replace(fcfg, cmvn="sliding", cmvn_window=300)
    sessions = [u for u in utts if 2.5 <= len(u.wave) / fcfg.sample_rate <= 3.5][:8]
    check(len(sessions) == 8, "fewer than 8 utterances of about 3 s")

    def score_fn(feats):
        return pipe.score_batch(feats, gmm)

    eng = BatchedSessionEngine(graph, score_fn, fcfg, dcfg, capacity=64,
                               tick_frames=16, max_frames=1000,
                               feature_path="device")
    rng = np.random.default_rng(3)
    for u in sessions:
        check(eng.start(u.utt_id), "engine refused a session")
    cursors = {u.utt_id: 0 for u in sessions}
    ended, got = set(), {}
    t0 = time.perf_counter()
    while len(got) < len(sessions):
        for u in sessions:
            sid = u.utt_id
            if sid in ended:
                continue
            off = cursors[sid]
            if off >= len(u.wave):
                eng.end(sid)
                ended.add(sid)
                continue
            n = int(rng.integers(500, 5000))
            eng.feed(sid, u.wave[off:off + n])
            cursors[sid] = off + n
        eng.tick()
        for sid in list(ended):
            if sid not in got and eng.drained(sid):
                got[sid], _audio = eng.finalize(sid)
    wall = time.perf_counter() - t0
    want = {u.utt_id: _dedicated(graph, score_fn, fcfg, dcfg, u.wave)
            for u in sessions}
    same = sum(got[s] == want[s] for s in want)
    print(f"  serving: {len(sessions)} sessions at capacity 64 in {wall:.1f} s "
          f"(incl. compile); finals equal to per-session decode: "
          f"{same}/{len(sessions)}")
    check(same == len(sessions), "an engine final differs from its reference")


# ---------------------------------------------------------------- four cards


def phase_four_cards(head):
    import jax
    import jax.numpy as jnp

    from mogasr import pipeline as pipe
    from mogasr.am import em
    from mogasr.config import MeshConfig
    from mogasr.decoder import viterbi as vit
    from mogasr.dist import mesh as M
    from mogasr.dist.sharded import make_sharded_decode_step, make_sharded_em_step
    from mogasr.hmm import graph as gr

    devs = jax.devices()
    check(len(devs) >= 4 and all(d.platform == "gpu" for d in devs[:4]),
          f"--four-cards needs 4 GPUs; JAX sees {len(devs)} {devs[0].platform}")
    mesh = M.make_mesh(MeshConfig(), devices=devs[:4])
    gmm, graph, fcfg, dcfg, bcfg, utts, _meta = head
    batches = pipe.featurize([(u.utt_id, u.wave, u.words) for u in utts], fcfg, bcfg)
    gmm_rep = M.replicate(gmm, mesh)

    # the eval sweep (cli/eval.py): data-sharded features -> score_batch
    # (per shard under shard_map) -> decode_batch
    t0 = time.perf_counter()
    one, four = [], []
    for fb in batches:
        one += pipe.decode_batch(fb, pipe.score_batch(fb.feats, gmm), graph, dcfg)
    t1 = time.perf_counter()
    for fb in batches:
        feats = jax.device_put(fb.feats, M.data_sharding(mesh))
        scores = pipe.score_batch(feats, gmm_rep)
        check(len(scores.sharding.device_set) == 4, "scores not on 4 cards")
        four += pipe.decode_batch(fb, scores, graph, dcfg)
    t2 = time.perf_counter()
    same = sum(a == b for a, b in zip(one, four))
    print(f"  eval sweep: {len(utts)} utts, 1 card {t1 - t0:.1f} s, 4 cards "
          f"{t2 - t1:.1f} s (both incl. compile); hypotheses identical "
          f"{same}/{len(one)}")
    check(same == len(one), "4-card hypotheses differ from 1 card")

    # sharded decode step vs the same step on one card
    fb = batches[0]
    graphs_np = gr.batch_graphs([graph] * fb.feats.shape[0])
    step4 = make_sharded_decode_step(mesh, dcfg.acoustic_scale)
    step1 = make_sharded_decode_step(M.make_mesh(MeshConfig(), devices=devs[:1]),
                                     dcfg.acoustic_scale)
    r4, tot4 = step4(gmm_rep, *M.shard_batch((fb.feats, fb.n_frames), mesh),
                     M.shard_batch(dict(graphs_np), mesh))
    r1, tot1 = step1(gmm, fb.feats, fb.n_frames,
                     {k: jnp.asarray(v) for k, v in graphs_np.items()})
    jax.block_until_ready((r4, r1))
    check(np.array_equal(np.asarray(r4.path), np.asarray(r1.path)),
          "sharded decode paths differ from one card")
    print(f"  sharded decode step: paths identical, frames {int(tot4['frames'])}"
          f" == {int(tot1['frames'])}")

    # sharded EM statistics (on the decoded pdf labels) vs one card
    graphs1 = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    labels = vit.path_to_pdfs(r1, graphs1).reshape(-1)
    feats = fb.feats.reshape(-1, fb.feats.shape[-1])
    local = em.accumulate_stats(gmm, feats, labels)
    em4 = make_sharded_em_step(mesh)(gmm_rep, *M.shard_batch((feats, labels), mesh))
    worst = 0.0
    for name in ("occ", "sx", "sxx"):
        a, b = np.asarray(getattr(em4, name)), np.asarray(getattr(local, name))
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0))))
    print(f"  sharded EM stats: max relative difference {worst:.3g}")
    check(worst <= 1e-4, "sharded EM stats differ by more than 1e-4")


# ---------------------------------------------------------------- main


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-GPU data-parallel path")
    args = p.parse_args()

    try:
        from mogasr.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"FAIL: run chip_smoke.py from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"FAIL: chip_smoke.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"jax {jax.__version__}; devices {len(jax.devices())} x {dev.device_kind}")
    print(f"flax importable: {importable('flax')}; "
          f"orbax importable: {importable('orbax.checkpoint')}")

    import bench

    head = bench.load_headline()
    phases = ([("four cards", lambda: phase_four_cards(head))] if args.four_cards
              else [("1 scorer parity", lambda: phase_scorer(head)),
                    ("2 headline decode", lambda: phase_decode(head, card)),
                    ("3 EM training", phase_train),
                    ("4 serving", lambda: phase_serve(head))])
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"[phase {name}]", flush=True)
        try:
            fn()
        except SmokeFailure as e:
            print(f"FAIL [phase {name}]: {e}", file=sys.stderr)
            return 1
        print(f"[phase {name}] PASS in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
