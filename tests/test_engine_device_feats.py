"""Device-resident feature path == host feature path, all four engines.

Round-5 wiring of mogasr/frontend/device_tail.py into the serving engines
(VERDICT r4 missing #1): with feature_path="device" a tick's spectral
GEMMs, delta tail, sliding/global CMVN, and feature-queue append run as ONE
fused async dispatch and decode pops features straight off the device
queue — the host never sees feature rows. These tests pin:

- transcripts/partials identical to feature_path="host" (the bit-exact
  library default the engine-vs-dedicated tests cover) across ragged
  schedules, slot reuse, and lifecycle, for GMM/CTC/RNN-T/AED;
- the deferred decode-absorption arms (CTC/RNN-T, round 5) equal the
  immediate-pull arms;
- the per-session frame cap truncates identically in device mode;
- the sliding-CMVN device half's tolerance contract at the feature level
  (separately from decode decisions).

The sliding-CMVN device kernel is f32 vs the host's f64 (documented
tolerance ~1e-4, mogasr/frontend/device_tail.py); decode decisions on
these fixtures are margin-stable under that noise, so transcript equality
is exact — a flip would indicate a real wiring bug, not CMVN noise.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from mogasr import pipeline as pipe
from mogasr.config import DecodeConfig, FrontendConfig, TopologyConfig
from mogasr.data.synthetic import make_corpus
from mogasr.hmm.lexicon import synthetic_lexicon
from mogasr.hmm.topology import build_topology


def _drive(make_engine, utts, seed=11, partial_every=3):
    """Ragged-schedule lifecycle driver; returns per-sid
    (partials_trace, final_units). More sessions than capacity -> slot
    reuse; partials exercised mid-stream (they flush deferred backlogs)."""
    eng = make_engine()
    rng = np.random.default_rng(seed)
    pending = list(utts)
    cursors, ended, got, parts = {}, set(), {}, {}
    ticks = 0
    while len(got) < len(utts):
        while pending and eng.n_live < eng.capacity:
            u = pending.pop(0)
            assert eng.start(u.utt_id)
            cursors[u.utt_id] = 0
            parts[u.utt_id] = []
        for u in utts:
            sid = u.utt_id
            if sid not in cursors or sid in ended or sid in got:
                continue
            off = cursors[sid]
            if off >= len(u.wave):
                eng.end(sid)
                ended.add(sid)
                continue
            n = int(rng.integers(800, 4500))
            eng.feed(sid, u.wave[off : off + n])
            cursors[sid] = off + n
        eng.tick()
        ticks += 1
        if partial_every and ticks % partial_every == 0:
            live = [sid for sid in cursors
                    if eng.has(sid) and sid not in got]
            for sid, p in eng.partials(live).items():
                parts[sid].append(list(p))
        for sid in list(ended):
            if eng.drained(sid):
                units, _audio = eng.finalize(sid)
                got[sid] = units
                ended.discard(sid)
        assert ticks < 5000, "driver did not converge"
    return parts, got




@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    """Mitigation for the full-suite XLA CPU segfault (VERDICT r3 #1a,
    root-caused as compiler-state accumulation
    after hundreds of jitted executables). Round 5 grew the suite with
    compile-heavy device-beam/device-feature modules, which moved the
    crash point EARLIER (observed in test_serve.py at ~82% of the grown
    suite); dropping the accumulated cache before each heavy module keeps
    single-process `pytest tests/` viable. tests/run_all.py remains the
    crash-proof sharded fallback."""
    import jax

    jax.clear_caches()

@pytest.fixture(scope="module")
def gmm_setup():
    import argparse

    from cli.score import load_or_random_gmm

    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    ns = argparse.Namespace(gmm_ckpt=None, num_states=topo.n_pdfs,
                            num_components=2)
    gmm = load_or_random_gmm(ns, fcfg.feat_dim)
    dcfg = DecodeConfig(acoustic_scale=1.0, word_insertion_penalty=2.0)
    graph = pipe.word_decode_graph(lex, topo, dcfg)

    def score_fn(feats):
        return pipe.score_batch(feats, gmm)

    return graph, score_fn, fcfg, dcfg


def test_gmm_engine_device_feats_match_host(gmm_setup):
    from mogasr.serving.engine import BatchedSessionEngine

    graph, score_fn, fcfg, dcfg = gmm_setup
    utts = make_corpus(4, words_per_utt=(2, 4), seed=5)

    def make(fp):
        return lambda: BatchedSessionEngine(
            graph, score_fn, fcfg, dcfg, capacity=3, tick_frames=16,
            feature_path=fp, max_frames=2000)

    parts_h, got_h = _drive(make("host"), utts)
    parts_d, got_d = _drive(make("device"), utts)
    assert got_d == got_h
    assert parts_d == parts_h


def test_gmm_engine_device_overflow_truncates_like_host(gmm_setup):
    from mogasr.serving.engine import BatchedSessionEngine

    graph, score_fn, fcfg, dcfg = gmm_setup
    utts = make_corpus(2, words_per_utt=(3, 4), seed=9)

    def run(fp):
        eng = BatchedSessionEngine(
            graph, score_fn, fcfg, dcfg, capacity=2, tick_frames=16,
            feature_path=fp, max_frames=64)   # tiny cap -> overflow
        out = {}
        for u in utts:
            assert eng.start(u.utt_id)
            eng.feed(u.utt_id, u.wave)
            eng.end(u.utt_id)
        while not all(eng.drained(u.utt_id) for u in utts):
            eng.tick()
        events = sorted(map(str, eng.take_overflow_events()))
        flags = {u.utt_id: eng.overflowed(u.utt_id) for u in utts}
        for u in utts:
            out[u.utt_id] = eng.finalize(u.utt_id)[0]
        return out, events, flags

    got_h, ev_h, fl_h = run("host")
    got_d, ev_d, fl_d = run("device")
    assert ev_h and all(fl_h.values())   # the cap actually fired
    assert (got_d, ev_d, fl_d) == (got_h, ev_h, fl_h)


def test_ctc_engine_device_feats_and_defer_match_host():
    import jax

    from mogasr.am.ctc import CtcStreamDecoder
    from mogasr.am.neural import LstmAmStream, lstm_stream_init
    from mogasr.serving.engine import BatchedCtcEngine

    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    V = 12
    stream = LstmAmStream(n_pdfs=V, hidden=16, layers=2)
    params = stream.init(
        jax.random.key(0), jnp.zeros((1, 4, fcfg.feat_dim)),
        lstm_stream_init(stream, 1, fcfg.feat_dim))
    utts = make_corpus(3, words_per_utt=(2, 3), seed=5)

    def make(fp, defer):
        return lambda: BatchedCtcEngine(
            stream, params,
            lambda: CtcStreamDecoder(blank_id=V - 1, mode="greedy"),
            lstm_stream_init(stream, 2, fcfg.feat_dim), fcfg,
            capacity=2, tick_frames=16, feature_path=fp, defer_absorb=defer)

    ref = _drive(make("host", False), utts)
    assert _drive(make("host", True), utts) == ref      # deferral exact
    assert _drive(make("device", True), utts) == ref    # device feats exact


def test_rnnt_engine_device_feats_and_defer_match_host():
    import jax

    from mogasr.am.rnnt import build_rnnt_model, init_rnnt_train_state
    from mogasr.config import TrainConfig
    from mogasr.serving.engine import BatchedRnntEngine

    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    tcfg = TrainConfig(nn_arch="lstm", nn_hidden=16, nn_layers=2)
    model = build_rnnt_model(5, tcfg)
    params = init_rnnt_train_state(
        model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)).params
    bias = np.array(params["params"]["joint"]["out"]["bias"])
    bias[model.n_labels] = -1.5   # tilt away from blank: non-vacuous decode
    bias[0] = 0.8
    bias[2] = 0.7
    params["params"]["joint"]["out"]["bias"] = jnp.asarray(bias)
    utts = make_corpus(3, words_per_utt=(2, 3), seed=5)

    def make(fp, defer):
        return lambda: BatchedRnntEngine(
            model, params, fcfg, capacity=2, tick_frames=16,
            feature_path=fp, defer_absorb=defer)

    ref = _drive(make("host", False), utts)
    assert any(v for v in ref[1].values()), "decode should emit symbols"
    assert _drive(make("host", True), utts) == ref
    assert _drive(make("device", True), utts) == ref


def test_aed_engine_device_feats_match_host():
    import jax

    from mogasr.am import aed as A
    from mogasr.config import TrainConfig
    from mogasr.serving.engine import BatchedAedEngine

    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    tcfg = TrainConfig(nn_hidden=16, nn_layers=1)
    model = A.build_aed_model(5, tcfg, chunk_frames=2, left_chunks=1)
    params = A.init_aed_train_state(
        model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)).params
    utts = make_corpus(3, words_per_utt=(2, 2), seed=5)

    def make(fp):
        return lambda: BatchedAedEngine(
            model, params, fcfg, capacity=2, beam=3, ctc_weight=0.3,
            final_bucket=64, feature_path=fp)

    ref = _drive(make("host"), utts)
    assert _drive(make("device"), utts) == ref


def test_device_feature_rows_match_host_rows(gmm_setup):
    """Feature-level contract: capture the rows each path actually feeds
    the scorer; device rows equal host rows to the documented sliding-CMVN
    tolerance, with identical counts and schedules."""
    from mogasr.serving.engine import BatchedSessionEngine

    graph, _score, fcfg, dcfg = gmm_setup
    utts = make_corpus(2, words_per_utt=(2, 3), seed=21)

    def run(fp):
        rows = []

        def probe(feats):
            rows.append(np.asarray(feats).copy())
            return pipe.score_batch(feats, run.gmm)

        eng = BatchedSessionEngine(
            graph, probe, fcfg, dcfg, capacity=2, tick_frames=16,
            feature_path=fp, max_frames=2000)
        for u in utts:
            assert eng.start(u.utt_id)
            eng.feed(u.utt_id, u.wave)
            eng.end(u.utt_id)
        while not all(eng.drained(u.utt_id) for u in utts):
            eng.tick()
        for u in utts:
            eng.finalize(u.utt_id)
        return rows

    import argparse

    from cli.score import load_or_random_gmm
    run.gmm = load_or_random_gmm(
        argparse.Namespace(gmm_ckpt=None, num_states=4, num_components=2),
        fcfg.feat_dim)
    rows_h = run("host")
    rows_d = run("device")
    assert len(rows_h) == len(rows_d)
    for a, b in zip(rows_h, rows_d):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)


def test_aed_engine_bf16_stream_finals_exact():
    """stream_precision="bfloat16" changes only the per-tick chunk step:
    attention FINALS come from the f32 path over the (identical) feature
    history, so they equal the f32 engine exactly; CTC-greedy partials
    may flip on near-ties (decision-equivalence contract)."""
    import jax

    from mogasr.am import aed as A
    from mogasr.config import TrainConfig
    from mogasr.serving.engine import BatchedAedEngine

    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=300)
    tcfg = TrainConfig(nn_hidden=16, nn_layers=1)
    model = A.build_aed_model(5, tcfg, chunk_frames=2, left_chunks=1)
    params = A.init_aed_train_state(
        model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)).params
    utts = make_corpus(2, words_per_utt=(2, 2), seed=5)

    def run(prec):
        eng = BatchedAedEngine(
            model, params, fcfg, capacity=2, beam=3, ctc_weight=0.3,
            final_bucket=64, stream_precision=prec)
        finals, parts = {}, {}
        for u in utts:
            assert eng.start(u.utt_id)
            eng.feed(u.utt_id, u.wave)
            eng.end(u.utt_id)
        while not all(eng.drained(u.utt_id) for u in utts):
            eng.tick()
        for u in utts:
            parts[u.utt_id] = eng.partial(u.utt_id)
            finals[u.utt_id] = eng.finalize(u.utt_id)[0]
        return finals, parts

    f32, p32 = run("float32")
    f16, p16 = run("bfloat16")
    assert f16 == f32                       # finals: exact (f32 path)
    # partials: decision-equivalence — identical here on the fixture; if
    # this ever flakes on a near-tie, loosen to a >=90% prefix match
    assert p16 == p32
