"""Streaming recognition SERVER loop: many concurrent sessions over a
line-delimited JSON protocol.

The session-manager shape of a production streaming service. Two
transports carry the SAME event stream: stdin/stdout (default — hermetic
and testable), and ``--tcp PORT`` (a selectors-based localhost socket
server: many concurrent client connections, responses routed to the
connection whose event produced them, per-connection session ownership,
dropped clients reaped). One process holds
ONE compiled decoder (graph + jitted Viterbi step); every session carries
only its own small state (StreamingFrontend window + OnlineDecoder
carries), so sessions are cheap and independent.

Requests (one JSON object per line on stdin):
  {"type": "start", "session": ID}
  {"type": "audio", "session": ID, "pcm": [float, ...]}   16 kHz mono
  {"type": "end",   "session": ID}
  {"type": "shutdown"}
Responses (one JSON object per line on stdout):
  {"session": ID, "event": "ready"}
  {"session": ID, "partial": [words], "t_audio_s": S}     after each audio
  {"session": ID, "final": [words], "audio_s": S}         after end
  {"session": ID, "error": MSG}

    python cli/serve.py --synthetic-demo-session   # self-test: one session
    cat events.jsonl | python cli/serve.py
"""

from __future__ import annotations

import argparse
import io
import json
import sys

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

from cli.common import add_run_args, make_logger
from cli.score import load_or_random_gmm
from mogasr.config import DecodeConfig, FrontendConfig, TopologyConfig
from mogasr.hmm.lexicon import load_lexicon, synthetic_lexicon
from mogasr.hmm.topology import build_topology


class _Session:
    def __init__(self, frontend, decoder):
        self.frontend = frontend
        self.decoder = decoder
        self.samples = 0


def _read_batches(stream):
    """Yield batches of input lines: one blocking readline, then greedily
    drain whatever is already buffered (select() on real files; test
    StringIO streams just go line-at-a-time). Batching lets the engine
    advance MANY sessions per tick instead of ticking per event."""
    import select

    while True:
        line = stream.readline()
        if not line:
            return
        lines = [line]
        try:
            fd = stream.fileno()
            while select.select([fd], [], [], 0)[0]:
                more = stream.readline()
                if not more:
                    break
                lines.append(more)
        except (OSError, ValueError, AttributeError, io.UnsupportedOperation):
            pass
        yield lines


def _make_endpointer(args, fcfg):
    """Fresh per-session endpoint detector, or None when --endpoint is off."""
    if not getattr(args, "endpoint", False):
        return None
    from mogasr.frontend.endpoint import EndpointConfig, StreamingEndpointer

    return StreamingEndpointer(fcfg, EndpointConfig(
        rule1_trailing_sil_s=args.endpoint_trailing_sil,
        rule3_max_utt_s=args.endpoint_max_utt,
    ))


def _run_engine_loop(args, eng, fcfg, logger, batches=None, to_text=None):
    """Batched-engine server: apply a batch of events, ONE tick for all
    sessions, emit partials for sessions that got audio, drain endings.
    to_text maps an engine hypothesis (words or unit ids) to output words.
    With --endpoint, a causal per-session detector ends the session itself
    (the final event then carries the firing rule)."""
    import numpy as np

    if to_text is None:
        to_text = lambda toks: toks

    def emit(obj):
        print(json.dumps(obj), flush=True)

    def emit_overflows():
        # A session that hit the engine's per-session frame cap keeps its
        # slot (finalizable, hypothesis truncated at the cap) but the
        # client must hear that further audio is being dropped.
        for sid in getattr(eng, "take_overflow_events", list)():
            emit({"session": sid, "error": "session exceeded the engine "
                  "frame cap; hypothesis truncated — end the session"})

    endpointers: dict = {}   # sid -> StreamingEndpointer
    ep_rule: dict = {}       # sid -> rule name once fired

    if batches is None:
        if args.synthetic_demo_session:
            from mogasr.data.synthetic import make_corpus

            utt = make_corpus(1, words_per_utt=(2, 3), seed=7)[0]
            chunk = fcfg.sample_rate // 4
            evs = [{"type": "start", "session": "demo"}]
            evs += [
                {"type": "audio", "session": "demo",
                 "pcm": utt.wave[i : i + chunk].tolist()}
                for i in range(0, len(utt.wave), chunk)
            ]
            evs.append({"type": "end", "session": "demo"})
            batches = ([json.dumps(e)] for e in evs)
        else:
            batches = _read_batches(sys.stdin)

    partial_every = max(int(getattr(args, "partial_every", 1)), 1)
    tick_i = 0
    for lines in batches:
        fed = []
        ending = []
        shutdown = False
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                emit({"error": f"bad json: {e}"})
                continue
            typ = ev.get("type")
            if typ == "shutdown":
                shutdown = True
                break
            sid = ev.get("session")
            if sid is None:
                emit({"error": "missing session id"})
            elif typ == "start":
                if eng.has(sid):
                    emit({"session": sid, "error": "session exists"})
                elif not eng.start(sid):
                    emit({"session": sid, "error": "too many sessions"})
                else:
                    ep = _make_endpointer(args, fcfg)
                    if ep is not None:
                        endpointers[sid] = ep
                    emit({"session": sid, "event": "ready"})
            elif typ == "audio":
                if not eng.has(sid):
                    emit({"session": sid, "error": "no such session"})
                elif sid in ep_rule:
                    emit({"session": sid, "error": "endpointed"})
                elif sid in ending:
                    # ended earlier in this very batch — engine.feed would
                    # raise and kill every other session with it
                    emit({"session": sid, "error": "session ended"})
                else:
                    pcm = np.asarray(ev.get("pcm", []), np.float32)
                    eng.feed(sid, pcm)
                    fed.append(sid)
                    ep = endpointers.get(sid)
                    if ep is not None:
                        ep.feed(pcm)
                        if ep.endpointed:
                            ep_rule[sid] = ep.rule
                            eng.end(sid)
                            ending.append(sid)
                            emit({"session": sid, "event": "endpoint",
                                  "rule": ep.rule})
            elif typ == "end":
                if not eng.has(sid):
                    emit({"session": sid, "error": "no such session"})
                elif sid in ep_rule:
                    emit({"session": sid, "error": "endpointed"})
                elif sid in ending:
                    emit({"session": sid, "error": "session ended"})
                else:
                    eng.end(sid)
                    ending.append(sid)
            else:
                emit({"session": sid, "error": f"unknown type {typ!r}"})
        eng.tick()
        tick_i += 1
        emit_overflows()
        if fed and tick_i % partial_every == 0:
            # de-dup, keep order; skip any ended in the same batch
            sids = [s for s in dict.fromkeys(fed) if eng.has(s)]
            parts = eng.partials(sids)
            for sid in sids:
                emit({
                    "session": sid,
                    "partial": to_text(parts[sid]),
                    "t_audio_s": round(eng.audio_seconds(sid), 2),
                })
        while ending:
            for sid in list(ending):
                if eng.drained(sid):
                    audio_s = eng.audio_seconds(sid)
                    words, _ = eng.finalize(sid)
                    words = to_text(words)
                    final_ev = {"session": sid, "final": words,
                                "audio_s": round(audio_s, 2)}
                    rule = ep_rule.pop(sid, None)
                    endpointers.pop(sid, None)
                    if rule is not None:
                        final_ev["endpoint"] = rule
                    emit(final_ev)
                    logger.log({"stage": "serve_final", "session": sid,
                                "audio_s": round(audio_s, 2), "words": words})
                    ending.remove(sid)
            if ending:
                eng.tick()
                emit_overflows()
        if shutdown:
            return


def main() -> None:
    import jax.numpy as jnp

    from mogasr.decoder.online import OnlineDecoder
    from mogasr.frontend.streaming import StreamingFrontend
    from mogasr.hmm import graph as gr
    from mogasr.pipeline import score_batch, word_decode_graph

    p = argparse.ArgumentParser(description=__doc__)
    add_run_args(p)
    p.add_argument("--lexicon", help="Kaldi-style lexicon.txt (default: synthetic)")
    p.add_argument("--gmm-ckpt", help="orbax GMM checkpoint dir")
    p.add_argument("--num-states", type=int, default=0)
    p.add_argument("--num-components", type=int, default=8)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--insertion-penalty", type=float, default=2.0)
    p.add_argument("--cmvn-window", type=int, default=600)
    p.add_argument("--max-sessions", type=int, default=64,
                   help="reject starts beyond this many live sessions")
    p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                   help="serve the SAME line-JSON protocol over a TCP "
                        "socket (127.0.0.1:PORT, 0 = ephemeral) instead of "
                        "stdin/stdout: many concurrent client connections, "
                        "responses routed to the connection whose event "
                        "produced them, sessions owned per-connection "
                        "(a dropped client's sessions are reaped); "
                        "{\"type\": \"shutdown\"} stops the server")
    p.add_argument("--port-file", metavar="FILE",
                   help="with --tcp: write the bound port number to FILE "
                        "once listening (for --tcp 0 ephemeral ports)")
    p.add_argument("--engine", action="store_true",
                   help="batched session engine (GMM/hybrid, --ctc, --rnnt, "
                        "and --aed families): ONE device dispatch chain per "
                        "tick advances ALL live sessions instead of "
                        "per-session batch-1 dispatches — the batched "
                        "serving mode (mogasr.serving.engine)")
    p.add_argument("--engine-capacity", type=int, default=16,
                   help="engine slot count (= max concurrent sessions)")
    p.add_argument("--aed-stream-precision",
                   choices=["float32", "bfloat16"], default="float32",
                   help="AED engine chunk-step precision (bf16 matmuls for the "
                        "encoder-compute-bound tick; finals stay f32 exact)")
    p.add_argument("--feature-path", choices=["device", "host"],
                   default="device",
                   help="engine feature extraction: 'device' (production) "
                        "fuses spectral+delta+CMVN+queue into one async "
                        "dispatch per tick so features never visit the "
                        "host; 'host' is the bit-exact per-slot "
                        "StreamingFrontend path (sliding CMVN on device "
                        "is an f32 tolerance contract, "
                        "mogasr/frontend/device_tail.py)")
    p.add_argument("--engine-history", choices=["device", "host"],
                   default="device",
                   help="GMM engine backpointer history: device-resident "
                        "(bounded sessions, no per-tick host pull) or host "
                        "chunk lists (unbounded sessions)")
    p.add_argument("--engine-max-frames", type=int, default=3000,
                   help="session length bound with --engine-history device "
                        "(frames; 3000 = 30 s at the 10 ms hop)")
    p.add_argument("--partial-every", type=int, default=1,
                   help="engine mode: emit partials every N ticks (N>1 "
                        "lets the AED engine's deferred logp absorption "
                        "amortize its device sync across N ticks — the "
                        "round-4 capacity-realtime lever; finals and "
                        "endpoints are unaffected)")
    p.add_argument("--tick-frames", type=int, default=24,
                   help="frames advanced per session per engine tick")
    p.add_argument("--ctc", action="store_true",
                   help="serve a BPE-CTC neural model instead of the GMM: "
                        "stateful LSTM chunks -> streaming prefix/greedy "
                        "decode -> words (requires --nn-ckpt and --bpe)")
    p.add_argument("--nn-ckpt", help="CTC checkpoint dir (with --ctc)")
    p.add_argument("--bpe", metavar="FILE", help="bpe.json (with --ctc)")
    p.add_argument("--nn-hidden", type=int, default=512)
    p.add_argument("--nn-layers", type=int, default=3)
    p.add_argument("--bias", metavar="FILE",
                   help="with --ctc: contextual phrase biasing (streaming "
                        "prefix beam; one phrase per line)")
    p.add_argument("--bias-weight", type=float, default=2.0)
    p.add_argument("--bias-beam", type=int, default=8)
    p.add_argument("--fusion-lm", metavar="FILE",
                   help="with --ctc: unit-bigram shallow fusion in the "
                        "streaming prefix beam (train_lm --unit-ngram); "
                        "composes with --bias")
    p.add_argument("--fusion-weight", type=float, default=0.5)
    p.add_argument("--rnnt", action="store_true",
                   help="serve a streaming RNN-T (train_nn --objective rnnt): "
                        "stateful LSTM encoder chunks -> on-device greedy "
                        "(requires --nn-ckpt; phone output, or words with "
                        "--bpe)")
    p.add_argument("--rnnt-pred", default="stateless",
                   choices=["stateless", "lstm"],
                   help="prediction-network architecture the checkpoint was "
                        "trained with")
    p.add_argument("--rnnt-plain", action="store_true",
                   help="checkpoint trained WITHOUT the auxiliary CTC head")
    p.add_argument("--rnnt-pruned", action="store_true",
                   help="ckpt trained with the pruned transducer loss "
                        "(train_nn --rnnt-pruned-band): tree has the "
                        "factored simple_am/simple_lm heads")
    p.add_argument("--max-symbols", type=int, default=400,
                   help="with --rnnt (per-session mode): hypothesis-buffer "
                        "cap per session; the --engine mode harvests every "
                        "tick and has no session-length cap")
    p.add_argument("--aed", action="store_true",
                   help="serve a chunked streaming AED (train_nn --objective "
                        "aed --aed-chunk): CTC-greedy partials per chunk, "
                        "exact attention-beam final (requires --nn-ckpt; "
                        "phone output, or words with --bpe)")
    p.add_argument("--aed-chunk", type=int, default=8)
    p.add_argument("--aed-left-chunks", type=int, default=1)
    p.add_argument("--aed-beam", type=int, default=4)
    p.add_argument("--aed-ctc-weight", type=float, default=0.3)
    p.add_argument("--endpoint", action="store_true",
                   help="server-side endpointing (frontend/endpoint.py): a "
                        "causal per-session detector ends the utterance "
                        "itself — the server emits an 'endpoint' event and "
                        "the final (with the firing rule) without waiting "
                        "for a client 'end'")
    p.add_argument("--endpoint-trailing-sil", type=float, default=0.5,
                   help="rule-1 trailing silence (seconds)")
    p.add_argument("--endpoint-max-utt", type=float, default=20.0,
                   help="rule-3 hard utterance cap (seconds)")
    p.add_argument("--synthetic-demo-session", action="store_true",
                   help="self-test: synthesize one utterance and drive a "
                        "session through the protocol instead of stdin")
    args = p.parse_args()
    if args.tcp is not None and args.engine:
        # the batched engine runs its own tick loop over stdin batches;
        # silently ignoring --tcp would strand socket clients
        raise SystemExit("--tcp serves the per-session mode only "
                         "(--engine has its own stdin tick loop)")

    fcfg = FrontendConfig(cmvn="sliding", cmvn_window=args.cmvn_window)
    lex = load_lexicon(args.lexicon) if args.lexicon else synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    if args.num_states == 0:
        args.num_states = topo.n_pdfs
    dcfg = DecodeConfig(
        acoustic_scale=args.acoustic_scale,
        word_insertion_penalty=args.insertion_penalty,
    )
    logger = make_logger(args)
    if sum((args.aed, args.ctc, args.rnnt)) > 1:
        raise SystemExit("--aed/--ctc/--rnnt are different serving models")
    if args.aed:
        import jax

        from mogasr.am import aed as A
        from mogasr.am.ctc import CtcStreamDecoder
        from mogasr.config import TrainConfig
        from mogasr.utils.checkpoint import restore_checkpoint

        if not args.nn_ckpt:
            raise SystemExit("--aed requires --nn-ckpt")
        if args.bpe:
            from mogasr.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
            n_units = bpe.n_units
        else:
            bpe = None
            n_units = lex.n_phones
        tcfg = TrainConfig(nn_hidden=args.nn_hidden, nn_layers=args.nn_layers)
        aed_model = A.build_aed_model(
            n_units, tcfg, chunk_frames=args.aed_chunk,
            left_chunks=args.aed_left_chunks,
        )
        template = {
            "params": A.init_aed_train_state(
                aed_model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)
            ).params,
        }
        aed_params = restore_checkpoint(args.nn_ckpt, template)["params"]

        def to_text(units):
            return bpe.decode(units) if bpe else [lex.phones[u] for u in units]

        if args.engine:
            from mogasr.serving.engine import BatchedAedEngine

            eng = BatchedAedEngine(
                aed_model, aed_params, fcfg,
                capacity=args.engine_capacity,
                beam=args.aed_beam, ctc_weight=args.aed_ctc_weight,
                feature_path=args.feature_path,
                stream_precision=args.aed_stream_precision,
            )
            _run_engine_loop(args, eng, fcfg, logger, to_text=to_text)
            return

        aed_step = A.make_aed_stream_step(aed_model, aed_params)
        raw_per = 4 * args.aed_chunk

        def make_session():
            s = _Session(
                StreamingFrontend(fcfg),
                CtcStreamDecoder(blank_id=n_units, mode="greedy"),
            )
            s.enc_state = A.aed_stream_init(aed_model, 1, fcfg.feat_dim)
            s.buf = np.zeros((0, fcfg.feat_dim), np.float32)
            s.all_feats = []
            return s

        def feed(s, feats):
            s.all_feats.append(feats)
            s.buf = np.concatenate([s.buf, feats], axis=0)
            while s.buf.shape[0] >= raw_per:
                _e, ctc_logits, s.enc_state = aed_step(
                    jnp.asarray(s.buf[None, :raw_per]), s.enc_state
                )
                s.decoder.step(np.asarray(
                    jax.nn.log_softmax(ctc_logits[0], axis=-1)
                ))
                s.buf = s.buf[raw_per:]

        def partial_words(s):
            return to_text(s.decoder.partial())

        def final_words(s):
            # exact attention finalization over the full utterance (the
            # chunk-masked offline encoder equals the streamed prefix);
            # length-bucketed padding + the shared token-cap convention keep
            # jit variants bounded and match the batched engine's finals
            from mogasr.serving.engine import aed_final_max_tokens

            fa = (np.concatenate(s.all_feats, axis=0)
                  if s.all_feats else s.buf)
            T = fa.shape[0]
            if T == 0:
                return []
            bucket = 256
            Tb = -(-T // bucket) * bucket
            padded = np.zeros((1, Tb, fa.shape[1]), np.float32)
            padded[0, :T] = fa
            seqs = A.aed_decode_batch(
                aed_model, aed_params, jnp.asarray(padded),
                jnp.asarray([T], np.int32),
                beam=args.aed_beam,
                max_tokens=aed_final_max_tokens(Tb),
                ctc_weight=args.aed_ctc_weight,
            )
            return to_text(seqs[0])
    elif args.ctc:
        import jax

        from mogasr.am.ctc import CtcStreamDecoder
        from mogasr.am.neural import LstmAm, LstmAmStream, lstm_stream_init
        from mogasr.am.train_nn import init_train_state
        from mogasr.config import TrainConfig
        from mogasr.data.bpe import load_bpe
        from mogasr.utils.checkpoint import restore_checkpoint

        if not (args.nn_ckpt and args.bpe):
            raise SystemExit("--ctc requires --nn-ckpt and --bpe")
        bpe = load_bpe(args.bpe)
        V = bpe.n_units + 1
        tcfg = TrainConfig(nn_arch="lstm", nn_hidden=args.nn_hidden,
                           nn_layers=args.nn_layers)
        nn_model = LstmAm(n_pdfs=V, hidden=args.nn_hidden,
                          layers=max(args.nn_layers - 1, 1))
        template = {
            "params": init_train_state(nn_model, tcfg, fcfg.feat_dim,
                                       jax.random.key(0)).params,
        }
        nn_params = restore_checkpoint(args.nn_ckpt, template)["params"]
        stream_model = LstmAmStream(
            n_pdfs=V, hidden=args.nn_hidden, layers=max(args.nn_layers - 1, 1)
        )

        @jax.jit
        def score_chunk(carries, feats):
            logits, new_carries = stream_model.apply(nn_params, feats, carries)
            return jax.nn.log_softmax(logits, axis=-1), new_carries

        ext = None
        if args.bias or args.fusion_lm:
            from mogasr.lm.unit_ngram import compose_ext_scores

            exts = []
            if args.bias:
                from mogasr.decoder.biasing import (
                    biaser_from_bpe, load_phrases,
                )

                exts.append(biaser_from_bpe(
                    bpe, load_phrases(args.bias), weight=args.bias_weight
                ).score)
            if args.fusion_lm:
                from mogasr.lm.unit_ngram import fusion_score, load_unit_lm

                exts.append(fusion_score(
                    load_unit_lm(args.fusion_lm), args.fusion_weight
                ))
            ext = compose_ext_scores(exts)

        def new_decoder():
            if ext is not None:
                return CtcStreamDecoder(
                    blank_id=V - 1, mode="beam", beam_size=args.bias_beam,
                    ext_score=ext,
                )
            return CtcStreamDecoder(blank_id=V - 1, mode="greedy")

        if args.engine:
            from mogasr.serving.engine import BatchedCtcEngine

            eng = BatchedCtcEngine(
                stream_model, nn_params, new_decoder,
                lstm_stream_init(nn_model, args.engine_capacity,
                                 fcfg.feat_dim),
                fcfg, capacity=args.engine_capacity,
                tick_frames=args.tick_frames,
                feature_path=args.feature_path,
            )
            _run_engine_loop(args, eng, fcfg, logger, to_text=bpe.decode)
            return

        def make_session():
            s = _Session(StreamingFrontend(fcfg), new_decoder())
            s.carries = lstm_stream_init(nn_model, 1, fcfg.feat_dim)
            return s

        def feed(s, feats):
            lp, s.carries = score_chunk(s.carries, jnp.asarray(feats[None]))
            s.decoder.step(np.asarray(lp[0]))

        def partial_words(s):
            return bpe.decode(s.decoder.partial())

        def final_words(s):
            return bpe.decode(s.decoder.finalize())
    elif args.rnnt:
        import jax

        from mogasr.am.rnnt import (
            RnntDeviceStream,
            build_rnnt_model,
            init_rnnt_train_state,
            make_rnnt_stream_shared,
        )
        from mogasr.config import TrainConfig
        from mogasr.utils.checkpoint import restore_checkpoint

        if not args.nn_ckpt:
            raise SystemExit("--rnnt requires --nn-ckpt (train_nn "
                             "--objective rnnt)")
        if args.bpe:
            from mogasr.data.bpe import load_bpe

            bpe = load_bpe(args.bpe)
            n_units = bpe.n_units
        else:
            bpe = None
            n_units = lex.n_phones
        tcfg = TrainConfig(nn_arch="lstm", nn_hidden=args.nn_hidden,
                           nn_layers=args.nn_layers)
        rnnt_model = build_rnnt_model(
            n_units, tcfg,
            pred_arch=args.rnnt_pred, aux_ctc=not args.rnnt_plain,
            simple_heads=args.rnnt_pruned,
        )
        template = {
            "params": init_rnnt_train_state(
                rnnt_model, tcfg, fcfg.feat_dim, 4, jax.random.key(0)
            ).params,
        }
        rnnt_params = restore_checkpoint(args.nn_ckpt, template)["params"]

        def to_text(units):
            return bpe.decode(units) if bpe else [lex.phones[u] for u in units]

        if args.engine:
            from mogasr.serving.engine import BatchedRnntEngine

            eng = BatchedRnntEngine(
                rnnt_model, rnnt_params, fcfg,
                capacity=args.engine_capacity,
                tick_frames=args.tick_frames,
                feature_path=args.feature_path,
            )
            _run_engine_loop(args, eng, fcfg, logger, to_text=to_text)
            return

        # per-session mode: every session gets its own batch-1 stream, all
        # sharing ONE set of jitted fns (no per-session recompiles)
        shared = make_rnnt_stream_shared(
            rnnt_model, rnnt_params, fcfg.feat_dim, u_cap=args.max_symbols
        )

        def make_session():
            s = _Session(StreamingFrontend(fcfg), None)
            s.stream = RnntDeviceStream(
                rnnt_model, rnnt_params, 1, fcfg.feat_dim,
                u_cap=args.max_symbols, shared=shared,
            )
            s.part = []
            return s

        def feed(s, feats):
            s.part = s.stream.consume(
                jnp.asarray(feats[None]), np.asarray([feats.shape[0]])
            )

        def partial_words(s):
            return to_text(s.part[0]) if s.part else []

        def final_words(s):
            return to_text(s.part[0]) if s.part else []
    elif args.engine:
        from mogasr.serving.engine import BatchedSessionEngine

        gmm = load_or_random_gmm(args, fcfg.feat_dim)
        graph = word_decode_graph(lex, topo, dcfg)
        eng = BatchedSessionEngine(
            graph, lambda feats: score_batch(feats, gmm), fcfg, dcfg,
            capacity=args.engine_capacity, tick_frames=args.tick_frames,
            history=args.engine_history,
            max_frames=args.engine_max_frames,
            feature_path=args.feature_path,
        )
        _run_engine_loop(args, eng, fcfg, logger)
        return
    else:
        gmm = load_or_random_gmm(args, fcfg.feat_dim)
        graph = word_decode_graph(lex, topo, dcfg)
        graphs = {
            k: jnp.asarray(v) for k, v in gr.batch_graphs([graph]).items()
        }

        def words_of(path, entered):
            from mogasr.hmm.graph import path_words

            return path_words(graph, path[0], entered[0])

        def make_session():
            return _Session(
                StreamingFrontend(fcfg),
                OnlineDecoder(graphs, acoustic_scale=dcfg.acoustic_scale),
            )

        def feed(s, feats):
            s.decoder.process(
                score_batch(jnp.asarray(feats[None]), gmm),
                np.asarray([feats.shape[0]]),
            )

        def partial_words(s):
            path, entered, _sc = s.decoder.partial()
            return words_of(path, entered)

        def final_words(s):
            path, entered, _sc = s.decoder.finalize()
            return words_of(path, entered)

    sessions: dict = {}

    # response routing: stdin mode writes stdout; --tcp mode points this at
    # the connection whose event is being handled (finish()/endpoint events
    # always fire inside that connection's handle(), so routing is complete)
    _out = {"fn": lambda obj: print(json.dumps(obj), flush=True)}

    def emit(obj):
        _out["fn"](obj)

    def finish(sid, s, rule=None):
        feats = s.frontend.finalize()
        if feats.size:
            feed(s, feats)
        audio_s = s.samples / fcfg.sample_rate
        final = final_words(s)
        final_ev = {"session": sid, "final": final,
                    "audio_s": round(audio_s, 2)}
        if rule is not None:
            final_ev["endpoint"] = rule
        emit(final_ev)
        logger.log({"stage": "serve_final", "session": sid,
                    "audio_s": round(audio_s, 2), "words": final})

    def handle(ev) -> bool:
        """Process one event; returns False on shutdown."""
        typ = ev.get("type")
        if typ == "shutdown":
            return False
        sid = ev.get("session")
        if sid is None:
            emit({"error": "missing session id"})
            return True
        if typ == "start":
            if sid in sessions:
                emit({"session": sid, "error": "session exists"})
            elif len(sessions) >= args.max_sessions:
                emit({"session": sid, "error": "too many sessions"})
            else:
                sessions[sid] = make_session()
                sessions[sid].ep = _make_endpointer(args, fcfg)
                emit({"session": sid, "event": "ready"})
        elif typ == "audio":
            s = sessions.get(sid)
            if s is None:
                emit({"session": sid, "error": "no such session"})
                return True
            pcm = np.asarray(ev.get("pcm", []), np.float32)
            s.samples += len(pcm)
            feats = s.frontend.process(pcm)
            if feats.size:
                feed(s, feats)
            if s.ep is not None:
                s.ep.feed(pcm)
                if s.ep.endpointed:
                    emit({"session": sid, "event": "endpoint",
                          "rule": s.ep.rule})
                    finish(sid, s, rule=s.ep.rule)
                    del sessions[sid]
                    return True
            emit({
                "session": sid,
                "partial": partial_words(s),
                "t_audio_s": round(s.samples / fcfg.sample_rate, 2),
            })
        elif typ == "end":
            s = sessions.pop(sid, None)
            if s is None:
                emit({"session": sid, "error": "no such session"})
                return True
            finish(sid, s)
        else:
            emit({"session": sid, "error": f"unknown type {typ!r}"})
        return True

    if args.synthetic_demo_session:
        from mogasr.data.synthetic import make_corpus

        utt = make_corpus(1, words_per_utt=(2, 3), seed=7)[0]
        chunk = fcfg.sample_rate // 4
        handle({"type": "start", "session": "demo"})
        for i in range(0, len(utt.wave), chunk):
            handle({"type": "audio", "session": "demo",
                    "pcm": utt.wave[i : i + chunk].tolist()})
        handle({"type": "end", "session": "demo"})
        return

    if args.tcp is not None:
        import selectors
        import socket

        sel = selectors.DefaultSelector()
        srv = socket.create_server(("127.0.0.1", args.tcp))
        srv.setblocking(False)
        sel.register(srv, selectors.EVENT_READ, data=None)
        port = srv.getsockname()[1]
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(port))
        print(json.dumps({"event": "listening", "port": port}), flush=True)
        logger.log({"stage": "serve_tcp_listening", "port": port})

        rbufs: dict = {}          # conn -> bytearray (inbound)
        wbufs: dict = {}          # conn -> bytearray (outbound, unflushed)
        owner: dict = {}          # session id -> conn
        MAX_WBUF = 16 << 20       # slow-consumer cap: drop past 16 MB queued

        def drop_conn(conn):
            """Reap a client: its sessions vanish without finals (the
            client is gone — there is nobody to deliver a final to).
            Idempotent — emits mid-handle may race the recv-EOF path."""
            if conn not in rbufs:
                return
            for sid in [s for s, c in owner.items() if c is conn]:
                sessions.pop(sid, None)
                owner.pop(sid, None)
            sel.unregister(conn)
            rbufs.pop(conn, None)
            wbufs.pop(conn, None)
            conn.close()

        def flush(conn) -> bool:
            """Write as much queued output as the socket accepts (non-
            blocking — a stalled client must NEVER stall the event loop).
            Returns False if the connection should be dropped."""
            buf = wbufs.get(conn)
            if buf is None:
                return False
            try:
                while buf:
                    n = conn.send(buf)
                    del buf[:n]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                return False
            if len(buf) > MAX_WBUF:
                return False  # client is not reading; protect the server
            events = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if buf else 0)
            sel.modify(conn, events, data="conn")
            return True

        def send_to(conn):
            def fn(obj):
                if conn not in wbufs:
                    return  # client already reaped mid-reply
                wbufs[conn] += (json.dumps(obj) + "\n").encode()
                if not flush(conn):
                    drop_conn(conn)
            return fn

        running = True
        while running:
            for key, mask in sel.select():
                if key.data is None:
                    conn, _addr = srv.accept()
                    conn.setblocking(False)
                    sel.register(conn, selectors.EVENT_READ, data="conn")
                    rbufs[conn] = bytearray()
                    wbufs[conn] = bytearray()
                    continue
                conn = key.fileobj
                if conn not in rbufs:
                    continue  # dropped earlier in this select batch
                if mask & selectors.EVENT_WRITE:
                    if not flush(conn):
                        drop_conn(conn)
                        continue
                if not (mask & selectors.EVENT_READ):
                    continue
                try:
                    data = conn.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if not data:
                    drop_conn(conn)
                    continue
                buf = rbufs[conn]
                buf += data
                _out["fn"] = send_to(conn)
                while b"\n" in buf:
                    raw, _, rest = bytes(buf).partition(b"\n")
                    buf[:] = rest
                    line = raw.decode(errors="replace").strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError as e:
                        emit({"error": f"bad json: {e}"})
                        continue
                    # per-connection session ownership: a session belongs
                    # to the connection that started it
                    sid = ev.get("session")
                    typ = ev.get("type")
                    if typ == "start" and sid is not None:
                        if sid in owner and owner[sid] is not conn:
                            emit({"session": sid,
                                  "error": "session owned by another "
                                           "connection"})
                            continue
                    elif sid is not None and sid in owner \
                            and owner[sid] is not conn:
                        emit({"session": sid,
                              "error": "session owned by another "
                                       "connection"})
                        continue
                    if not handle(ev):
                        running = False
                        break
                    if typ == "start" and sid in sessions:
                        owner[sid] = conn
                    elif sid is not None and sid not in sessions:
                        owner.pop(sid, None)
                if not running:
                    break
        for conn in list(rbufs):
            drop_conn(conn)
        srv.close()
        return

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError as e:
            emit({"error": f"bad json: {e}"})
            continue
        if not handle(ev):
            break


if __name__ == "__main__":
    main()
