"""Serve CLI tests: the line-JSON streaming session protocol — ready /
partial / final event flow, two INTERLEAVED sessions with independent
state, and protocol error events."""

import io
import json
import sys

import numpy as np

from tests.test_cli import run_cli
import pytest


def _events(capsys):
    return [
        json.loads(l)
        for l in capsys.readouterr().out.strip().splitlines()
        if l.startswith("{")
    ]




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

def test_serve_demo_session(tmp_path, monkeypatch, capsys):
    from cli import serve

    run_cli(
        serve,
        ["--synthetic-demo-session", "--run-dir", str(tmp_path / "run")],
        monkeypatch,
    )
    ev = _events(capsys)
    assert ev[0] == {"session": "demo", "event": "ready"}
    partials = [e for e in ev if "partial" in e]
    finals = [e for e in ev if "final" in e]
    assert len(partials) >= 3 and len(finals) == 1
    assert finals[0]["session"] == "demo"
    # partial timestamps are monotone
    ts = [e["t_audio_s"] for e in partials]
    assert ts == sorted(ts)


def test_serve_interleaved_sessions_and_errors(tmp_path, monkeypatch, capsys):
    from cli import serve
    from mogasr.data.synthetic import make_corpus

    utts = make_corpus(2, words_per_utt=(2, 2), seed=9)
    chunk = 4000
    lines = [
        {"type": "start", "session": "a"},
        {"type": "start", "session": "a"},          # duplicate -> error
        {"type": "start", "session": "b"},
        {"type": "audio", "session": "ghost", "pcm": [0.0] * 10},  # error
    ]
    # interleave the two sessions' audio chunk by chunk
    ca = [utts[0].wave[i : i + chunk] for i in range(0, len(utts[0].wave), chunk)]
    cb = [utts[1].wave[i : i + chunk] for i in range(0, len(utts[1].wave), chunk)]
    for i in range(max(len(ca), len(cb))):
        if i < len(ca):
            lines.append({"type": "audio", "session": "a",
                          "pcm": ca[i].tolist()})
        if i < len(cb):
            lines.append({"type": "audio", "session": "b",
                          "pcm": cb[i].tolist()})
    lines += [
        {"type": "end", "session": "a"},
        {"type": "end", "session": "b"},
        {"type": "end", "session": "a"},            # already ended -> error
        {"type": "shutdown"},
        {"type": "start", "session": "never"},      # after shutdown: unread
    ]
    stdin = io.StringIO("\n".join(json.dumps(l) for l in lines) + "\n")
    monkeypatch.setattr(sys, "stdin", stdin)
    run_cli(serve, ["--run-dir", str(tmp_path / "run")], monkeypatch)
    ev = _events(capsys)

    finals = {e["session"]: e for e in ev if "final" in e}
    assert set(finals) == {"a", "b"}
    errors = [e for e in ev if "error" in e]
    assert any(e.get("session") == "a" and "exists" in e["error"] for e in errors)
    assert any(e.get("session") == "ghost" for e in errors)
    # shutdown stopped the loop before the trailing start
    assert not any(e.get("session") == "never" for e in ev)
    # per-session partial streams are independent and monotone
    for sid in ("a", "b"):
        ts = [e["t_audio_s"] for e in ev if e.get("session") == sid
              and "partial" in e]
        assert ts == sorted(ts) and len(ts) >= 2


def test_serve_ctc_bpe_session(tmp_path, monkeypatch, capsys):
    """--ctc serving: open-vocabulary BPE-CTC sessions with stateful LSTM
    chunks and streaming decode."""
    from cli import serve, train_nn
    from mogasr.data.synthetic import make_corpus

    run_cli(
        train_nn,
        ["--synthetic", "3", "--run-dir", str(tmp_path / "run"),
         "--arch", "lstm", "--hidden", "16", "--layers", "2", "--steps", "6",
         "--objective", "ctc", "--bpe-merges", "20"],
        monkeypatch,
    )
    capsys.readouterr()  # drop training output
    utt = make_corpus(1, words_per_utt=(2, 2), seed=3)[0]
    chunk = 4000
    lines = [{"type": "start", "session": "s"}]
    for i in range(0, len(utt.wave), chunk):
        lines.append({"type": "audio", "session": "s",
                      "pcm": utt.wave[i : i + chunk].tolist()})
    lines += [{"type": "end", "session": "s"}, {"type": "shutdown"}]
    stdin = io.StringIO("\n".join(json.dumps(l) for l in lines) + "\n")
    monkeypatch.setattr(sys, "stdin", stdin)
    run_cli(
        serve,
        ["--run-dir", str(tmp_path / "run2"), "--ctc",
         "--bpe", str(tmp_path / "run" / "bpe.json"),
         "--nn-ckpt", str(tmp_path / "run" / "nn_ctc_lstm"),
         "--nn-hidden", "16", "--nn-layers", "2"],
        monkeypatch,
    )
    ev = _events(capsys)
    assert ev[0] == {"session": "s", "event": "ready"}
    assert any("partial" in e for e in ev)
    finals = [e for e in ev if "final" in e]
    assert len(finals) == 1 and isinstance(finals[0]["final"], list)


def test_serve_aed_session(tmp_path, monkeypatch, capsys):
    """--aed serving: chunked streaming Conformer sessions — CTC-greedy
    partials per chunk, exact attention-beam final."""
    from cli import serve, train_nn
    from mogasr.data.synthetic import make_corpus

    run_cli(
        train_nn,
        ["--synthetic", "3", "--run-dir", str(tmp_path / "run"),
         "--hidden", "32", "--layers", "1", "--steps", "6",
         "--objective", "aed", "--aed-chunk", "4"],
        monkeypatch,
    )
    capsys.readouterr()
    utt = make_corpus(1, words_per_utt=(2, 2), seed=5)[0]
    chunk = 4000
    lines = [{"type": "start", "session": "s"}]
    for i in range(0, len(utt.wave), chunk):
        lines.append({"type": "audio", "session": "s",
                      "pcm": utt.wave[i : i + chunk].tolist()})
    lines += [{"type": "end", "session": "s"}, {"type": "shutdown"}]
    stdin = io.StringIO("\n".join(json.dumps(l) for l in lines) + "\n")
    monkeypatch.setattr(sys, "stdin", stdin)
    run_cli(
        serve,
        ["--run-dir", str(tmp_path / "run2"), "--aed",
         "--nn-ckpt", str(tmp_path / "run" / "nn_aed_mlp"),
         "--nn-hidden", "32", "--nn-layers", "1", "--aed-chunk", "4",
         "--aed-beam", "2"],
        monkeypatch,
    )
    ev = _events(capsys)
    assert ev[0] == {"session": "s", "event": "ready"}
    assert any("partial" in e for e in ev)
    finals = [e for e in ev if "final" in e]
    assert len(finals) == 1 and isinstance(finals[0]["final"], list)


def test_serve_engine_demo_session(tmp_path, monkeypatch, capsys):
    """--engine demo: the batched session engine speaks the same protocol."""
    from cli import serve

    run_cli(
        serve,
        ["--synthetic-demo-session", "--engine", "--engine-capacity", "4",
         "--run-dir", str(tmp_path / "run")],
        monkeypatch,
    )
    ev = _events(capsys)
    assert ev[0] == {"session": "demo", "event": "ready"}
    partials = [e for e in ev if "partial" in e]
    finals = [e for e in ev if "final" in e]
    assert len(partials) >= 3 and len(finals) == 1
    ts = [e["t_audio_s"] for e in partials]
    assert ts == sorted(ts)


def test_serve_engine_partial_every(tmp_path, monkeypatch, capsys):
    """--partial-every N thins partial emissions to every Nth tick (the
    deferred-absorption amortization dial) without changing the final."""
    from cli import serve

    evs = {}
    for n in (1, 4):
        run_cli(
            serve,
            ["--synthetic-demo-session", "--engine", "--engine-capacity", "4",
             "--partial-every", str(n),
             "--run-dir", str(tmp_path / f"run{n}")],
            monkeypatch,
        )
        evs[n] = _events(capsys)
    p1 = [e for e in evs[1] if "partial" in e]
    p4 = [e for e in evs[4] if "partial" in e]
    assert len(p4) < len(p1) and len(p4) >= 1
    f1 = [e for e in evs[1] if "final" in e]
    f4 = [e for e in evs[4] if "final" in e]
    assert len(f1) == len(f4) == 1 and f1[0]["final"] == f4[0]["final"]


def test_serve_engine_interleaved_matches_per_session(tmp_path, monkeypatch,
                                                      capsys):
    """Engine mode vs per-session mode on identical interleaved event
    streams: SAME finals (the engine batches dispatches, not semantics),
    and protocol errors still fire."""
    from cli import serve
    from mogasr.data.synthetic import make_corpus

    utts = make_corpus(2, words_per_utt=(2, 2), seed=9)
    chunk = 4000
    lines = [
        {"type": "start", "session": "a"},
        {"type": "start", "session": "a"},          # duplicate -> error
        {"type": "start", "session": "b"},
        {"type": "audio", "session": "ghost", "pcm": [0.0] * 10},  # error
    ]
    ca = [utts[0].wave[i : i + chunk] for i in range(0, len(utts[0].wave), chunk)]
    cb = [utts[1].wave[i : i + chunk] for i in range(0, len(utts[1].wave), chunk)]
    for i in range(max(len(ca), len(cb))):
        if i < len(ca):
            lines.append({"type": "audio", "session": "a",
                          "pcm": ca[i].tolist()})
        if i < len(cb):
            lines.append({"type": "audio", "session": "b",
                          "pcm": cb[i].tolist()})
    lines += [
        {"type": "end", "session": "a"},
        {"type": "end", "session": "b"},
        {"type": "shutdown"},
    ]
    text = "\n".join(json.dumps(l) for l in lines) + "\n"

    finals = {}
    for mode, argv in [
        ("plain", ["--run-dir", str(tmp_path / "r1")]),
        ("engine", ["--run-dir", str(tmp_path / "r2"),
                    "--engine", "--engine-capacity", "4"]),
    ]:
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        run_cli(serve, argv, monkeypatch)
        ev = _events(capsys)
        finals[mode] = {e["session"]: e["final"] for e in ev if "final" in e}
        errors = [e for e in ev if "error" in e]
        assert any(e.get("session") == "a" and "exists" in e["error"]
                   for e in errors), mode
        assert any(e.get("session") == "ghost" for e in errors), mode
        for sid in ("a", "b"):
            ts = [e["t_audio_s"] for e in ev if e.get("session") == sid
                  and "partial" in e]
            assert ts == sorted(ts) and len(ts) >= 2, mode
    assert set(finals["plain"]) == {"a", "b"}
    assert finals["engine"] == finals["plain"]


def test_serve_engine_aed_matches_per_session(tmp_path, monkeypatch, capsys):
    """--engine --aed: the batched chunked-AED engine speaks the protocol
    and its finals equal the per-session --aed server on the same events."""
    from cli import serve, train_nn
    from mogasr.data.synthetic import make_corpus

    run_cli(
        train_nn,
        ["--synthetic", "3", "--run-dir", str(tmp_path / "run"),
         "--hidden", "16", "--layers", "1", "--steps", "6",
         "--objective", "aed", "--aed-chunk", "2"],
        monkeypatch,
    )
    capsys.readouterr()  # drop training output
    utts = make_corpus(2, words_per_utt=(2, 2), seed=3)
    chunk = 4000
    lines = [{"type": "start", "session": "a"},
             {"type": "start", "session": "b"}]
    ch = [[u.wave[i : i + chunk] for i in range(0, len(u.wave), chunk)]
          for u in utts]
    for i in range(max(len(c) for c in ch)):
        for sid, c in zip("ab", ch):
            if i < len(c):
                lines.append({"type": "audio", "session": sid,
                              "pcm": c[i].tolist()})
    lines += [{"type": "end", "session": "a"},
              {"type": "end", "session": "b"}, {"type": "shutdown"}]
    text = "\n".join(json.dumps(l) for l in lines) + "\n"

    common = ["--aed", "--aed-chunk", "2", "--aed-beam", "2",
              "--nn-ckpt", str(tmp_path / "run" / "nn_aed_mlp"),
              "--nn-hidden", "16", "--nn-layers", "1"]
    finals = {}
    for mode, extra in [("plain", []),
                        ("engine", ["--engine", "--engine-capacity", "4"])]:
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        run_cli(serve, ["--run-dir", str(tmp_path / f"r_{mode}")] + common
                + extra, monkeypatch)
        ev = _events(capsys)
        finals[mode] = {e["session"]: e["final"] for e in ev if "final" in e}
        assert any("partial" in e for e in ev), mode
    assert set(finals["plain"]) == {"a", "b"}
    assert finals["engine"] == finals["plain"]


def test_serve_engine_ctc_matches_per_session(tmp_path, monkeypatch, capsys):
    """--engine --ctc: the batched CTC engine speaks the protocol and its
    finals equal the per-session --ctc server on the same event stream."""
    from cli import serve, train_nn
    from mogasr.data.synthetic import make_corpus

    run_cli(
        train_nn,
        ["--synthetic", "3", "--run-dir", str(tmp_path / "run"),
         "--arch", "lstm", "--hidden", "16", "--layers", "2", "--steps", "6",
         "--objective", "ctc", "--bpe-merges", "20"],
        monkeypatch,
    )
    capsys.readouterr()  # drop training output
    utts = make_corpus(2, words_per_utt=(2, 2), seed=3)
    chunk = 4000
    lines = [{"type": "start", "session": "a"},
             {"type": "start", "session": "b"}]
    ca = [utts[0].wave[i : i + chunk]
          for i in range(0, len(utts[0].wave), chunk)]
    cb = [utts[1].wave[i : i + chunk]
          for i in range(0, len(utts[1].wave), chunk)]
    for i in range(max(len(ca), len(cb))):
        if i < len(ca):
            lines.append({"type": "audio", "session": "a",
                          "pcm": ca[i].tolist()})
        if i < len(cb):
            lines.append({"type": "audio", "session": "b",
                          "pcm": cb[i].tolist()})
    lines += [{"type": "end", "session": "a"},
              {"type": "end", "session": "b"}, {"type": "shutdown"}]
    text = "\n".join(json.dumps(l) for l in lines) + "\n"

    common = ["--ctc", "--bpe", str(tmp_path / "run" / "bpe.json"),
              "--nn-ckpt", str(tmp_path / "run" / "nn_ctc_lstm"),
              "--nn-hidden", "16", "--nn-layers", "2"]
    finals = {}
    for mode, extra in [("plain", []),
                        ("engine", ["--engine", "--engine-capacity", "4"])]:
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        run_cli(serve, ["--run-dir", str(tmp_path / f"r_{mode}")] + common
                + extra, monkeypatch)
        ev = _events(capsys)
        finals[mode] = {e["session"]: e["final"] for e in ev if "final" in e}
        assert any("partial" in e for e in ev), mode
    assert set(finals["plain"]) == {"a", "b"}
    assert finals["engine"] == finals["plain"]


def test_serve_engine_rnnt_matches_per_session(tmp_path, monkeypatch, capsys):
    """--engine --rnnt: the batched RNN-T engine speaks the protocol and its
    finals equal the per-session --rnnt server on the same event stream."""
    from cli import serve, train_nn
    from mogasr.data.synthetic import make_corpus

    run_cli(
        train_nn,
        ["--synthetic", "3", "--run-dir", str(tmp_path / "run"),
         "--arch", "lstm", "--hidden", "16", "--layers", "2", "--steps", "6",
         "--objective", "rnnt"],
        monkeypatch,
    )
    capsys.readouterr()  # drop training output
    utts = make_corpus(2, words_per_utt=(2, 2), seed=3)
    chunk = 4000
    lines = [{"type": "start", "session": "a"},
             {"type": "start", "session": "b"}]
    ch = [[u.wave[i : i + chunk] for i in range(0, len(u.wave), chunk)]
          for u in utts]
    for i in range(max(len(c) for c in ch)):
        for sid, c in zip("ab", ch):
            if i < len(c):
                lines.append({"type": "audio", "session": sid,
                              "pcm": c[i].tolist()})
    lines += [{"type": "end", "session": "a"},
              {"type": "end", "session": "b"}, {"type": "shutdown"}]
    text = "\n".join(json.dumps(l) for l in lines) + "\n"

    common = ["--rnnt", "--nn-ckpt", str(tmp_path / "run" / "nn_rnnt_lstm"),
              "--nn-hidden", "16", "--nn-layers", "2"]
    finals = {}
    for mode, extra in [("plain", []),
                        ("engine", ["--engine", "--engine-capacity", "4"])]:
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        run_cli(serve, ["--run-dir", str(tmp_path / f"r_{mode}")] + common
                + extra, monkeypatch)
        ev = _events(capsys)
        finals[mode] = {e["session"]: e["final"] for e in ev if "final" in e}
        assert any("partial" in e for e in ev), mode
    assert set(finals["plain"]) == {"a", "b"}
    assert finals["engine"] == finals["plain"]


def _endpoint_event_stream(seed=7):
    """One session: speech then 1.5 s of silence, NO client 'end'."""
    from mogasr.data.synthetic import make_corpus

    utt = make_corpus(1, words_per_utt=(2, 3), seed=seed)[0]
    wave = np.concatenate(
        [utt.wave, np.zeros(int(1.5 * 16000), np.float32)])
    chunk = 1600
    lines = [{"type": "start", "session": "e"}]
    lines += [{"type": "audio", "session": "e",
               "pcm": wave[i : i + chunk].tolist()}
              for i in range(0, len(wave), chunk)]
    lines.append({"type": "shutdown"})
    return "\n".join(json.dumps(l) for l in lines) + "\n"


def test_serve_endpoint_per_session(tmp_path, monkeypatch, capsys):
    """--endpoint: the server ends the utterance itself — endpoint event,
    then a final carrying the firing rule; later audio gets an error."""
    from cli import serve

    monkeypatch.setattr(sys, "stdin", io.StringIO(_endpoint_event_stream()))
    run_cli(serve, ["--run-dir", str(tmp_path / "run"), "--num-components",
                    "1", "--endpoint"], monkeypatch)
    ev = _events(capsys)
    eps = [e for e in ev if e.get("event") == "endpoint"]
    finals = [e for e in ev if "final" in e]
    errors = [e for e in ev if "error" in e]
    assert len(eps) == 1 and eps[0]["rule"] == "rule1_trailing_silence"
    assert len(finals) == 1 and finals[0]["endpoint"] == "rule1_trailing_silence"
    # the tail silence chunks arrive after the endpoint -> session is gone
    assert errors and all(e["error"] == "no such session" for e in errors)


def test_serve_endpoint_engine(tmp_path, monkeypatch, capsys):
    """--engine --endpoint: same protocol through the batched engine (the
    'endpointed' error guards the finalizing slot)."""
    from cli import serve

    monkeypatch.setattr(sys, "stdin", io.StringIO(_endpoint_event_stream()))
    run_cli(serve, ["--run-dir", str(tmp_path / "run"), "--num-components",
                    "1", "--engine", "--engine-capacity", "4", "--endpoint"],
            monkeypatch)
    ev = _events(capsys)
    eps = [e for e in ev if e.get("event") == "endpoint"]
    finals = [e for e in ev if "final" in e]
    assert len(eps) == 1 and eps[0]["rule"] == "rule1_trailing_silence"
    assert len(finals) == 1 and finals[0]["endpoint"] == "rule1_trailing_silence"
