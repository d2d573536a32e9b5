"""viterbi_chunked (two-level transfer-matrix scan) == viterbi (sequential).

Round 5 (VERDICT r4 item 5): the SURVEY §7 log-depth Viterbi candidate,
implemented as the O(J^2)-work chunked form (the O(J^3) max-plus
matrix-product associative_scan is arithmetically rejected). Exactness contract: identical paths/entered flags on
tie-free random cases (chunked re-association can perturb float sums by
~1 ulp), scores to 1e-5 — over align graphs, word-loop graphs, the CTC
skip topology, ragged n_frames, and chunk sizes that do/don't divide T.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from mogasr import pipeline as pipe
from mogasr.config import DecodeConfig, TopologyConfig
from mogasr.decoder import viterbi as vit
from mogasr.hmm import graph as gr
from mogasr.hmm.lexicon import synthetic_lexicon
from mogasr.hmm.topology import build_topology


def _word_graphs(batch):
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    g = pipe.word_decode_graph(
        lex, topo, DecodeConfig(word_insertion_penalty=2.0))
    graphs = {k: jnp.asarray(v)
              for k, v in gr.batch_graphs([g] * batch).items()}
    return graphs, topo.n_pdfs


@pytest.mark.parametrize("chunk", [4, 7, 32])
def test_chunked_matches_sequential_word_graph(chunk):
    graphs, P = _word_graphs(3)
    rng = np.random.default_rng(0)
    B, T = 3, 25
    ll = jnp.asarray(rng.standard_normal((B, T, P)).astype(np.float32))
    nf = jnp.asarray([25, 13, 1], np.int32)

    a = vit.viterbi(ll, graphs, nf, acoustic_scale=0.7)
    b = vit.viterbi_chunked(ll, graphs, nf, acoustic_scale=0.7, chunk=chunk)
    np.testing.assert_allclose(
        np.asarray(b.score), np.asarray(a.score), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(b.path), np.asarray(a.path))
    np.testing.assert_array_equal(
        np.asarray(b.entered), np.asarray(a.entered))


def test_chunked_matches_sequential_align_graph():
    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    rng = np.random.default_rng(2)
    word_seqs = [["cat", "run"], ["sun", "talk", "walk"], ["new"]]
    gs = [gr.align_graph(
        topo, lex.words_to_phone_ids(ws)) for ws in word_seqs]
    graphs = {k: jnp.asarray(v) for k, v in gr.batch_graphs(gs).items()}
    nf = np.asarray([40, 55, 30], np.int32)
    ll = jnp.asarray(rng.standard_normal(
        (len(gs), 55, topo.n_pdfs)).astype(np.float32))

    a = vit.viterbi(ll, graphs, jnp.asarray(nf))
    b = vit.viterbi_chunked(ll, graphs, jnp.asarray(nf), chunk=6)
    np.testing.assert_allclose(
        np.asarray(b.score), np.asarray(a.score), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(b.path), np.asarray(a.path))


def test_chunked_matches_sequential_skip_topology():
    """CTC optional-blank graphs exercise the skip (j-2 -> j) arc."""
    from mogasr.am.ctc import ctc_decode_graph

    rng = np.random.default_rng(3)
    lex = synthetic_lexicon()
    g = ctc_decode_graph(lex, DecodeConfig())
    graphs = {k: jnp.asarray(v)
              for k, v in gr.batch_graphs([g] * 2).items()}
    assert "skip_logp" in graphs
    T, V = 12, lex.n_phones + 1
    ll = jnp.asarray(rng.standard_normal((2, T, V)).astype(np.float32))
    nf = jnp.asarray([12, 9], np.int32)

    a = vit.viterbi(ll, graphs, nf)
    b = vit.viterbi_chunked(ll, graphs, nf, chunk=5)
    np.testing.assert_allclose(
        np.asarray(b.score), np.asarray(a.score), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(b.path), np.asarray(a.path))


def test_chunked_no_backtrace_scores():
    graphs, P = _word_graphs(2)
    rng = np.random.default_rng(4)
    ll = jnp.asarray(rng.standard_normal((2, 10, P)).astype(np.float32))
    nf = jnp.asarray([10, 10], np.int32)
    a = vit.viterbi(ll, graphs, nf, with_backtrace=False)
    b = vit.viterbi_chunked(ll, graphs, nf, chunk=4, with_backtrace=False)
    np.testing.assert_allclose(
        np.asarray(b.score), np.asarray(a.score), rtol=1e-5, atol=1e-4)
