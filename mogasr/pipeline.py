"""High-level pipeline: featurize -> train (EM) -> align/decode -> evaluate.

The L6 layer under the CLIs (SURVEY.md §1): glues the fused front end, the
GMM/neural scorers, the on-device Viterbi and the EM trainer into the five
BASELINE.json workloads. Host code here only orchestrates; every hot loop is
the jitted device code in the layer modules.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mogasr.am import em
from mogasr.am.gmm import GmmSet
from mogasr.am.gmm_pallas import score_frames
from mogasr.config import (
    BatchConfig,
    DecodeConfig,
    FrontendConfig,
    GmmConfig,
    PipelineConfig,
    TrainConfig,
)
from mogasr.data.batching import Batch, make_batches
from mogasr.decoder import viterbi as vit
from mogasr.eval.wer import corpus_wer
from mogasr.frontend.jax_frontend import cached_frontend
from mogasr.hmm import graph as gr
from mogasr.hmm.lexicon import Lexicon
from mogasr.hmm.topology import Topology, build_topology


@dataclasses.dataclass
class FeatBatch:
    utt_ids: List[str]
    feats: jax.Array      # [B, T, D]
    n_frames: jax.Array   # [B]
    words: List[List[str]]

    @property
    def size(self) -> int:
        return len(self.utt_ids)


def featurize(
    utts: Sequence[Tuple[str, np.ndarray, List[str]]],
    fcfg: FrontendConfig,
    bcfg: BatchConfig,
) -> List[FeatBatch]:
    """Batch + run the fused front end; one compile per bucket shape.

    fcfg.add_pitch appends the (POV, centered log-f0, Δlog-f0) pitch triple
    (frontend/pitch.py) frame-aligned to the spectral stream — feat_dim
    already accounts for it, so models sized off the config stay right."""
    return list(featurize_iter(utts, fcfg, bcfg))


def featurize_iter(
    utts: Sequence[Tuple[str, np.ndarray, List[str]]],
    fcfg: FrontendConfig,
    bcfg: BatchConfig,
):
    """Lazy generator behind featurize(): one FeatBatch per bucket, produced
    on demand — compose with data.prefetch.prefetch/device_put_batches to
    overlap host staging with device compute on single-pass sweeps."""
    spectral_cfg = (
        dataclasses.replace(fcfg, add_pitch=False) if fcfg.add_pitch else fcfg
    )
    for batch in make_batches(utts, bcfg, fcfg):
        fe = cached_frontend(spectral_cfg, batch.waves.shape[1])
        feats, n_frames = fe(jnp.asarray(batch.waves), jnp.asarray(batch.num_samples))
        if fcfg.add_pitch:
            from mogasr.frontend.pitch import PitchConfig, features_with_pitch

            if not fcfg.snip_edges:
                raise NotImplementedError(
                    "add_pitch requires snip_edges=True (extract_pitch "
                    "mirrors the snip_edges frame-count formula)"
                )
            # pitch frames must share the SPECTRAL grid, whatever it is
            pcfg = PitchConfig(window_ms=fcfg.frame_length_ms,
                               shift_ms=fcfg.frame_shift_ms)
            feats = features_with_pitch(
                feats, n_frames, jnp.asarray(batch.waves),
                jnp.asarray(batch.num_samples), cfg=pcfg,
                sample_rate=fcfg.sample_rate,
            )
        yield FeatBatch(batch.utt_ids, feats, n_frames, batch.words)


def featurize_streaming(
    utts: Sequence[Tuple[str, np.ndarray, List[str]]],
    fcfg: FrontendConfig,
    bcfg: BatchConfig,
    chunk_samples: int = 8000,
) -> List[FeatBatch]:
    """Featurize through the chunked streaming front end (config[4] path).

    Each utterance is fed chunk-by-chunk to a StreamingFrontend; per-utterance
    CMVN is applied after finalize (deferred — utterance CMVN is acausal by
    definition). Results batch into the same FeatBatch shape as featurize(),
    and match it numerically (tested).
    """
    from mogasr.frontend.numpy_ref import cmvn_np
    from mogasr.frontend.streaming import StreamingFrontend

    # sliding CMVN is causal -> the streamer applies it online; utterance
    # CMVN is acausal -> deferred to after finalize
    stream_cfg = (
        fcfg if fcfg.cmvn == "sliding" else dataclasses.replace(fcfg, cmvn="none")
    )
    per_utt = []
    for utt_id, wave, words in utts:
        sf = StreamingFrontend(stream_cfg)
        outs = [sf.process(wave[i : i + chunk_samples]) for i in range(0, len(wave), chunk_samples)]
        outs.append(sf.finalize())
        feats = np.concatenate(outs) if outs else np.zeros((0, fcfg.feat_dim), np.float32)
        if fcfg.cmvn == "utterance" and feats.shape[0] > 0:
            feats = cmvn_np(feats, fcfg.cmvn_norm_var).astype(np.float32)
        per_utt.append((utt_id, feats, words))

    # bucket by frame count, mirroring make_batches
    frame_bounds = list(bcfg.bucket_boundaries)
    if bcfg.sort_by_length:
        per_utt.sort(key=lambda it: it[1].shape[0])
    out: List[FeatBatch] = []
    group: List = []
    group_bucket = 0

    def emit(group, bucket):
        B = bcfg.batch_size
        arr = np.zeros((B, bucket, fcfg.feat_dim), np.float32)
        nf = np.zeros(B, np.int32)
        ids, words_out = [], []
        for i, (utt_id, feats, words) in enumerate(group):
            arr[i, : feats.shape[0]] = feats
            nf[i] = feats.shape[0]
            ids.append(utt_id)
            words_out.append(list(words))
        words_out.extend([[]] * (B - len(group)))
        return FeatBatch(ids, jnp.asarray(arr), jnp.asarray(nf), words_out)

    for item in per_utt:
        t = item[1].shape[0]
        b = next((fb for fb in frame_bounds if t <= fb), None)
        if b is None:
            continue  # overlong: dropped, like make_batches
        if group and (b != group_bucket or len(group) >= bcfg.batch_size):
            out.append(emit(group, group_bucket))
            group = []
        group.append(item)
        group_bucket = b
    if group:
        out.append(emit(group, group_bucket))
    return out


def compute_global_cmvn(batches: Sequence[FeatBatch]):
    """Corpus-level (mean, inv_std) over valid frames — the stats that
    streaming global CMVN (frontend.streaming) applies frame-wise."""
    total = None
    total_sq = None
    count = 0.0
    for fb in batches:
        feats = np.asarray(fb.feats)
        mask = (
            np.arange(feats.shape[1])[None, :] < np.asarray(fb.n_frames)[:, None]
        ).astype(np.float64)[:, :, None]
        s = (feats * mask).sum((0, 1))
        sq = (feats ** 2 * mask).sum((0, 1))
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
        count += mask.sum()
    mean = total / max(count, 1.0)
    var = np.maximum(total_sq / max(count, 1.0) - mean ** 2, 1e-10)
    return mean.astype(np.float32), (1.0 / np.sqrt(var)).astype(np.float32)


def score_batch(feats: jax.Array, gmm: GmmSet) -> jax.Array:
    """[B, T, D] -> [B, T, S] exact float32 scores through the system's one
    GMM scorer entry (gmm_pallas.score_frames: the fused kernel on a GPU,
    XLA elsewhere, per shard when feats is sharded over a mesh)."""
    return score_frames(feats, gmm)


def build_align_graphs(
    batch_words: List[List[str]],
    lexicon: Lexicon,
    topo: Topology,
    j_bucket: int = 64,
    align_fn=None,
) -> Dict[str, np.ndarray]:
    """Batch align graphs, padding J up to a bucket multiple so the jitted
    Viterbi sees a bounded set of [B, J] shapes (one XLA compile per
    (T-bucket, J-bucket) pair instead of per transcript length).

    align_fn(phone_ids) -> Graph overrides the monophone expansion (e.g. the
    context-dependent align_graph_cd from mogasr.hmm.triphone)."""
    if align_fn is None:
        align_fn = lambda pids: gr.align_graph(topo, pids)
    gs = [
        align_fn(lexicon.words_to_phone_ids(w, oov="sil")) if w else align_fn([lexicon.sil_id])
        for w in batch_words
    ]
    j_max = max(g.n_states for g in gs)
    j_max = -(-j_max // j_bucket) * j_bucket
    return gr.batch_graphs(gs, j_max=j_max)


def align_batch(
    fb: FeatBatch,
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    acoustic_scale: float = 1.0,
    align_fn=None,
) -> Tuple[vit.ViterbiResult, jax.Array, Dict[str, jax.Array]]:
    """Force-align a featurized batch -> (result, pdf labels [B,T], graphs)."""
    graphs_np = build_align_graphs(fb.words, lexicon, topo, align_fn=align_fn)
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    ll = score_batch(fb.feats, gmm)
    res = vit.viterbi(ll, graphs, fb.n_frames, acoustic_scale=acoustic_scale)
    labels = vit.path_to_pdfs(res, graphs)
    return res, labels, graphs


def flat_start(
    batches: Sequence[FeatBatch], lexicon: Lexicon, topo: Topology
) -> GmmSet:
    """Uniform-alignment single-component init (SURVEY.md §7 step 3)."""
    all_feats, all_labels = [], []
    for fb in batches:
        feats = np.asarray(fb.feats)
        nf = np.asarray(fb.n_frames)
        for b in range(fb.size):
            g = gr.align_graph(
                topo,
                lexicon.words_to_phone_ids(fb.words[b], oov="sil")
                if fb.words[b]
                else [lexicon.sil_id],
            )
            t = int(nf[b])
            if t == 0:
                continue
            all_feats.append(feats[b, :t])
            all_labels.append(em.uniform_alignment_labels(g.emit_id, g.n_states, t))
    x = np.concatenate(all_feats)
    y = np.concatenate(all_labels)
    return em.init_from_labels(x, y, topo.n_pdfs)


def train_gmm(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    topo: Topology,
    gcfg: GmmConfig,
    tcfg: TrainConfig,
    logger=None,
    gmm: Optional[GmmSet] = None,
    mode: str = "viterbi",
    reestimate_transitions: bool = False,
    ckpt_dir: Optional[str] = None,
    align_fn=None,
    n_pdfs: Optional[int] = None,
) -> "TrainGmmResult":
    """EM training with realignment and mixture-splitting schedule.

    Doubles components every few iterations until gcfg.n_components, then
    keeps refining — the standard monophone recipe shape (SURVEY.md §2 "EM
    trainer" row). mode: "viterbi" = hard EM on forced-alignment labels;
    "baum-welch" = full soft EM via on-device forward-backward
    (mogasr.decoder.forward_backward).

    Splits happen at the START of every 2nd iteration (so the returned model
    is always refit after its last split): reaching K components needs
    num_em_iters >= 2*ceil(log2(K)) + 1; a shorter schedule logs a warning
    and returns fewer components.
    """
    from mogasr.decoder import forward_backward as fbd

    if mode not in ("viterbi", "baum-welch"):
        raise ValueError(f"unknown EM mode {mode!r}")
    if gmm is None:
        gmm = flat_start(batches, lexicon, topo)
    history: List[float] = []
    it = 0
    if ckpt_dir is not None:
        # preemption resume: restore the latest EM iteration if one exists
        # (orbax writes are atomic — SURVEY.md §5 failure-handling row)
        from mogasr.utils import checkpoint as ckpt

        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            # template=None: restore with the saved structure (K may have
            # grown through splitting, so shapes aren't knowable up front)
            state = ckpt.restore_checkpoint(ckpt_dir, None, step=last)
            it = last
            history = [float(x) for x in state["history"]]
            g = state["gmm"]
            gmm = GmmSet(
                jnp.asarray(g["weights"]), jnp.asarray(g["means"]), jnp.asarray(g["vars"])
            )
            probs = np.asarray(state.get("per_phone_self_prob", [-1.0]))
            if probs.size and float(probs.min()) >= 0.0:
                topo = topo.with_transitions(probs)
            fp = np.asarray(state.get("fingerprint", [-1, -1, -1]))
            want = np.asarray(
                [gcfg.n_states, gcfg.n_components, 0 if mode == "viterbi" else 1]
            )
            if fp.size == 3 and not np.array_equal(fp, want):
                raise ValueError(
                    f"EM checkpoint in {ckpt_dir} was written for a different "
                    f"config (saved n_states/n_components/mode={fp.tolist()}, "
                    f"requested {want.tolist()}); use a fresh ckpt_dir"
                )
    import math

    need = 2 * math.ceil(math.log2(max(gcfg.n_components, 1))) + 1
    if gcfg.n_components > gmm.n_components and tcfg.num_em_iters < need:
        msg = (
            f"num_em_iters={tcfg.num_em_iters} cannot reach "
            f"n_components={gcfg.n_components} (needs >= {need}); "
            "the final model will have fewer components"
        )
        if logger:
            logger.log({"stage": "em_warning", "message": msg})
        else:
            import warnings

            warnings.warn(msg)
    pdf_to_phone = topo.pdf_to_phone()
    # State occupancies from the previous E-step, for occupancy-gated
    # splitting. None (first iteration / fresh resume) means the first split
    # is ungated — it happens at it==2 so stats are normally available.
    last_state_occ = None
    while it < tcfg.num_em_iters:
        # splitting schedule: double K at the START of every 2nd iteration
        # until the target, so freshly split components always get at least
        # one E/M pass before the model is returned, and a checkpointed run
        # resumes identically to an uninterrupted one
        if it > 0 and it % 2 == 0 and gmm.n_components < gcfg.n_components:
            gmm = em.split_components(
                gmm, perturb=gcfg.split_perturb, seed=it,
                state_occ=last_state_occ,
                min_frames_per_comp=gcfg.min_split_occ,
            )
            if gmm.n_components > gcfg.n_components:
                gmm = GmmSet(
                    gmm.weights[:, : gcfg.n_components],
                    gmm.means[:, : gcfg.n_components],
                    gmm.vars[:, : gcfg.n_components],
                )
        stats = None
        trans_paths, trans_pdfs = [], []
        for fb in batches:
            if mode == "viterbi":
                res, labels, _ = align_batch(fb, gmm, lexicon, topo, align_fn=align_fn)
                flat_feats = fb.feats.reshape(-1, fb.feats.shape[-1])
                s = em.accumulate_stats(gmm, flat_feats, labels.reshape(-1))
                if reestimate_transitions:
                    trans_paths.append(np.asarray(res.path))
                    trans_pdfs.append(np.asarray(labels))
            else:
                graphs_np = build_align_graphs(fb.words, lexicon, topo, align_fn=align_fn)
                graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
                ll = score_batch(fb.feats, gmm)
                res = fbd.forward_backward(ll, graphs, fb.n_frames)
                npdf = n_pdfs if n_pdfs is not None else topo.n_pdfs
                post = fbd.state_posteriors_to_pdf(
                    res.log_gamma, graphs["emit_id"], npdf
                )
                flat_feats = fb.feats.reshape(-1, fb.feats.shape[-1])
                s = em.accumulate_stats_soft(
                    gmm, flat_feats, post.reshape(-1, npdf)
                )
                # dummy padding rows (n_frames == 0) have -inf forward loglik
                s = s._replace(
                    loglik=jnp.sum(jnp.where(fb.n_frames > 0, res.loglik, 0.0))
                )
            stats = s if stats is None else em.add_stats(stats, s)
        gmm = em.m_step(
            gmm, stats, var_floor=gcfg.var_floor, weight_floor=gcfg.weight_floor
        )
        last_state_occ = np.asarray(jnp.sum(stats.occ, axis=-1))
        ll = float(stats.loglik) / max(float(stats.n_frames), 1.0)
        history.append(ll)
        if reestimate_transitions and trans_paths:
            # batches come from different T buckets: right-pad to the widest
            # with -1 (estimate_transitions stops at the first -1 per row)
            t_max = max(p.shape[1] for p in trans_paths)
            pad = lambda arrs: np.concatenate([
                np.pad(a, ((0, 0), (0, t_max - a.shape[1])), constant_values=-1)
                for a in arrs
            ])
            self_probs, _counts = em.estimate_transitions(
                pad(trans_paths),
                pad(trans_pdfs),
                pdf_to_phone,
                lexicon.n_phones,
            )
            topo = topo.with_transitions(self_probs)
        if logger:
            logger.log({"stage": "em", "iter": it, "K": gmm.n_components, "avg_loglik": ll})
        it += 1
        if ckpt_dir is not None:
            from mogasr.utils import checkpoint as ckpt

            ckpt.save_checkpoint(
                ckpt_dir,
                {
                    "gmm": gmm._asdict(),
                    "history": history,
                    "K": gmm.n_components,
                    # re-estimated transitions must survive preemption too
                    # (orbax rejects zero-size arrays: -1 = "not estimated")
                    "per_phone_self_prob": (
                        np.asarray(topo.per_phone_self_prob, np.float32)
                        if topo.per_phone_self_prob
                        else np.full(lexicon.n_phones, -1.0, np.float32)
                    ),
                    # guards resume against a changed config/corpus setup
                    "fingerprint": np.asarray(
                        [gcfg.n_states, gcfg.n_components, 0 if mode == "viterbi" else 1]
                    ),
                },
                step=it,
            )
    return TrainGmmResult(gmm, history, topo)


@dataclasses.dataclass
class TrainGmmResult:
    """Unpacks like a (gmm, history) pair; topo carries re-estimated
    transitions when reestimate_transitions=True."""

    gmm: GmmSet
    history: List[float]
    topo: Topology

    def __iter__(self):
        return iter((self.gmm, self.history))


def word_decode_graph(
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    word_logp: Optional[np.ndarray] = None,
    multi_pron: bool = False,
) -> gr.Graph:
    """Word-loop decode graph over the full vocabulary + a silence chain.

    multi_pron: expand one chain per pronunciation variant (labels repeat per
    word); each variant's entry carries the word prior + a uniform log
    pronunciation prior, so the total entry mass per word is unchanged.
    """
    g, _ = word_decode_graph_multi(lexicon, topo, dcfg, word_logp) if multi_pron \
        else (_word_graph_single(lexicon, topo, dcfg, word_logp), None)
    return g


def _word_graph_single(lexicon, topo, dcfg, word_logp):
    tokens = [(w, lexicon.word_phone_ids(w)) for w in lexicon.words]
    tokens.append(("<sil>", [lexicon.sil_id]))
    if word_logp is None:
        n = len(lexicon.words)
        word_logp = np.full(len(tokens), -np.log(n + 1), np.float32)
    return gr.loop_graph(
        topo, tokens=tokens, token_logp=word_logp, insertion_penalty=dcfg.word_insertion_penalty
    )


def word_decode_graph_multi(
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    word_logp: Optional[np.ndarray] = None,
) -> Tuple[gr.Graph, np.ndarray]:
    """Multi-pronunciation word-loop graph.

    Returns (graph, pron_logp) where pron_logp[c] is the log pronunciation
    prior of chain c (uniform over each word's variants, 0 for single-pron
    words). The graph's own entry weights already include word prior +
    pron prior (plain-Viterbi path); the LM decoder takes pron_logp
    separately because the LM replaces the word prior.
    """
    words = list(lexicon.words) + ["<sil>"]
    if word_logp is None:
        word_logp = np.full(len(words), -np.log(len(words)), np.float32)
    tokens: List[Tuple[str, List[int]]] = []
    tok_logp: List[float] = []
    pron_logp: List[float] = []
    for wi, w in enumerate(lexicon.words):
        variants = lexicon.word_variant_phone_ids(w)
        lp = -np.log(len(variants))
        for pids in variants:
            tokens.append((w, pids))
            tok_logp.append(float(word_logp[wi]) + lp)
            pron_logp.append(lp)
    tokens.append(("<sil>", [lexicon.sil_id]))
    tok_logp.append(float(word_logp[len(lexicon.words)]))
    pron_logp.append(0.0)
    g = gr.loop_graph(
        topo,
        tokens=tokens,
        token_logp=np.asarray(tok_logp, np.float32),
        insertion_penalty=dcfg.word_insertion_penalty,
    )
    return g, np.asarray(pron_logp, np.float32)


def decode_batch(
    fb: FeatBatch,
    scores: jax.Array,
    graph: gr.Graph,
    dcfg: DecodeConfig,
    drop_tokens: Tuple[str, ...] = ("<sil>", "sil"),
) -> List[List[str]]:
    """Viterbi-decode scored frames against a shared loop graph -> token seqs."""
    B = fb.size
    graphs_np = gr.batch_graphs([graph] * scores.shape[0])
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    res = vit.viterbi(
        scores,
        graphs,
        fb.n_frames,
        acoustic_scale=dcfg.acoustic_scale,
        beam=dcfg.beam,
    )
    toks = vit.path_to_tokens(res, graph.labels, graphs_np["chain_id"])
    return [[t for t in seq if t not in drop_tokens] for seq in toks[:B]]


def decode_batch_lattices(
    fb: FeatBatch,
    scores: jax.Array,
    graph: gr.Graph,
    lm,
    dcfg: DecodeConfig,
    chain_entry_logp: Optional[np.ndarray] = None,
    prune_beam: Optional[float] = None,
):
    """First-pass LM decode + word-lattice materialization.

    Returns (lattices, LmViterbiResult) — feed the lattices to
    decoder.lattice.lattice_nbest / rescore_lattice for N-best output or
    second-pass (e.g. trigram) rescoring.
    """
    from mogasr.decoder.lattice import lattices_from_pass
    from mogasr.decoder.lm_viterbi import viterbi_lm

    res, (lat_sc, lat_st, lat_ba) = viterbi_lm(
        scores, graph, lm, fb.n_frames,
        acoustic_scale=dcfg.acoustic_scale,
        insertion_penalty=dcfg.word_insertion_penalty,
        chain_entry_logp=chain_entry_logp,
        with_lattice=True,
    )
    lats = lattices_from_pass(
        lat_sc, lat_st, lat_ba, fb.n_frames, graph.labels, prune_beam=prune_beam
    )
    return lats[: fb.size], res


def make_nn_scorer(model, params, log_priors: jax.Array,
                   precision: str = "float32"):
    """Hybrid NN-HMM scorer: posteriors -> prior-scaled pseudo-likelihoods.

    Returns a ``scorer(fb) -> [B, T, n_pdfs]`` closure for evaluate()/decode.
    precision: "float32" (default) | "bfloat16" (any arch, half-precision matmuls) |
    "int8" (MlpAm and LstmAm: dynamic-activation int8 GEMMs) —
    am/quantize.py; the prior-scaled log-softmax stays f32 in every mode.
    """
    from mogasr.am.neural import posteriors_to_loglik
    from mogasr.am.quantize import make_quantized_logits

    logits_fn = make_quantized_logits(model, params, precision)

    @jax.jit
    def score(feats, n_frames):
        return posteriors_to_loglik(logits_fn(feats, n_frames), log_priors)

    return lambda fb: score(fb.feats, fb.n_frames)


def make_ctc_scorer(model, params):
    """Re-export of mogasr.am.ctc.make_ctc_scorer for pipeline users."""
    from mogasr.am.ctc import make_ctc_scorer as _m

    return _m(model, params)


def train_ctc(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    tcfg: TrainConfig,
    arch: str = "mlp",
    steps: Optional[int] = None,
    spec_augment: bool = False,
    include_sil: bool = False,
    init_params=None,
    logger=None,
):
    """Alignment-free CTC training: (features, phone sequence) pairs only.

    No GMM bootstrap, no forced alignment — the capability the hybrid CE
    path cannot offer. Vocabulary is lexicon phones + blank (last index).
    Returns (model, params); decode via mogasr.am.ctc.ctc_decode_graph +
    the shared Viterbi (plain or LM), or greedy/prefix-beam phone decode.
    """
    from mogasr.am import ctc as C

    return train_ctc_units(
        batches,
        lambda words: C.ctc_labels_from_words(lexicon, words, include_sil),
        lexicon.n_phones,
        tcfg, arch=arch, steps=steps, spec_augment=spec_augment,
        init_params=init_params, logger=logger,
    )


def train_ctc_bpe(
    batches: Sequence[FeatBatch],
    bpe,
    tcfg: TrainConfig,
    arch: str = "mlp",
    steps: Optional[int] = None,
    spec_augment: bool = False,
    init_params=None,
    logger=None,
):
    """Lexicon-free CTC on BPE subword targets (mogasr.data.bpe).

    Decoding is greedy/prefix-beam over units, then ``bpe.decode`` joins
    units into words — open-vocabulary, no pronunciation lexicon, no decode
    graph. Returns (model, params).
    """
    return train_ctc_units(
        batches, bpe.encode, bpe.n_units,
        tcfg, arch=arch, steps=steps, spec_augment=spec_augment,
        init_params=init_params, logger=logger,
    )


def train_ctc_units(
    batches: Sequence[FeatBatch],
    encode_fn,               # words -> unit-id sequence
    n_units: int,            # vocabulary WITHOUT blank (blank = n_units)
    tcfg: TrainConfig,
    arch: str = "mlp",
    steps: Optional[int] = None,
    spec_augment: bool = False,
    init_params=None,
    logger=None,
):
    """Generic alignment-free CTC over any unit inventory (phones, BPE).

    init_params (optional): warm-start tree, e.g. an MPC-pretrained encoder
    (mogasr.am.pretrain): every leaf whose path+shape matches this model is
    copied in (transfer_pretrained); mismatched leaves — the task head —
    keep their fresh init."""
    from mogasr.am import ctc as C
    from mogasr.am.neural import build_model

    V = n_units + 1
    model = build_model(arch, V, tcfg)
    state = C.init_ctc_train_state(
        model, tcfg, batches[0].feats.shape[-1], jax.random.key(tcfg.seed)
    )
    if init_params is not None:
        from mogasr.am.pretrain import transfer_pretrained

        merged, copied, total = transfer_pretrained(init_params, state.params)
        if copied == 0:
            raise ValueError(
                "init_params shares no (path, shape)-compatible leaves with "
                f"the {arch} CTC model — arch/hidden/layers mismatch?")
        state = state._replace(params=merged)
        if logger is not None:
            logger.log({"stage": "ctc_warm_start", "leaves_copied": copied,
                        "leaves_total": total})
    step_fn = C.make_ctc_train_step(model, tcfg, spec_augment=spec_augment)
    labeled = _pack_ctc_targets(batches, encode_fn)

    total = steps if steps is not None else tcfg.num_nn_steps
    i, m = 0, {"loss": jnp.asarray(0.0)}
    while i < total:
        for fb, labels, n_labels in labeled:
            state, m = step_fn(state, fb.feats, fb.n_frames, labels, n_labels)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "train_ctc", "step": i, "loss": float(m["loss"])})
            if i >= total:
                break
    return model, state.params


def _pack_ctc_targets(batches: Sequence[FeatBatch], encode_fn):
    """[(fb, labels [rows,L], n_labels [rows])] with one shared pad length
    (single compile) and zero-length rows for batch padding."""
    from mogasr.am import ctc as C

    seqs_all = [
        [encode_fn(fb.words[b]) for b in range(fb.size)]
        for fb in batches
    ]
    l_max = max((len(s) for seqs in seqs_all for s in seqs), default=1)
    labeled = []
    for fb, seqs in zip(batches, seqs_all):
        rows = int(fb.feats.shape[0])
        seqs = seqs + [[] for _ in range(rows - fb.size)]
        labels, n_labels = C.pack_label_batch(seqs, pad_to=l_max)
        labeled.append((fb, jnp.asarray(labels), jnp.asarray(n_labels)))
    return labeled


def distill_ctc_units(
    batches: Sequence[FeatBatch],
    teacher_model,
    teacher_params,
    encode_fn,               # words -> unit-id sequence (teacher's inventory)
    n_units: int,            # vocabulary WITHOUT blank (blank = n_units)
    tcfg: TrainConfig,
    student_arch: str = "lstm",
    alpha: float = 0.5,
    temperature: float = 2.0,
    steps: Optional[int] = None,
    spec_augment: bool = False,
    logger=None,
):
    """Distill a trained CTC teacher into a (typically smaller / streaming)
    student over the SAME unit inventory (mogasr.am.distill).

    The returned (model, params) is a drop-in CTC student: decode it with
    the same greedy/prefix-beam/graph paths, stream it with LstmAmStream,
    serve it with BatchedCtcEngine — the checkpoint layout matches a
    from-scratch CTC model of the same architecture.
    """
    from mogasr.am import ctc as C
    from mogasr.am.distill import make_distill_train_step
    from mogasr.am.neural import build_model

    V = n_units + 1
    model = build_model(student_arch, V, tcfg)
    state = C.init_ctc_train_state(
        model, tcfg, batches[0].feats.shape[-1], jax.random.key(tcfg.seed)
    )
    step_fn = make_distill_train_step(
        model, teacher_model, teacher_params, tcfg,
        alpha=alpha, temperature=temperature, spec_augment=spec_augment,
    )
    labeled = _pack_ctc_targets(batches, encode_fn)

    total = steps if steps is not None else tcfg.num_nn_steps
    i, m = 0, {"loss": jnp.asarray(0.0)}
    while i < total:
        for fb, labels, n_labels in labeled:
            state, m = step_fn(state, fb.feats, fb.n_frames, labels, n_labels)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({
                    "stage": "distill_ctc", "step": i,
                    "loss": float(m["loss"]), "kl": float(m["kl"]),
                    "ctc": float(m["ctc"]),
                })
            if i >= total:
                break
    return model, state.params


def train_rnnt(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    tcfg: TrainConfig,
    encoder_arch: str = "lstm",
    pred_arch: str = "stateless",
    aux_ctc: bool = True,
    ctc_weight: float = 1.0,
    steps: Optional[int] = None,
    include_sil: bool = False,
    pruned_band: int = 0,
    logger=None,
):
    """RNN-Transducer training on (features, phone sequence) pairs.

    Like train_ctc, fully alignment-free; unlike CTC, emissions condition on
    the label history through the prediction network (mogasr.am.rnnt).
    Returns (model, params); decode with rnnt_greedy_decode(_device).

    Defaults encode the low-data recipe measured on the synthetic corpus:
    a STATELESS prediction net + an auxiliary CTC loss
    on the encoder — the LSTM prediction net without auxiliary supervision
    memorizes 48-utterance training sets (train loss 0.01, held-out PER
    0.87). Pass pred_arch="lstm", aux_ctc=False for the classic transducer.
    """
    from mogasr.am import ctc as C

    return train_rnnt_units(
        batches,
        lambda words: C.ctc_labels_from_words(lexicon, words, include_sil),
        lexicon.n_phones,
        tcfg, encoder_arch=encoder_arch, pred_arch=pred_arch, aux_ctc=aux_ctc,
        ctc_weight=ctc_weight, steps=steps, pruned_band=pruned_band,
        logger=logger,
    )


def train_rnnt_bpe(
    batches: Sequence[FeatBatch],
    bpe,
    tcfg: TrainConfig,
    logger=None,
    **kwargs,
):
    """Lexicon-free RNN-T on BPE subword targets; greedy decode + bpe.decode
    gives open-vocabulary words (the transducer twin of train_ctc_bpe)."""
    return train_rnnt_units(
        batches, bpe.encode, bpe.n_units, tcfg, logger=logger, **kwargs
    )


def train_rnnt_units(
    batches: Sequence[FeatBatch],
    encode_fn,
    n_units: int,
    tcfg: TrainConfig,
    encoder_arch: str = "lstm",
    pred_arch: str = "stateless",
    aux_ctc: bool = True,
    ctc_weight: float = 1.0,
    steps: Optional[int] = None,
    pruned_band: int = 0,
    logger=None,
):
    """Generic alignment-free RNN-T over any unit inventory (phones, BPE).

    pruned_band > 0 trains with the pruned transducer loss
    (mogasr.am.rnnt_pruned): the joint runs only on an occupancy-selected
    (t, u) band of that width — the joint GEMMs shrink by (U+1)/band —
    and the checkpoint gains the factored simple_am/simple_lm heads
    (decode CLIs take --rnnt-pruned to rebuild the matching tree)."""
    from mogasr.am import ctc as C
    from mogasr.am import rnnt as R

    model = R.build_rnnt_model(
        n_units, tcfg,
        encoder_arch=encoder_arch, pred_arch=pred_arch, aux_ctc=aux_ctc,
        simple_heads=pruned_band > 0,
    )
    seqs_all = [
        [encode_fn(fb.words[b]) for b in range(fb.size)]
        for fb in batches
    ]
    l_max = max((len(s) for seqs in seqs_all for s in seqs), default=1)
    labeled = []
    for fb, seqs in zip(batches, seqs_all):
        rows = int(fb.feats.shape[0])
        seqs = seqs + [[] for _ in range(rows - fb.size)]
        labels, n_labels = C.pack_label_batch(seqs, pad_to=l_max)
        labeled.append((fb, jnp.asarray(labels), jnp.asarray(n_labels)))
    state = R.init_rnnt_train_state(
        model, tcfg, batches[0].feats.shape[-1], l_max, jax.random.key(tcfg.seed)
    )
    if pruned_band > 0:
        from mogasr.am.rnnt_pruned import make_rnnt_pruned_train_step

        step_fn = make_rnnt_pruned_train_step(
            model, tcfg, band=pruned_band, ctc_weight=ctc_weight
        )
    else:
        step_fn = R.make_rnnt_train_step(model, tcfg, ctc_weight=ctc_weight)
    total = steps if steps is not None else tcfg.num_nn_steps
    i, m = 0, {"loss": jnp.asarray(0.0)}
    while i < total:
        for fb, labels, n_labels in labeled:
            state, m = step_fn(state, fb.feats, fb.n_frames, labels, n_labels)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "train_rnnt", "step": i, "loss": float(m["loss"])})
            if i >= total:
                break
    return model, state.params


def train_aed(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    tcfg: TrainConfig,
    include_sil: bool = False,
    logger=None,
    **kwargs,
):
    """Attention encoder-decoder (Conformer + Transformer decoder) on
    (features, phone sequence) pairs — the third alignment-free family
    next to train_ctc / train_rnnt (mogasr.am.aed). Decode with
    aed_decode_batch (on-device beam search, optional joint-CTC rescore)."""
    from mogasr.am import ctc as C

    return train_aed_units(
        batches,
        lambda words: C.ctc_labels_from_words(lexicon, words, include_sil),
        lexicon.n_phones,
        tcfg, logger=logger, **kwargs,
    )


def train_aed_bpe(
    batches: Sequence[FeatBatch],
    bpe,
    tcfg: TrainConfig,
    logger=None,
    **kwargs,
):
    """Lexicon-free AED on BPE subword targets (open-vocabulary words via
    bpe.decode, like train_ctc_bpe / train_rnnt_bpe)."""
    return train_aed_units(
        batches, bpe.encode, bpe.n_units, tcfg, logger=logger, **kwargs
    )


def train_aed_units(
    batches: Sequence[FeatBatch],
    encode_fn,
    n_units: int,
    tcfg: TrainConfig,
    ctc_weight: float = 0.3,
    smoothing: float = 0.1,
    steps: Optional[int] = None,
    chunk_frames: int = 0,
    left_chunks: int = 1,
    spec_augment: bool = False,
    logger=None,
):
    """Generic AED over any unit inventory (phones, BPE).

    chunk_frames > 0 trains the streaming-capable chunked encoder
    (causal convs + chunk-masked attention; see mogasr.am.aed)."""
    from mogasr.am import aed as A
    from mogasr.am import ctc as C

    model = A.build_aed_model(
        n_units, tcfg, chunk_frames=chunk_frames, left_chunks=left_chunks
    )
    seqs_all = [
        [encode_fn(fb.words[b]) for b in range(fb.size)]
        for fb in batches
    ]
    l_max = max((len(s) for seqs in seqs_all for s in seqs), default=1)
    labeled = []
    for fb, seqs in zip(batches, seqs_all):
        rows = int(fb.feats.shape[0])
        seqs = seqs + [[] for _ in range(rows - fb.size)]
        labels, n_labels = C.pack_label_batch(seqs, pad_to=l_max)
        labeled.append((fb, jnp.asarray(labels), jnp.asarray(n_labels)))
    state = A.init_aed_train_state(
        model, tcfg, batches[0].feats.shape[-1], l_max, jax.random.key(tcfg.seed)
    )
    step_fn = A.make_aed_train_step(
        model, tcfg, ctc_weight=ctc_weight, smoothing=smoothing,
        spec_augment=spec_augment,
    )
    total = steps if steps is not None else tcfg.num_nn_steps
    i, m = 0, {"loss": jnp.asarray(0.0)}
    while i < total:
        for fb, labels, n_labels in labeled:
            state, m = step_fn(state, fb.feats, fb.n_frames, labels, n_labels)
            i += 1
            if logger is not None and i % 50 == 0:
                logger.log({"stage": "train_aed", "step": i, "loss": float(m["loss"])})
            if i >= total:
                break
    return model, state.params


def append_ivectors(
    batches: Sequence[FeatBatch],
    extractor,
    length_norm: bool = True,
) -> List[FeatBatch]:
    """Speaker-aware features: concatenate each utterance's i-vector
    (mogasr.am.ivector.IvectorExtractor) to every frame — the standard
    hybrid-NN adaptation recipe (feat_dim grows by extractor.rank; the same
    transformation must be applied at decode time with the SAME extractor,
    or the AM input distribution silently shifts)."""
    from mogasr.am.ivector import utterance_ivectors

    out = []
    for fb in batches:
        vecs = utterance_ivectors(
            extractor, fb.feats, fb.n_frames, length_norm=length_norm
        )
        tiled = jnp.broadcast_to(
            jnp.asarray(vecs)[:, None, :],
            (fb.feats.shape[0], fb.feats.shape[1], vecs.shape[-1]),
        )
        out.append(dataclasses.replace(
            fb, feats=jnp.concatenate([fb.feats, tiled], axis=-1)
        ))
    return out


def finetune_aed_mwer(
    model,
    params,
    batches: Sequence[FeatBatch],
    encode_fn,
    tcfg: TrainConfig,
    n_hyps: int = 4,
    ce_weight: float = 0.1,
    steps: Optional[int] = None,
    logger=None,
):
    """On-policy MWER fine-tuning of a CE/CTC-trained AED
    (mogasr.am.aed.make_aed_mwer_step): each step beam-decodes the batch
    N-best with the CURRENT params (the compiled decoder is reused — params
    are a traced argument), computes per-hypothesis edit-distance risks vs
    the references on the host, and minimizes the expected risk over the
    renormalized list. Returns (params, history) where history is the
    expected risk per step — the criterion that should fall."""
    from mogasr.am import aed as A
    from mogasr.am.train_nn import make_optimizer
    from mogasr.eval.wer import edit_counts

    seqs_all = [
        [encode_fn(fb.words[b]) for b in range(fb.size)] for fb in batches
    ]
    l_max = max((len(s) for seqs in seqs_all for s in seqs), default=1)
    u_max = l_max + 2
    from mogasr.am import ctc as C

    labeled = []
    for fb, seqs in zip(batches, seqs_all):
        rows = int(fb.feats.shape[0])
        seqs_p = seqs + [[] for _ in range(rows - fb.size)]
        labels, n_labels = C.pack_label_batch(seqs_p, pad_to=l_max)
        labeled.append((fb, seqs, jnp.asarray(labels), jnp.asarray(n_labels)))

    dec = A.make_aed_decoder(
        model, params, beam=n_hyps, max_tokens=u_max, return_all=True
    )
    opt = make_optimizer(tcfg)
    state = A.AedTrainState(
        params, opt.init(params), jnp.zeros((), jnp.int32)
    )
    step_fn = A.make_aed_mwer_step(model, tcfg, ce_weight=ce_weight)
    total = steps if steps is not None else tcfg.num_nn_steps
    history: List[float] = []
    i = 0
    while i < total:
        for fb, seqs, labels, n_labels in labeled:
            toks, n_toks, _sc = dec(fb.feats, fb.n_frames, state.params)
            toks = np.asarray(toks)
            n_toks = np.asarray(n_toks)
            rows, N = toks.shape[0], toks.shape[1]
            hyps = np.full((rows, N, u_max), -1, np.int32)
            n_h = np.zeros((rows, N), np.int32)
            h_mask = np.zeros((rows, N), bool)
            risks = np.zeros((rows, N), np.float32)
            for b in range(fb.size):
                seen = set()
                for n in range(N):
                    h = tuple(int(t) for t in toks[b, n, : n_toks[b, n]])
                    if h in seen:  # duplicate beam slot: don't double-count
                        continue
                    seen.add(h)
                    hyps[b, n, : len(h)] = h
                    n_h[b, n] = len(h)
                    h_mask[b, n] = True
                    risks[b, n] = edit_counts(seqs[b], list(h)).errors
            state, m = step_fn(
                state, fb.feats, fb.n_frames, jnp.asarray(hyps),
                jnp.asarray(n_h), jnp.asarray(h_mask), jnp.asarray(risks),
                labels, n_labels,
            )
            history.append(float(m["expected_risk"]))
            i += 1
            if logger is not None and i % 10 == 0:
                logger.log({"stage": "mwer", "step": i,
                            "expected_risk": history[-1]})
            if i >= total:
                break
    return state.params, history


def finetune_rnnt_mwer(
    model,
    params,
    batches: Sequence[FeatBatch],
    encode_fn,
    tcfg: TrainConfig,
    n_hyps: int = 4,
    anchor_weight: float = 0.1,
    steps: Optional[int] = None,
    logger=None,
):
    """On-policy MWER fine-tuning of a trained RNN-T (the transducer twin of
    finetune_aed_mwer): per-utterance beam N-best via rnnt_beam_decode
    against the CURRENT params, host edit-distance risks, jitted
    expected-risk step (am.rnnt.make_rnnt_mwer_step). Returns
    (params, history) of the expected risk per step."""
    from mogasr.am import ctc as C
    from mogasr.am import rnnt as R
    from mogasr.am.train_nn import make_optimizer
    from mogasr.eval.wer import edit_counts

    seqs_all = [
        [encode_fn(fb.words[b]) for b in range(fb.size)] for fb in batches
    ]
    l_max = max((len(s) for seqs in seqs_all for s in seqs), default=1)
    u_max = l_max + 4
    labeled = []
    for fb, seqs in zip(batches, seqs_all):
        rows = int(fb.feats.shape[0])
        seqs_p = seqs + [[] for _ in range(rows - fb.size)]
        labels, n_labels = C.pack_label_batch(seqs_p, pad_to=l_max)
        labeled.append((fb, seqs, jnp.asarray(labels), jnp.asarray(n_labels)))

    opt = make_optimizer(tcfg)
    state = R.RnntTrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step_fn = R.make_rnnt_mwer_step(model, tcfg, anchor_weight=anchor_weight)
    total = steps if steps is not None else tcfg.num_nn_steps
    history: List[float] = []
    i = 0
    while i < total:
        for fb, seqs, labels, n_labels in labeled:
            rows = int(fb.feats.shape[0])
            hyps = np.full((rows, n_hyps, u_max), -1, np.int32)
            n_h = np.zeros((rows, n_hyps), np.int32)
            h_mask = np.zeros((rows, n_hyps), bool)
            risks = np.zeros((rows, n_hyps), np.float32)
            # on-device beam scan (round 5): the WHOLE search is one jitted
            # dispatch per batch; params are a jit ARGUMENT of the cached
            # scan (_beam_device_fn), so the per-step parameter updates
            # reuse one compile. Ranked lists equal the per-utterance
            # reference (tests/test_rnnt_device_beam.py).
            nbest_all = R.rnnt_beam_decode_device(
                model, state.params, fb.feats, fb.n_frames,
                beam_size=n_hyps, u_cap=u_max,
            )
            for b in range(fb.size):
                nbest = nbest_all[b]
                seen = set()
                for n, (_lp, h) in enumerate(nbest[:n_hyps]):
                    h = tuple(h)
                    if h in seen or len(h) > u_max:
                        continue
                    seen.add(h)
                    hyps[b, n, : len(h)] = h
                    n_h[b, n] = len(h)
                    h_mask[b, n] = True
                    risks[b, n] = edit_counts(seqs[b], list(h)).errors
            state, m = step_fn(
                state, fb.feats, fb.n_frames, jnp.asarray(hyps),
                jnp.asarray(n_h), jnp.asarray(h_mask), jnp.asarray(risks),
                labels, n_labels,
            )
            history.append(float(m["expected_risk"]))
            i += 1
            if logger is not None and i % 10 == 0:
                logger.log({"stage": "rnnt_mwer", "step": i,
                            "expected_risk": history[-1]})
            if i >= total:
                break
    return state.params, history


def evaluate(
    batches: Sequence[FeatBatch],
    gmm: Optional[GmmSet],
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    scorer=None,
    graph: Optional[gr.Graph] = None,
) -> Dict[str, float]:
    """Full decode + WER over featurized batches (single-chip path).

    scorer: optional ``fb -> [B, T, n_pdfs]`` override (e.g. make_nn_scorer);
    defaults to the GMM scorer. graph: optional decode-graph override (e.g.
    a CTC graph from mogasr.am.ctc.ctc_decode_graph).
    """
    if graph is None:
        graph = word_decode_graph(lexicon, topo, dcfg)
    refs, hyps = [], []
    for fb in batches:
        scores = scorer(fb) if scorer is not None else score_batch(fb.feats, gmm)
        out = decode_batch(fb, scores, graph, dcfg)
        for b in range(fb.size):
            refs.append([w.lower() for w in fb.words[b]])
            hyps.append([w.lower() for w in out[b]])
    wer, counts = corpus_wer(refs, hyps)
    return {
        "wer": wer,
        "sub": counts.substitutions,
        "del": counts.deletions,
        "ins": counts.insertions,
        "ref_words": counts.ref_words,
        "n_utts": len(refs),
    }


# --------------------------- context-dependent (triphone) recipe ------------


def collect_cd_stats(
    batches: Sequence[FeatBatch],
    gmm_mono: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
):
    """Monophone-alignment pass -> per-triphone-state (occ, mean, sumsq).

    Returns {(l, c, r, k): (occ, sum_x, sum_xx)} host-side; the alignment
    itself runs on device, only the [B, T] paths come back.
    """
    from mogasr.hmm.triphone import contexts_of

    stats: Dict[tuple, list] = {}
    for fb in batches:
        res, _labels, _graphs = align_batch(fb, gmm_mono, lexicon, topo)
        paths = np.asarray(res.path)
        feats = np.asarray(fb.feats)
        nf = np.asarray(fb.n_frames)
        for b in range(fb.size):
            words = fb.words[b]
            pids = (
                lexicon.words_to_phone_ids(words, oov="sil")
                if words
                else [lexicon.sil_id]
            )
            g = gr.align_graph(topo, pids)
            ctxs = contexts_of(pids, lexicon.sil_id)
            # first graph state of each chain (phone instance)
            chain_start = np.zeros(len(pids), np.int32)
            for j in range(1, g.n_states):
                if g.chain_id[j] != g.chain_id[j - 1]:
                    chain_start[g.chain_id[j]] = j
            for t in range(int(nf[b])):
                j = paths[b, t]
                ci = g.chain_id[j]
                k = int(j - chain_start[ci])
                l, c, r = ctxs[ci]
                key = (l, c, r, k)
                x = feats[b, t]
                if key not in stats:
                    stats[key] = [0.0, np.zeros_like(x, np.float64), np.zeros_like(x, np.float64)]
                acc = stats[key]
                acc[0] += 1.0
                acc[1] += x
                acc[2] += x.astype(np.float64) ** 2
    return stats


def train_triphone(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    topo: Topology,
    gcfg: GmmConfig,
    tcfg: TrainConfig,
    gmm_mono: GmmSet,
    target_pdfs: int = 200,
    min_occ: float = 10.0,
    logger=None,
    mode: str = "viterbi",
):
    """Triphone recipe: mono align -> tie states -> init CD GMM -> CD EM.

    Returns (TiedTriphones, TrainGmmResult). The tied system's pdf count
    (tied.n_pdfs) is the "1k states" axis of the BASELINE sizing; decode with
    mogasr.hmm.triphone.word_loop_graph_cd.
    """
    from mogasr.am.em import init_from_labels  # noqa: F401 (doc pointer)
    from mogasr.hmm import triphone as tri

    raw = collect_cd_stats(batches, gmm_mono, lexicon, topo)
    mean_stats = {
        k: (occ, (sx / max(occ, 1e-8)).astype(np.float64))
        for k, (occ, sx, _sxx) in raw.items()
    }
    tied = tri.tie_states(topo, mean_stats, target_pdfs, min_occ=min_occ)

    # init 1-comp CD GMM from tied stats (unseen pdfs -> global stats)
    D = batches[0].feats.shape[-1]
    occ = np.zeros(tied.n_pdfs)
    sx = np.zeros((tied.n_pdfs, D))
    sxx = np.zeros((tied.n_pdfs, D))
    for (l, c, r, k), (o, s, ss) in raw.items():
        pdf = tied.pdf_of(l, c, r, k)
        occ[pdf] += o
        sx[pdf] += s
        sxx[pdf] += ss
        # backoff pdfs also absorb all their contexts' stats
        if c != lexicon.sil_id:
            bo = tied.backoff[(c, k)]
            if bo != pdf:
                occ[bo] += o
                sx[bo] += s
                sxx[bo] += ss
    g_occ = max(occ.sum(), 1e-8)
    g_mean = sx.sum(0) / g_occ
    g_var = np.maximum(sxx.sum(0) / g_occ - g_mean ** 2, gcfg.var_floor)
    means = np.where(occ[:, None] >= 1.0, sx / np.maximum(occ[:, None], 1e-8), g_mean)
    varis = np.where(
        occ[:, None] >= 2.0,
        np.maximum(sxx / np.maximum(occ[:, None], 1e-8) - means ** 2, gcfg.var_floor),
        g_var,
    )
    gmm_cd = GmmSet(
        weights=jnp.ones((tied.n_pdfs, 1), jnp.float32),
        means=jnp.asarray(means[:, None, :], jnp.float32),
        vars=jnp.asarray(varis[:, None, :], jnp.float32),
    )

    align_fn = lambda pids: tri.align_graph_cd(tied, pids)
    result = train_gmm(
        batches,
        lexicon,
        topo,
        dataclasses.replace(gcfg, n_states=tied.n_pdfs),
        tcfg,
        logger=logger,
        gmm=gmm_cd,
        mode=mode,
        align_fn=align_fn,
        n_pdfs=tied.n_pdfs,
    )
    return tied, result


# ----------------------------- fMLLR two-pass decode ------------------------


def decode_with_fmllr(
    batches: Sequence[FeatBatch],
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    speaker_of=None,
    n_sweeps: int = 8,
    si_gmm: Optional[GmmSet] = None,
):
    """Unsupervised two-pass decoding with per-speaker fMLLR adaptation.

    Pass 1 decodes with the speaker-independent model; the hypotheses are
    force-aligned to get frame labels; per-speaker fMLLR transforms are
    estimated (mogasr.am.fmllr) and applied; pass 2 re-decodes the adapted
    features. speaker_of(utt_id) groups utterances (default: LibriSpeech
    convention, the utt-id prefix before the first '-'; one group if absent).

    When ``gmm`` is a SAT model (train_sat: it lives in the fMLLR-normalized
    feature space), pass ``si_gmm`` = the speaker-independent model: raw
    features decoded/aligned with a SAT-space model produce garbage pass-1
    supervision (measured: WER 232% vs 4% SI on the v2 corpus). Pass 1 and
    the hypothesis alignment then use si_gmm; the transforms and pass 2
    target ``gmm``.

    Returns (hyps_pass2, {speaker: W}).
    """
    from mogasr.am import fmllr as fm

    if speaker_of is None:
        speaker_of = lambda uid: uid.split("-")[0] if "-" in uid else "global"
    first = si_gmm if si_gmm is not None else gmm

    graph = word_decode_graph(lexicon, topo, dcfg)

    # ---- pass 1: SI decode ----
    hyps1: Dict[str, List[str]] = {}
    for fb in batches:
        scores = score_batch(fb.feats, first)
        out = decode_batch(fb, scores, graph, dcfg)
        for b in range(fb.size):
            hyps1[fb.utt_ids[b]] = out[b]

    # ---- align against pass-1 hypotheses -> frame labels ----
    # (hypothesized transcripts; empty hyps align to silence)
    stats_by_spk: Dict[str, fm.FmllrStats] = {}
    for fb in batches:
        hyp_words = [hyps1.get(uid, []) for uid in fb.utt_ids]
        hyp_words += [[]] * (len(fb.words) - len(hyp_words))
        fb_hyp = FeatBatch(fb.utt_ids, fb.feats, fb.n_frames, hyp_words)
        _res, labels, _ = align_batch(fb_hyp, first, lexicon, topo)
        labels_np = np.asarray(labels)
        feats_np = np.asarray(fb.feats)
        # one accumulate dispatch per (batch, speaker) group, not per
        # utterance — the per-dispatch floor dominates otherwise
        by_spk: Dict[str, List[int]] = {}
        for b in range(fb.size):
            by_spk.setdefault(speaker_of(fb.utt_ids[b]), []).append(b)
        D = feats_np.shape[-1]
        for spk, rows in by_spk.items():
            flat_feats = feats_np[rows].reshape(-1, D)
            flat_labels = labels_np[rows].reshape(-1)  # padding stays -1
            s = fm.accumulate_fmllr_stats(
                gmm, jnp.asarray(flat_feats), jnp.asarray(flat_labels)
            )
            prev = stats_by_spk.get(spk)
            stats_by_spk[spk] = (
                s
                if prev is None
                else fm.FmllrStats(
                    prev.k_stat + s.k_stat, prev.g_stat + s.g_stat, prev.beta + s.beta
                )
            )

    transforms = {spk: fm.solve_fmllr(st, n_sweeps=n_sweeps) for spk, st in stats_by_spk.items()}

    # ---- pass 2: adapted decode (batched transform on host: D x D matmul) ----
    hyps2: Dict[str, List[str]] = {}
    for fb in batches:
        feats_np = np.asarray(fb.feats)
        adapted = feats_np.copy()
        for b, uid in enumerate(fb.utt_ids):
            W = transforms[speaker_of(uid)]
            adapted[b] = feats_np[b] @ W[:, :-1].T + W[:, -1]
        fb2 = FeatBatch(fb.utt_ids, jnp.asarray(adapted), fb.n_frames, fb.words)
        scores = score_batch(fb2.feats, gmm)
        out = decode_batch(fb2, scores, graph, dcfg)
        for b in range(fb.size):
            hyps2[fb.utt_ids[b]] = out[b]
    return hyps2, transforms


def _apply_fmllr_batch(fb: FeatBatch, transforms, speaker_of):
    """Per-utterance affine feature transform in one batched einsum."""
    from mogasr.am import fmllr as fm

    D = fb.feats.shape[-1]
    eye = np.concatenate([np.eye(D, dtype=np.float32),
                          np.zeros((D, 1), np.float32)], axis=1)
    # feats rows beyond fb.size are batch padding (n_frames == 0): identity
    Wb = np.stack([
        np.asarray(transforms.get(speaker_of(fb.utt_ids[bi]), eye), np.float32)
        if bi < fb.size else eye
        for bi in range(fb.feats.shape[0])
    ])  # [B, D, D+1]
    del fm
    A = jnp.asarray(Wb[:, :, :-1])   # [B, D, D]
    b = jnp.asarray(Wb[:, :, -1])    # [B, D]
    feats_t = jnp.einsum("btd,bed->bte", fb.feats, A) + b[:, None, :]
    return FeatBatch(fb.utt_ids, feats_t, fb.n_frames, fb.words)


def train_sat(
    batches: Sequence[FeatBatch],
    lexicon: Lexicon,
    topo: Topology,
    gcfg: GmmConfig,
    gmm: GmmSet,
    speaker_of=None,
    n_iters: int = 4,
    n_sweeps: int = 8,
    align_fn=None,
    logger=None,
):
    """Speaker-adaptive training (SAT): fMLLR inside the EM loop.

    The classic Kaldi tri3b-style recipe: each iteration (1) force-aligns the
    speaker-transformed features with the current model, (2) re-estimates
    per-speaker fMLLR transforms from those alignments against the RAW
    features, (3) runs one EM step on the re-transformed features. The
    returned model lives in the fMLLR-normalized feature space — decode with
    ``decode_with_fmllr`` (unsupervised two-pass) or with the returned
    supervised transforms. Returns (gmm, transforms, history).
    """
    from mogasr.am import fmllr as fm

    if speaker_of is None:
        speaker_of = lambda uid: uid.split("-")[0] if "-" in uid else "global"

    transforms: Dict[str, np.ndarray] = {}
    history: List[float] = []
    for it in range(n_iters):
        # (1) align in the current transformed space. The monitored loglik is
        # the true raw-feature likelihood under (model, transform): align
        # score in transformed space + the fMLLR Jacobian log|det A| per
        # frame — without the Jacobian the sequence is not comparable across
        # transform updates.
        labels_per_batch = []
        loglik_sum, frames_sum = 0.0, 0
        logdet = {
            spk: float(np.linalg.slogdet(np.asarray(W)[:, :-1])[1])
            for spk, W in transforms.items()
        }
        for fb in batches:
            fb_t = _apply_fmllr_batch(fb, transforms, speaker_of)
            res, labels, _ = align_batch(fb_t, gmm, lexicon, topo, align_fn=align_fn)
            labels_per_batch.append(labels)
            nf = np.asarray(fb.n_frames)
            valid = nf > 0
            loglik_sum += float(np.asarray(res.score)[valid].sum())
            loglik_sum += sum(
                logdet.get(speaker_of(uid), 0.0) * int(n)
                for uid, n in zip(fb.utt_ids, nf)
            )
            frames_sum += int(nf[valid].sum())
        history.append(loglik_sum / max(frames_sum, 1))

        # (2) per-speaker fMLLR stats on RAW features (the transform target)
        stats_by_spk: Dict[str, fm.FmllrStats] = {}
        for fb, labels in zip(batches, labels_per_batch):
            labels_np = np.asarray(labels)
            feats_np = np.asarray(fb.feats)
            by_spk: Dict[str, List[int]] = {}
            for bi in range(fb.size):
                by_spk.setdefault(speaker_of(fb.utt_ids[bi]), []).append(bi)
            D = feats_np.shape[-1]
            for spk, rows in by_spk.items():
                s = fm.accumulate_fmllr_stats(
                    gmm,
                    jnp.asarray(feats_np[rows].reshape(-1, D)),
                    jnp.asarray(labels_np[rows].reshape(-1)),
                )
                prev = stats_by_spk.get(spk)
                stats_by_spk[spk] = s if prev is None else fm.FmllrStats(
                    prev.k_stat + s.k_stat, prev.g_stat + s.g_stat,
                    prev.beta + s.beta,
                )
        transforms = {
            spk: fm.solve_fmllr(st, n_sweeps=n_sweeps)
            for spk, st in stats_by_spk.items()
        }

        # (3) one EM step on the newly transformed features
        stats = None
        for fb, labels in zip(batches, labels_per_batch):
            fb_t = _apply_fmllr_batch(fb, transforms, speaker_of)
            flat = fb_t.feats.reshape(-1, fb_t.feats.shape[-1])
            s = em.accumulate_stats(gmm, flat, labels.reshape(-1))
            stats = s if stats is None else em.add_stats(stats, s)
        gmm = em.m_step(
            gmm, stats, var_floor=gcfg.var_floor, weight_floor=gcfg.weight_floor
        )
        if logger:
            logger.log({"stage": "sat", "iter": it, "avg_loglik": history[-1]})
    return gmm, transforms, history


# ------------------------- semi-tied covariance (MLLT) ----------------------


def estimate_stc_batches(
    batches: Sequence[FeatBatch],
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    n_iters: int = 10,
):
    """Estimate a global semi-tied covariance transform from forced
    alignments of the batches (mogasr.am.stc). Returns (A, vars_y,
    gmm_y, transform_batches) where gmm_y scores the A-transformed
    features and transform_batches maps FeatBatches into that space —
    the standard recipe insert between ML-EM passes.
    """
    from mogasr.am import stc as st
    from mogasr.am.fmllr import apply_fmllr

    stats = None
    for fb in batches:
        _res, labels, _ = align_batch(fb, gmm, lexicon, topo)
        D = fb.feats.shape[-1]
        s = st.accumulate_stc_stats(
            gmm, fb.feats.reshape(-1, D), labels.reshape(-1)
        )
        stats = s if stats is None else st.StcStats(
            stats.occ + s.occ, stats.scatter + s.scatter
        )
    A, vars_y = st.solve_stc(gmm, stats, n_iters=n_iters)
    gmm_y = st.apply_stc(gmm, A, vars_y)
    W = st.stc_feature_transform(A)

    def transform_batches(bs: Sequence[FeatBatch]) -> List[FeatBatch]:
        return [
            FeatBatch(fb.utt_ids, apply_fmllr(fb.feats, W), fb.n_frames, fb.words)
            for fb in bs
        ]

    return A, vars_y, gmm_y, transform_batches


# ----------------------------- splice + LDA (+ MLLT) ------------------------


@dataclasses.dataclass
class LdaMlltResult:
    """A trained LDA(+MLLT)-space system: ``gmm`` scores features produced
    by splicing base (delta-free) features +-context frames and applying the
    single affine ``transform`` [lda_dim, (2*context+1)*base_dim + 1]."""

    gmm: GmmSet
    transform: np.ndarray
    context: int
    base_fcfg: FrontendConfig
    history: List[float]
    topo: Topology

    def transform_featbatches(self, bs: Sequence[FeatBatch]) -> List[FeatBatch]:
        from mogasr.am import lda as ld
        from mogasr.am.fmllr import apply_fmllr

        return [
            FeatBatch(
                fb.utt_ids,
                apply_fmllr(
                    ld.splice_frames(fb.feats, fb.n_frames, self.context),
                    self.transform,
                ),
                fb.n_frames,
                fb.words,
            )
            for fb in bs
        ]

    def featurize(
        self, utts: Sequence[Tuple[str, np.ndarray, List[str]]], bcfg: BatchConfig
    ) -> List[FeatBatch]:
        return self.transform_featbatches(featurize(utts, self.base_fcfg, bcfg))


def train_lda_mllt(
    utts: Sequence[Tuple[str, np.ndarray, List[str]]],
    lexicon: Lexicon,
    topo: Topology,
    fcfg: FrontendConfig,
    bcfg: BatchConfig,
    gcfg: GmmConfig,
    tcfg: TrainConfig,
    boot_gmm: GmmSet,
    boot_fcfg: Optional[FrontendConfig] = None,
    context: int = 3,
    lda_dim: int = 40,
    mllt: bool = True,
    mllt_iters: int = 8,
    mode: str = "viterbi",
    logger=None,
) -> LdaMlltResult:
    """Kaldi tri2b-shaped recipe: splice -> LDA -> GMM EM (-> MLLT).

    ``boot_gmm`` (trained on ``boot_fcfg`` features, default ``fcfg``)
    supplies forced-alignment class labels; LDA statistics are the
    class-conditional scatters of the SPLICED delta-free base features
    (``fcfg`` with delta_order=0 — LDA learns its own temporal weighting,
    which is the point of replacing deltas); a fresh GMM trains from flat
    start in the projected space; optional MLLT (am/stc.py) re-rotates it
    and composes into the single returned affine transform.
    """
    from mogasr.am import lda as ld
    from mogasr.am.fmllr import apply_fmllr

    boot_fcfg = boot_fcfg or fcfg
    base_fcfg = dataclasses.replace(fcfg, delta_order=0)
    batches_boot = featurize(utts, boot_fcfg, bcfg)
    batches_base = featurize(utts, base_fcfg, bcfg)

    n_classes = boot_gmm.means.shape[0]
    stats = None
    spliced_all: List[jax.Array] = []
    for fb_boot, fb_base in zip(batches_boot, batches_base):
        if fb_boot.utt_ids != fb_base.utt_ids:
            raise RuntimeError("boot/base featurization batch order diverged")
        _res, labels, _ = align_batch(fb_boot, boot_gmm, lexicon, topo)
        spliced = ld.splice_frames(fb_base.feats, fb_base.n_frames, context)
        spliced_all.append(spliced)
        ds = spliced.shape[-1]
        s = ld.accumulate_lda_stats(
            spliced.reshape(-1, ds), labels.reshape(-1), n_classes
        )
        stats = s if stats is None else ld.add_lda_stats(stats, s)
    w_lda = ld.solve_lda(stats, lda_dim)

    lda_batches = [
        FeatBatch(fb.utt_ids, apply_fmllr(spl, w_lda), fb.n_frames, fb.words)
        for fb, spl in zip(batches_base, spliced_all)
    ]
    res = train_gmm(
        lda_batches, lexicon, topo, gcfg, tcfg, logger=logger, mode=mode
    )
    gmm_lda, history, topo_out = res.gmm, res.history, res.topo

    transform = w_lda
    gmm_out = gmm_lda
    if mllt:
        a_mllt, _vars_y, gmm_y, tb = estimate_stc_batches(
            lda_batches, gmm_lda, lexicon, topo_out, n_iters=mllt_iters
        )
        from mogasr.am.stc import stc_feature_transform

        transform = ld.compose_affine(stc_feature_transform(a_mllt), w_lda)
        # refit means/weights in the rotated space (Kaldi interleaves MLLT
        # with EM passes; the scatter-derived variances alone are noisy on
        # small data — measured WER regression without this refit)
        res2 = train_gmm(
            tb(lda_batches), lexicon, topo_out,
            dataclasses.replace(gcfg, n_components=gmm_y.n_components),
            dataclasses.replace(tcfg, num_em_iters=2),
            gmm=gmm_y, logger=logger, mode=mode,
        )
        gmm_out = res2.gmm
        history = history + res2.history
    return LdaMlltResult(gmm_out, transform, context, base_fcfg, history, topo_out)


# ----------------------------- VTLN two-pass decode -------------------------


@jax.jit
def _aligned_loglik_sum(gmm: GmmSet, feats: jax.Array, labels: jax.Array) -> jax.Array:
    """Sum over valid frames of log p(x_t | pdf label_t) — the VTLN warp
    selection objective (labels==-1 rows are padding)."""
    from mogasr.am.gmm import LOG_2PI

    S, K, D = gmm.means.shape
    valid = labels >= 0
    safe = jnp.maximum(labels, 0)
    mu = gmm.means[safe]
    var = jnp.maximum(gmm.vars[safe], 1e-8)
    w = jnp.maximum(gmm.weights[safe], 1e-30)
    x = feats[:, None, :]
    ll_k = (
        jnp.log(w)
        - 0.5 * (D * LOG_2PI + jnp.sum(jnp.log(var), -1))
        - 0.5 * jnp.sum((x - mu) ** 2 / var, -1)
    )
    ll = jax.nn.logsumexp(ll_k, axis=-1)
    return jnp.sum(jnp.where(valid, ll, 0.0))


def decode_with_vtln(
    utts: Sequence[Tuple[str, np.ndarray, List[str]]],   # (id, wave, words)
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    fcfg: FrontendConfig,
    bcfg: BatchConfig,
    dcfg: DecodeConfig,
    warps: Sequence[float] = (0.88, 0.92, 0.96, 1.0, 1.04, 1.08, 1.12),
    speaker_of=None,
):
    """Unsupervised two-pass decoding with per-speaker VTLN warp selection.

    Pass 1 decodes unwarped; hypotheses are force-aligned to frame labels;
    for each candidate warp the speaker's audio is re-featurized through the
    warped mel filterbank (one cached fused frontend per warp — framing is
    warp-invariant so the labels transfer) and the aligned log-likelihood is
    summed; each speaker takes its argmax warp for the pass-2 decode. This is
    the standard grid-search VTLN estimator, batched on device: the per-warp work is
    nw re-runs of the fused frontend GEMM chain plus one scoring reduction.

    Returns (hyps_pass2, {speaker: warp}).
    """
    if speaker_of is None:
        speaker_of = lambda uid: uid.split("-")[0] if "-" in uid else "global"

    graph = word_decode_graph(lexicon, topo, dcfg)
    base_batches = featurize(utts, fcfg, bcfg)

    # ---- pass 1: unwarped decode + alignment labels ----
    hyps1: Dict[str, List[str]] = {}
    for fb in base_batches:
        out = decode_batch(fb, score_batch(fb.feats, gmm), graph, dcfg)
        for b in range(fb.size):
            hyps1[fb.utt_ids[b]] = out[b]

    labels_by_utt: Dict[str, np.ndarray] = {}
    for fb in base_batches:
        hyp_words = [hyps1.get(uid, []) for uid in fb.utt_ids]
        hyp_words += [[]] * (len(fb.words) - len(hyp_words))
        fb_hyp = FeatBatch(fb.utt_ids, fb.feats, fb.n_frames, hyp_words)
        _res, labels, _ = align_batch(fb_hyp, gmm, lexicon, topo)
        labels_np = np.asarray(labels)
        for b in range(fb.size):
            labels_by_utt[fb.utt_ids[b]] = labels_np[b]

    # ---- per-warp featurization + aligned loglik per speaker ----
    ll_by_spk: Dict[str, Dict[float, float]] = {}
    for warp in warps:
        wcfg = dataclasses.replace(fcfg, vtln_warp=float(warp))
        for fb in featurize(utts, wcfg, bcfg):
            feats_np = np.asarray(fb.feats)
            by_spk: Dict[str, List[int]] = {}
            for b in range(fb.size):
                by_spk.setdefault(speaker_of(fb.utt_ids[b]), []).append(b)
            D = feats_np.shape[-1]
            for spk, rows in by_spk.items():
                flat = feats_np[rows].reshape(-1, D)
                labs = np.stack([labels_by_utt[fb.utt_ids[b]] for b in rows]).reshape(-1)
                ll = float(_aligned_loglik_sum(gmm, jnp.asarray(flat), jnp.asarray(labs)))
                ll_by_spk.setdefault(spk, {})
                ll_by_spk[spk][warp] = ll_by_spk[spk].get(warp, 0.0) + ll

    best_warp = {
        spk: max(lls, key=lls.get) for spk, lls in ll_by_spk.items()
    }

    # ---- pass 2: decode each speaker with its warp ----
    hyps2: Dict[str, List[str]] = {}
    for warp in sorted(set(best_warp.values())):
        wcfg = dataclasses.replace(fcfg, vtln_warp=float(warp))
        w_utts = [u for u in utts if best_warp[speaker_of(u[0])] == warp]
        for fb in featurize(w_utts, wcfg, bcfg):
            out = decode_batch(fb, score_batch(fb.feats, gmm), graph, dcfg)
            for b in range(fb.size):
                hyps2[fb.utt_ids[b]] = out[b]
    return hyps2, best_warp


# ----------------------------- MLLR two-pass decode -------------------------


def decode_with_mllr(
    batches: Sequence[FeatBatch],
    gmm: GmmSet,
    lexicon: Lexicon,
    topo: Topology,
    dcfg: DecodeConfig,
    speaker_of=None,
    min_occ: float = 1.0,
):
    """Unsupervised two-pass decoding with per-speaker mean-MLLR adaptation.

    Model-space counterpart of decode_with_fmllr: pass 1 decodes with the
    speaker-independent GMM, hypotheses are force-aligned, a global mean
    transform mu' = A mu + b is solved in closed form per speaker
    (mogasr.am.mllr), and pass 2 re-decodes with each speaker's adapted
    model. Features are untouched, so MLLR composes with feature-space
    processing (e.g. apply fMLLR first, MLLR second).

    Returns (hyps_pass2, {speaker: W}).
    """
    from mogasr.am import mllr as ml

    if speaker_of is None:
        speaker_of = lambda uid: uid.split("-")[0] if "-" in uid else "global"

    graph = word_decode_graph(lexicon, topo, dcfg)

    # ---- pass 1: SI decode ----
    hyps1: Dict[str, List[str]] = {}
    for fb in batches:
        scores = score_batch(fb.feats, gmm)
        out = decode_batch(fb, scores, graph, dcfg)
        for b in range(fb.size):
            hyps1[fb.utt_ids[b]] = out[b]

    # ---- align pass-1 hypotheses -> frame labels -> per-speaker stats ----
    stats_by_spk: Dict[str, ml.MllrStats] = {}
    for fb in batches:
        hyp_words = [hyps1.get(uid, []) for uid in fb.utt_ids]
        hyp_words += [[]] * (len(fb.words) - len(hyp_words))
        fb_hyp = FeatBatch(fb.utt_ids, fb.feats, fb.n_frames, hyp_words)
        _res, labels, _ = align_batch(fb_hyp, gmm, lexicon, topo)
        labels_np = np.asarray(labels)
        feats_np = np.asarray(fb.feats)
        by_spk: Dict[str, List[int]] = {}
        for b in range(fb.size):
            by_spk.setdefault(speaker_of(fb.utt_ids[b]), []).append(b)
        D = feats_np.shape[-1]
        for spk, rows in by_spk.items():
            s = ml.accumulate_mllr_stats(
                gmm,
                jnp.asarray(feats_np[rows].reshape(-1, D)),
                jnp.asarray(labels_np[rows].reshape(-1)),
            )
            prev = stats_by_spk.get(spk)
            stats_by_spk[spk] = (
                s if prev is None
                else ml.MllrStats(prev.occ + s.occ, prev.xsum + s.xsum)
            )

    transforms = {
        spk: ml.solve_mllr(gmm, st, min_occ=min_occ)
        for spk, st in stats_by_spk.items()
    }
    adapted = {spk: ml.apply_mllr(gmm, W) for spk, W in transforms.items()}

    # ---- pass 2: decode with each speaker's adapted MODEL. One scoring
    # dispatch per (batch, speaker-in-batch); rows of other speakers are
    # computed but discarded (static shapes beat per-utterance dispatch). ----
    hyps2: Dict[str, List[str]] = {}
    for fb in batches:
        spk_rows: Dict[str, List[int]] = {}
        for b in range(fb.size):
            spk_rows.setdefault(speaker_of(fb.utt_ids[b]), []).append(b)
        for spk, rows in spk_rows.items():
            scores = score_batch(fb.feats, adapted[spk])
            out = decode_batch(fb, scores, graph, dcfg)
            for b in rows:
                hyps2[fb.utt_ids[b]] = out[b]
    return hyps2, transforms


# --------------------------- confidence-scored decoding ---------------------


def decode_batch_with_confidence(
    fb: FeatBatch,
    scores: jax.Array,
    graph: gr.Graph,
    dcfg: DecodeConfig,
    drop_tokens: Tuple[str, ...] = ("<sil>", "sil"),
    with_times: bool = False,
):
    """Viterbi decode + per-word posterior confidence.

    Confidence of a decoded word = its chain's posterior mass (from
    forward-backward over the SAME decode graph), averaged over the word's
    Viterbi time span — the standard lattice-free posterior confidence.
    Returns [(word, confidence)] per utterance, or
    [(word, confidence, start_frame, end_frame)] with ``with_times=True``
    (end exclusive; frames convert to seconds via frame_shift).
    """
    from mogasr.decoder import forward_backward as fbd

    B = fb.size
    n_chains = int(np.max(graph.chain_id)) + 1
    graphs_np = gr.batch_graphs([graph] * scores.shape[0])
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    res = vit.viterbi(
        scores, graphs, fb.n_frames,
        acoustic_scale=dcfg.acoustic_scale, beam=dcfg.beam,
    )
    fbr = fbd.forward_backward(scores, graphs, fb.n_frames,
                               acoustic_scale=dcfg.acoustic_scale)
    # chain posterior per frame: [B, T, C]
    chain_post = fbd.state_posteriors_to_pdf(
        fbr.log_gamma, graphs["chain_id"], n_chains
    )
    chain_post = np.asarray(chain_post)
    path = np.asarray(res.path)
    entered = np.asarray(res.entered)
    nf = np.asarray(fb.n_frames)

    out: List[List[tuple]] = []
    for b in range(B):
        words: List[tuple] = []
        spans: List[Tuple[int, int, int]] = []  # (chain, start_t, end_t)
        for t in range(int(nf[b])):
            if entered[b, t]:
                if spans:
                    spans[-1] = (spans[-1][0], spans[-1][1], t)
                spans.append((int(graph.chain_id[path[b, t]]), t, int(nf[b])))
        for c, t0, t1 in spans:
            label = graph.labels[c]
            if label in drop_tokens:
                continue
            conf = float(chain_post[b, t0:t1, c].mean()) if t1 > t0 else 0.0
            # f32 posteriors can overshoot 1 by ~1e-3
            conf = round(min(max(conf, 0.0), 1.0), 4)
            words.append((label, conf, t0, t1) if with_times else (label, conf))
        out.append(words)
    return out


def decode_batch_nbest(
    fb: FeatBatch,
    scores: jax.Array,
    graph: gr.Graph,
    dcfg: DecodeConfig,
    n_best: int = 5,
    min_posterior: float = 0.01,
    drop_tokens: Tuple[str, ...] = ("<sil>", "sil"),
):
    """Confusion-network-style word alternatives per Viterbi time span.

    For each word span of the 1-best path, ranks all vocabulary chains by
    their average forward-backward posterior over the span — a lightweight
    lattice substitute (cf. PAPERS.md exact-lattice decoders; here the
    posterior comes from the same loop graph, no lattice materialization).

    Returns per utterance: [ {"best": word, "span": (t0, t1),
    "alternatives": [(word, posterior), ...]} ].
    """
    from mogasr.decoder import forward_backward as fbd

    B = fb.size
    n_chains = int(np.max(graph.chain_id)) + 1
    graphs_np = gr.batch_graphs([graph] * scores.shape[0])
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}
    res = vit.viterbi(
        scores, graphs, fb.n_frames,
        acoustic_scale=dcfg.acoustic_scale, beam=dcfg.beam,
    )
    fbr = fbd.forward_backward(scores, graphs, fb.n_frames,
                               acoustic_scale=dcfg.acoustic_scale)
    chain_post = np.asarray(
        fbd.state_posteriors_to_pdf(fbr.log_gamma, graphs["chain_id"], n_chains)
    )
    path = np.asarray(res.path)
    entered = np.asarray(res.entered)
    nf = np.asarray(fb.n_frames)

    out = []
    for b in range(B):
        spans: List[Tuple[int, int, int]] = []
        for t in range(int(nf[b])):
            if entered[b, t]:
                if spans:
                    spans[-1] = (spans[-1][0], spans[-1][1], t)
                spans.append((int(graph.chain_id[path[b, t]]), t, int(nf[b])))
        words = []
        for c, t0, t1 in spans:
            label = graph.labels[c]
            if label in drop_tokens or t1 <= t0:
                continue
            avg = chain_post[b, t0:t1].mean(axis=0)  # [C]
            order = np.argsort(-avg)[: max(n_best, 1)]
            alts = [
                (graph.labels[int(ci)], round(float(min(avg[ci], 1.0)), 4))
                for ci in order
                if avg[ci] >= min_posterior and graph.labels[int(ci)] not in drop_tokens
            ]
            words.append({"best": label, "span": (t0, t1), "alternatives": alts})
        out.append(words)
    return out
