"""On-device frame-synchronous Viterbi over chain+loop graphs.

The decode hot loop (SURVEY.md §3.3): a ``lax.scan`` over frames; each step is
a handful of batched [B, J] vector ops plus one max-reduce for the loop state
— max-plus recursion on the MXU/VPU, no data-dependent shapes (SURVEY.md §7
hard-part #2). Used for both forced alignment (align graphs) and free decode
(loop graphs); beam pruning is an optional mask, identical results at beam=inf
(tested per SURVEY.md §4).

Backtrace also runs on device as a reverse scan over stored backpointers
(uint8 per (frame, state): stay/advance/enter + an int32 per-frame exit
argmax), so the only host transfer is the final [B, T] path.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -1e30


class ViterbiResult(NamedTuple):
    path: jax.Array     # [B, T] graph-state index per frame (-1 on padding)
    entered: jax.Array  # [B, T] bool: frame t entered its chain via the loop
    score: jax.Array    # [B] total best log-prob (acoustic*scale + transition)


@functools.partial(
    jax.jit, static_argnames=("acoustic_scale", "beam", "with_backtrace")
)
def viterbi(
    emit_ll: jax.Array,        # [B, T, P] pdf log-likelihoods
    graphs: Dict[str, jax.Array],  # batch_graphs() output, on device
    n_frames: jax.Array,       # [B]
    acoustic_scale: float = 1.0,
    beam: float = 0.0,         # 0 = exact (no pruning)
    with_backtrace: bool = True,
) -> ViterbiResult:
    B, T, P = emit_ll.shape
    emit_id = graphs["emit_id"]          # [B, J]
    self_logp = graphs["self_logp"]
    adv_logp = graphs["adv_logp"]
    enter_logp = graphs["enter_logp"]
    exit_logp = graphs["exit_logp"]
    # optional (j-2 -> j) skip transitions (CTC optional-blank topology)
    skip_logp = graphs.get("skip_logp")
    J = emit_id.shape[1]

    # Pre-gather emissions for every (frame, graph-state) in ONE gather —
    # [B, T, J] — instead of a per-step gather inside the scan (measured ~2x
    # on the scan-bound decode).
    emit_graph = jnp.take_along_axis(
        emit_ll * acoustic_scale, emit_id[:, None, :], axis=2
    )  # [B, T, J]
    emit_tm = jnp.transpose(emit_graph, (1, 0, 2))  # [T, B, J]

    delta0 = graphs["init_logp"] + emit_tm[0]

    def step(delta, inputs):
        emit_t, t = inputs  # emit_t: [B, J] already graph-indexed
        exit_scores = delta + exit_logp
        exit_best = jnp.max(exit_scores, axis=1)              # [B]
        exit_arg = jnp.argmax(exit_scores, axis=1).astype(jnp.int32)

        stay = delta + self_logp
        adv = jnp.concatenate(
            [jnp.full((B, 1), NEG_INF), delta[:, :-1] + adv_logp[:, 1:]], axis=1
        )
        ent = exit_best[:, None] + enter_logp

        best = jnp.maximum(jnp.maximum(stay, adv), ent)
        bp = jnp.where(
            best == ent, jnp.uint8(2), jnp.where(best == adv, jnp.uint8(1), jnp.uint8(0))
        )
        if skip_logp is not None:
            skip = jnp.concatenate(
                [jnp.full((B, 2), NEG_INF), delta[:, :-2] + skip_logp[:, 2:]],
                axis=1,
            )
            bp = jnp.where(skip > best, jnp.uint8(3), bp)
            best = jnp.maximum(best, skip)
        # prefer stay on ties (bp computed above prefers enter then adv; make
        # stay win exact ties for deterministic alignments)
        bp = jnp.where(best == stay, jnp.uint8(0), bp)

        new_delta = best + emit_t
        if beam > 0:
            thresh = jnp.max(new_delta, axis=1, keepdims=True) - beam
            new_delta = jnp.where(new_delta >= thresh, new_delta, NEG_INF)

        active = (t < n_frames)[:, None]
        delta_out = jnp.where(active, new_delta, delta)
        bp = jnp.where(active, bp, jnp.uint8(0))
        return delta_out, (bp, exit_arg)

    ts = jnp.arange(1, T)
    delta_final, (bps, exit_args) = jax.lax.scan(
        step, delta0, (emit_tm[1:], ts), unroll=4
    )
    # bps: [T-1, B, J]; exit_args: [T-1, B]

    final_scores = delta_final + graphs["final_logp"]
    score = jnp.max(final_scores, axis=1)
    j_final = jnp.argmax(final_scores, axis=1).astype(jnp.int32)

    if not with_backtrace:
        empty = jnp.zeros((B, T), jnp.int32)
        return ViterbiResult(empty, empty.astype(bool), score)

    def back_step(j, inputs):
        bp_t, exit_t = inputs
        b = jnp.take_along_axis(bp_t, j[:, None], axis=1)[:, 0]  # [B]
        j_prev = jnp.where(
            b == 0, j, jnp.where(b == 1, j - 1, jnp.where(b == 3, j - 2, exit_t))
        )
        return j_prev, (j, b == 2)

    j0, (path_rev, entered_rev) = jax.lax.scan(
        back_step, j_final, (bps[::-1], exit_args[::-1])
    )
    path = jnp.concatenate([j0[None], path_rev[::-1]], axis=0).T   # [B, T]
    entered = jnp.concatenate(
        [jnp.ones((1, B), bool), entered_rev[::-1]], axis=0
    ).T
    mask = jnp.arange(T)[None, :] < n_frames[:, None]
    path = jnp.where(mask, path, -1)
    entered = entered & mask
    return ViterbiResult(path, entered, score)


@functools.partial(
    jax.jit, static_argnames=("acoustic_scale", "chunk", "with_backtrace")
)
def viterbi_chunked(
    emit_ll: jax.Array,        # [B, T, P]
    graphs: Dict[str, jax.Array],
    n_frames: jax.Array,
    acoustic_scale: float = 1.0,
    chunk: int = 32,
    with_backtrace: bool = True,
) -> ViterbiResult:
    """Latency-parallel Viterbi: chunked max-plus transfer matrices.

    SURVEY §7 hard-part 2 names a log-depth max-plus ``associative_scan``
    over T as the fallback when the sequential scan's latency binds. The
    FULL log-depth form needs max-plus matrix-MATRIX products: O(J^3) elementwise
    work per combine (no matrix unit does max-plus), i.e. J^2/deg ~ 5000x
    the sequential work at the headline word-loop J — arithmetically dead. What survives of the idea is the
    TWO-LEVEL scan implemented here, which cuts sequential DEPTH from T
    to ~(C + T/C + C) for J x more work (deg -> J per frame):

    - pass 1: each length-C chunk's [J, J] max-plus transfer matrix, by
      running the SAME per-frame step on J basis vectors for all chunks
      in parallel (depth C, work B*T*J^2);
    - boundary pass: chunk-boundary deltas by T/C sequential max-plus
      matrix-VECTOR applications (depth T/C, work B*(T/C)*J^2);
    - pass 2: re-run the sequential step INSIDE every chunk in parallel
      from its boundary delta (depth C), collecting the same bp codes the
      plain scan stores; backtrace is unchanged.

    Exactness: identical max/argmax decisions given identical float sums;
    chunked re-association can perturb sums by ~1 ulp, so paths are
    equality-tested on tie-free random cases and scores to 1e-5
    (tests/test_viterbi_assoc.py). Beam pruning is data-dependent on the
    running delta, which transfer matrices cannot see — exact mode only.
    """
    B, T, P = emit_ll.shape
    emit_id = graphs["emit_id"]
    self_logp = graphs["self_logp"][:, None]     # [B, 1, J]
    adv_logp = graphs["adv_logp"][:, None]
    enter_logp = graphs["enter_logp"][:, None]
    exit_logp = graphs["exit_logp"][:, None]
    skip_logp = graphs.get("skip_logp")
    if skip_logp is not None:
        skip_logp = skip_logp[:, None]
    J = emit_id.shape[1]
    C = int(chunk)
    NC = -(-max(T - 1, 1) // C)                  # chunks over frames [1, T)

    emit_graph = jnp.take_along_axis(
        emit_ll * acoustic_scale, emit_id[:, None, :], axis=2)  # [B, T, J]
    pad = 1 + NC * C - T
    emit_pad = jnp.pad(emit_graph, ((0, 0), (0, pad), (0, 0)))
    emit_tm = jnp.transpose(emit_pad, (1, 0, 2))  # [1 + NC*C, B, J]

    def step_core(delta, emit_t, active):
        """One max-plus frame update on delta [B, M, J] (M broadcast over
        the graph arrays); emit_t [B, M, J]; active [B, M] bool."""
        exit_scores = delta + exit_logp
        exit_best = jnp.max(exit_scores, axis=-1)
        exit_arg = jnp.argmax(exit_scores, axis=-1).astype(jnp.int32)
        stay = delta + self_logp
        adv = jnp.concatenate(
            [jnp.full(delta.shape[:-1] + (1,), NEG_INF),
             delta[..., :-1] + adv_logp[..., 1:]], axis=-1)
        ent = exit_best[..., None] + enter_logp
        best = jnp.maximum(jnp.maximum(stay, adv), ent)
        bp = jnp.where(
            best == ent, jnp.uint8(2),
            jnp.where(best == adv, jnp.uint8(1), jnp.uint8(0)))
        if skip_logp is not None:
            skip = jnp.concatenate(
                [jnp.full(delta.shape[:-1] + (2,), NEG_INF),
                 delta[..., :-2] + skip_logp[..., 2:]], axis=-1)
            bp = jnp.where(skip > best, jnp.uint8(3), bp)
            best = jnp.maximum(best, skip)
        bp = jnp.where(best == stay, jnp.uint8(0), bp)
        new_delta = best + emit_t
        am = active[..., None]
        return (jnp.where(am, new_delta, delta),
                jnp.where(am, bp, jnp.uint8(0)), exit_arg)

    delta0 = graphs["init_logp"] + emit_tm[0]     # [B, J]

    # ---- pass 1: chunk transfer matrices via J basis vectors ----------
    eye = jnp.where(jnp.eye(J, dtype=bool), 0.0, NEG_INF)
    M0 = jnp.broadcast_to(eye, (B, NC, J, J)).reshape(B, NC * J, J)
    c_idx = jnp.arange(NC)

    def p1_step(mat, s):
        f = 1 + c_idx * C + s                                   # [NC]
        em = emit_tm[f].transpose(1, 0, 2)                      # [B, NC, J]
        em = jnp.repeat(em, J, axis=1)                          # [B, NC*J, J]
        act = (f[None, :] < n_frames[:, None])                  # [B, NC]
        act = jnp.repeat(act, J, axis=1)
        mat, _bp, _ex = step_core(mat, em, act)
        return mat, None

    mats, _ = jax.lax.scan(p1_step, M0, jnp.arange(C))
    mats = mats.reshape(B, NC, J, J)                            # [B, NC, Jsrc, J]

    # ---- boundary pass: sequential max-plus matvec over chunks --------
    def bnd_step(d, m):
        nd = jnp.max(d[:, :, None] + m, axis=1)
        return nd, nd

    delta_final, bnds = jax.lax.scan(
        bnd_step, delta0, jnp.transpose(mats, (1, 0, 2, 3)))
    # boundaries entering each chunk: delta0 then bnds[:-1]
    bound_in = jnp.concatenate([delta0[None], bnds[:-1]], axis=0)  # [NC, B, J]

    final_scores = delta_final + graphs["final_logp"]
    score = jnp.max(final_scores, axis=1)
    j_final = jnp.argmax(final_scores, axis=1).astype(jnp.int32)

    if not with_backtrace:
        empty = jnp.zeros((B, T), jnp.int32)
        return ViterbiResult(empty, empty.astype(bool), score)

    # ---- pass 2: per-chunk sequential re-run collecting bp codes ------
    d2 = jnp.transpose(bound_in, (1, 0, 2))                     # [B, NC, J]

    def p2_step(d, s):
        f = 1 + c_idx * C + s
        em = emit_tm[f].transpose(1, 0, 2)                      # [B, NC, J]
        act = f[None, :] < n_frames[:, None]
        d, bp, ex = step_core(d, em, act)
        return d, (bp, ex)

    _d, (bp2, ex2) = jax.lax.scan(p2_step, d2, jnp.arange(C))
    # bp2 [C, B, NC, J] -> [NC*C, B, J] frame-major; ex2 likewise
    bps = jnp.transpose(bp2, (2, 0, 1, 3)).reshape(NC * C, B, J)[: T - 1]
    exit_args = jnp.transpose(ex2, (2, 0, 1)).reshape(NC * C, B)[: T - 1]

    def back_step(j, inputs):
        bp_t, exit_t = inputs
        b = jnp.take_along_axis(bp_t, j[:, None], axis=1)[:, 0]
        j_prev = jnp.where(
            b == 0, j,
            jnp.where(b == 1, j - 1, jnp.where(b == 3, j - 2, exit_t)))
        return j_prev, (j, b == 2)

    j0, (path_rev, entered_rev) = jax.lax.scan(
        back_step, j_final, (bps[::-1], exit_args[::-1]))
    path = jnp.concatenate([j0[None], path_rev[::-1]], axis=0).T
    entered = jnp.concatenate(
        [jnp.ones((1, B), bool), entered_rev[::-1]], axis=0).T
    mask = jnp.arange(T)[None, :] < n_frames[:, None]
    return ViterbiResult(
        jnp.where(mask, path, -1), entered & mask, score)


def path_to_pdfs(result: ViterbiResult, graphs: Dict[str, jax.Array]) -> jax.Array:
    """[B, T] pdf id per frame (-1 on padding) — the EM/NN training labels."""
    emit_id = graphs["emit_id"]
    safe = jnp.maximum(result.path, 0)
    pdfs = jnp.take_along_axis(emit_id, safe, axis=1)
    return jnp.where(result.path >= 0, pdfs, -1)


def path_to_tokens(result: ViterbiResult, graph_labels, chain_id: np.ndarray):
    """Host-side: collapse a decoded path into token label sequences per utt.

    chain_id: [B, J]; graph_labels: per-utterance list of chain labels.
    """
    path = np.asarray(result.path)
    entered = np.asarray(result.entered)
    B, T = path.shape
    out = []
    for b in range(B):
        labels = graph_labels[b] if isinstance(graph_labels[0], (list, tuple)) else graph_labels
        toks = []
        for t in range(T):
            if path[b, t] < 0:
                break
            if entered[b, t]:
                toks.append(labels[chain_id[b, path[b, t]]])
        out.append(toks)
    return out
