"""EM training for the GMM acoustic model (Viterbi-style hard EM).

SURVEY.md §1 L4: the E-step takes component posteriors on frames assigned to
states by forced alignment (the standard GMM-HMM recipe at this scale); the
M-step is weighted stat accumulation -> new params with variance flooring and
occupancy-gated mixture splitting (SURVEY.md §7 hard-part #6).

Everything here is jitted masked batched reductions: per-frame component
posteriors via the same quadratic-form math as the scorer (restricted to each
frame's assigned state), then ``segment_sum`` scatter-adds into [S, K] stats.
Stats are a pytree, so data-parallel EM is one ``psum`` away (mogasr.dist).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mogasr.am.gmm import LOG_2PI, GmmSet
from mogasr.config import GmmConfig


class GmmStats(NamedTuple):
    """Sufficient statistics for the M-step. A pytree (psum-able over chips)."""

    occ: jax.Array   # [S, K] soft occupancy
    sx: jax.Array    # [S, K, D] weighted sum of x
    sxx: jax.Array   # [S, K, D] weighted sum of x^2
    loglik: jax.Array  # [] total data log-likelihood (monotonicity check)
    n_frames: jax.Array  # [] frames accumulated


def zero_stats(S: int, K: int, D: int) -> GmmStats:
    return GmmStats(
        occ=jnp.zeros((S, K)),
        sx=jnp.zeros((S, K, D)),
        sxx=jnp.zeros((S, K, D)),
        loglik=jnp.zeros(()),
        n_frames=jnp.zeros(()),
    )


def add_stats(a: GmmStats, b: GmmStats) -> GmmStats:
    return jax.tree.map(jnp.add, a, b)


@jax.jit
def accumulate_stats(
    gmm: GmmSet,
    feats: jax.Array,   # [N, D] frames (flattened batch)
    labels: jax.Array,  # [N] assigned pdf/state ids, -1 for padding
) -> GmmStats:
    """E-step: component posteriors on each frame's assigned state -> stats."""
    S, K, D = gmm.means.shape
    valid = labels >= 0
    safe = jnp.maximum(labels, 0)

    mu = gmm.means[safe]                      # [N, K, D]
    var = jnp.maximum(gmm.vars[safe], 1e-8)   # [N, K, D]
    w = jnp.maximum(gmm.weights[safe], 1e-30)  # [N, K]
    x = feats[:, None, :]                     # [N, 1, D]
    ll_k = (
        jnp.log(w)
        - 0.5 * (D * LOG_2PI + jnp.sum(jnp.log(var), -1))
        - 0.5 * jnp.sum((x - mu) ** 2 / var, -1)
    )                                         # [N, K]
    frame_ll = jax.nn.logsumexp(ll_k, axis=-1)           # [N]
    gamma = jnp.exp(ll_k - frame_ll[:, None])            # [N, K]
    gamma = jnp.where(valid[:, None], gamma, 0.0)

    seg = functools.partial(jax.ops.segment_sum, num_segments=S)
    occ = seg(gamma, safe)
    sx = seg(gamma[:, :, None] * feats[:, None, :], safe)
    sxx = seg(gamma[:, :, None] * feats[:, None, :] ** 2, safe)
    total_ll = jnp.sum(jnp.where(valid, frame_ll, 0.0))
    return GmmStats(occ, sx, sxx, total_ll, jnp.sum(valid))


@functools.partial(jax.jit, static_argnames=("state_chunk",))
def accumulate_stats_soft(
    gmm: GmmSet,
    feats: jax.Array,     # [N, D] frames (padding rows must carry 0 posterior)
    pdf_post: jax.Array,  # [N, S] state (pdf) posteriors, rows may sum to < 1
    state_chunk: int = 8,
) -> GmmStats:
    """Full Baum-Welch E-step: soft state posteriors x component posteriors.

    occ[s,k] = sum_n w[n,s] * gamma_k(n|s) etc. Memory is bounded by chunking
    states: the [N, chunk, K] component-posterior tensor is produced per chunk
    via the same GEMM-form math as the scorer (quadratic features x natural
    params), never the full [N, S, K].
    """
    from mogasr.am.gmm import natural_params, quadratic_features

    S, K, D = gmm.means.shape
    N = feats.shape[0]
    nat = natural_params(gmm)
    x2 = quadratic_features(feats)                 # [N, 2D]
    n_chunks = -(-S // state_chunk)
    S_pad = n_chunks * state_chunk
    ab = jnp.pad(nat.ab.reshape(2 * D, S, K), ((0, 0), (0, S_pad - S), (0, 0)))
    c = jnp.pad(nat.c.reshape(S, K), ((0, S_pad - S), (0, 0)))
    w = jnp.pad(pdf_post, ((0, 0), (0, S_pad - S)))  # [N, S_pad]
    ab = ab.reshape(2 * D, n_chunks, state_chunk, K).transpose(1, 0, 2, 3)
    c = c.reshape(n_chunks, state_chunk, K)
    w = w.reshape(N, n_chunks, state_chunk).transpose(1, 0, 2)  # [nc, N, C]

    def chunk_stats(args):
        ab_c, c_c, w_c = args  # [2D, C, K], [C, K], [N, C]
        ll = (
            jnp.einsum("nd,dck->nck", x2, ab_c) + c_c[None]
        )                                           # [N, C, K]
        gamma = jax.nn.softmax(ll, axis=-1)         # component posteriors
        wg = gamma * w_c[:, :, None]                # [N, C, K]
        occ = jnp.sum(wg, axis=0)                   # [C, K]
        sx = jnp.einsum("nck,nd->ckd", wg, feats)
        sxx = jnp.einsum("nck,nd->ckd", wg, feats ** 2)
        return occ, sx, sxx

    occ, sx, sxx = jax.lax.map(chunk_stats, (ab, c, w))
    return GmmStats(
        occ=occ.reshape(S_pad, K)[:S],
        sx=sx.reshape(S_pad, K, D)[:S],
        sxx=sxx.reshape(S_pad, K, D)[:S],
        loglik=jnp.zeros(()),  # total loglik comes from the forward pass
        n_frames=jnp.sum(pdf_post),
    )


@functools.partial(jax.jit, static_argnames=("var_floor", "weight_floor", "min_occ"))
def m_step(
    gmm: GmmSet,
    stats: GmmStats,
    var_floor: float = 1e-3,
    weight_floor: float = 1e-5,
    min_occ: float = 1e-2,
) -> GmmSet:
    """M-step: re-estimate (w, mu, var) from stats.

    Components with occupancy below min_occ keep their old parameters (their
    weight decays toward the floor) — the occupancy-threshold guard.
    """
    occ = stats.occ                          # [S, K]
    denom = jnp.maximum(occ[:, :, None], 1e-10)
    mu_new = stats.sx / denom
    var_new = stats.sxx / denom - mu_new ** 2
    keep = occ[:, :, None] < min_occ
    mu = jnp.where(keep, gmm.means, mu_new)
    var = jnp.where(keep, gmm.vars, jnp.maximum(var_new, var_floor))
    state_occ = jnp.maximum(jnp.sum(occ, -1, keepdims=True), 1e-10)
    # Exactly-zero prior weights mark inert duplicate slots created by an
    # occupancy-gated split: they must stay 0 (not get floored to life, and
    # not kept alive by the 1e-30 log-weight clamp's e-30-scale posteriors).
    raw = occ / state_occ
    w = jnp.where(
        gmm.weights > 0.0,
        jnp.maximum(raw, weight_floor),
        jnp.where(raw >= weight_floor, raw, 0.0),
    )
    w = w / jnp.maximum(jnp.sum(w, -1, keepdims=True), 1e-10)
    return GmmSet(w.astype(jnp.float32), mu.astype(jnp.float32), var.astype(jnp.float32))


def split_components(
    gmm: GmmSet,
    perturb: float = 0.2,
    seed: int = 0,
    state_occ=None,
    min_frames_per_comp: float = 0.0,
) -> GmmSet:
    """Double the number of components by splitting each along its std dev.

    Mixture-splitting schedule (SURVEY.md §2 EM trainer row): each component
    becomes two at mu +/- perturb * sigma with half the weight. Deterministic
    (the split direction is the per-dim std axis); `seed` is kept for API
    stability.

    Occupancy-gated allocation (round-2): when `state_occ` ([S] frame counts
    from the previous E-step) is given, a state is split only if after
    doubling each of its components would still average at least
    `min_frames_per_comp` frames — the static-shape stand-in for Kaldi's
    occupancy-proportional Gaussian allocation.  Gated-out states keep their
    existing components; their duplicate slots get weight 0 (log-weight -inf:
    inert under both scoring and EM until the state earns enough occupancy,
    at which point a later split activates them).  The dense [S, K] layout is
    unchanged, so the Pallas scorer needs no ragged support.
    """
    del seed
    sigma = jnp.sqrt(jnp.maximum(gmm.vars, 1e-8))
    lo = gmm.means - perturb * sigma
    hi = gmm.means + perturb * sigma
    means = jnp.concatenate([gmm.means, hi], axis=1)
    means_split = jnp.concatenate([lo, hi], axis=1)
    variances = jnp.concatenate([gmm.vars, gmm.vars], axis=1)
    weights_split = jnp.concatenate([gmm.weights, gmm.weights], axis=1) * 0.5
    weights_keep = jnp.concatenate(
        [gmm.weights, jnp.zeros_like(gmm.weights)], axis=1
    )
    if state_occ is None or min_frames_per_comp <= 0.0:
        return GmmSet(weights_split, means_split, variances)
    k_new = 2 * gmm.n_components
    do_split = (jnp.asarray(state_occ) / k_new >= min_frames_per_comp)[:, None]
    weights = jnp.where(do_split, weights_split, weights_keep)
    means = jnp.where(do_split[:, :, None], means_split, means)
    return GmmSet(weights, means, variances)


def init_from_labels(
    feats: np.ndarray, labels: np.ndarray, n_states: int, var_floor: float = 1e-3
) -> GmmSet:
    """Single-component-per-state init from labeled frames (flat start).

    States with no frames fall back to the global mean/var.
    """
    feats = np.asarray(feats, np.float64)
    labels = np.asarray(labels)
    D = feats.shape[1]
    valid = labels >= 0
    g_mean = feats[valid].mean(0)
    g_var = np.maximum(feats[valid].var(0), var_floor)
    means = np.tile(g_mean, (n_states, 1))
    variances = np.tile(g_var, (n_states, 1))
    for s in range(n_states):
        sel = labels == s
        n = sel.sum()
        if n >= 2:
            means[s] = feats[sel].mean(0)
            variances[s] = np.maximum(feats[sel].var(0), var_floor)
        elif n == 1:
            means[s] = feats[sel][0]
    return GmmSet(
        weights=jnp.ones((n_states, 1), jnp.float32),
        means=jnp.asarray(means[:, None, :], jnp.float32),
        vars=jnp.asarray(variances[:, None, :], jnp.float32),
    )


def uniform_alignment_labels(
    graph_emit_ids: np.ndarray, n_states_used: int, n_frames: int
) -> np.ndarray:
    """Equal-duration flat-start alignment of a linear graph over n_frames."""
    j = np.minimum(
        (np.arange(n_frames) * n_states_used) // max(n_frames, 1), n_states_used - 1
    )
    return graph_emit_ids[j]


def estimate_transitions(
    paths: np.ndarray,        # [B, T] graph-state indices, -1 padding
    pdf_ids: np.ndarray,      # [B, T] pdf per frame, -1 padding
    pdf_to_phone: np.ndarray,  # [n_pdfs]
    n_phones: int,
    prior_count: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-phone self-loop probability from alignment paths.

    Returns (self_prob[n_phones], counts[n_phones]).
    """
    stays = np.zeros(n_phones)
    moves = np.zeros(n_phones)
    B, T = paths.shape
    for b in range(B):
        for t in range(1, T):
            if paths[b, t] < 0:
                break
            ph = pdf_to_phone[pdf_ids[b, t - 1]]
            if paths[b, t] == paths[b, t - 1]:
                stays[ph] += 1
            else:
                moves[ph] += 1
    total = stays + moves + 2 * prior_count
    return (stays + prior_count) / total, total


@functools.partial(jax.jit, static_argnames=("tau", "var_floor", "adapt_vars"))
def m_step_map(
    prior: GmmSet,
    stats: GmmStats,
    tau: float = 10.0,
    var_floor: float = 1e-3,
    adapt_vars: bool = False,
) -> GmmSet:
    """MAP (maximum a posteriori) adaptation: interpolate the speaker-
    independent prior with adaptation-data statistics (Gauvain & Lee).

        mu_map = (tau * mu0 + sum_x) / (tau + occ)

    Components with little adaptation data stay near the prior (relevance
    smoothing); weights/vars stay at the prior unless adapt_vars is set.
    The same accumulate_stats / accumulate_stats_soft E-step supplies stats.
    """
    occ = stats.occ[:, :, None]                     # [S, K, 1]
    mu = (tau * prior.means + stats.sx) / (tau + occ)
    if adapt_vars:
        # E[x^2] blended the same way, recentered on the new mean
        ex2 = (tau * (prior.vars + prior.means ** 2) + stats.sxx) / (tau + occ)
        var = jnp.maximum(ex2 - mu ** 2, var_floor)
    else:
        var = prior.vars
    return GmmSet(prior.weights, mu.astype(jnp.float32), var.astype(jnp.float32))
