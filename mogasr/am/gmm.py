"""Diagonal-covariance mixture-of-Gaussians acoustic model.

Scoring interface (SURVEY.md §1 L2a): ``score(features[T, D]) -> loglik[T, S]``
over all components and states (BASELINE.json: "the mixture-of-Gaussians
acoustic scorer (diagonal-covariance log-likelihood over all components and
states) runs as a batched Pallas matmul-style kernel").

The math is cast into GEMM form so a matrix unit does the work:

    loglik[t, s] = logsumexp_k( c[s,k] + x_t . b[s,k] + x_t^2 . a[s,k] )

with per-(state, component) precomputed
    a = -0.5 / var                     [S, K, D]
    b = mean / var                     [S, K, D]
    c = log w - 0.5 (D log 2pi + sum log var + sum mean^2/var)   [S, K]

so scoring is one [N, 2D] x [2D, S*K] GEMM plus a K-wise logsumexp epilogue.
This module holds the parameter pytree, a NumPy oracle, and the plain JAX
scorer (memory-chunked over states). The GPU kernel that fuses the epilogue
(never materializing [N, S*K] in device memory) and the system's one scorer
entry, ``score_frames``, live in mogasr.am.gmm_pallas.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mogasr.config import GmmConfig

LOG_2PI = float(np.log(2.0 * np.pi))
HIGHEST = jax.lax.Precision.HIGHEST


class GmmSet(NamedTuple):
    """Per-state GMM parameters as a JAX pytree.

    weights: [S, K] mixture weights (sum to 1 over K)
    means:   [S, K, D]
    vars:    [S, K, D] diagonal covariances
    """

    weights: jax.Array
    means: jax.Array
    vars: jax.Array

    @property
    def n_states(self) -> int:
        return self.weights.shape[0]

    @property
    def n_components(self) -> int:
        return self.weights.shape[1]

    @property
    def feat_dim(self) -> int:
        return self.means.shape[-1]


def init_gmm(
    cfg: GmmConfig,
    key: jax.Array,
    data_mean: Optional[np.ndarray] = None,
    data_var: Optional[np.ndarray] = None,
    n_states: Optional[int] = None,
    n_components: Optional[int] = None,
) -> GmmSet:
    """Random init around the data statistics (or standard normal)."""
    S = n_states if n_states is not None else cfg.n_states
    K = n_components if n_components is not None else cfg.n_components
    D = cfg.feat_dim
    mu0 = jnp.zeros(D) if data_mean is None else jnp.asarray(data_mean, jnp.float32)
    var0 = jnp.ones(D) if data_var is None else jnp.asarray(data_var, jnp.float32)
    means = mu0 + jax.random.normal(key, (S, K, D)) * jnp.sqrt(var0) * 0.5
    return GmmSet(
        weights=jnp.full((S, K), 1.0 / K, jnp.float32),
        means=means.astype(jnp.float32),
        vars=jnp.broadcast_to(var0, (S, K, D)).astype(jnp.float32),
    )


class NaturalParams(NamedTuple):
    """GEMM-ready natural parameters. ab: [2D, S*K] (a on top, b below); c: [S*K]."""

    ab: jax.Array
    c: jax.Array
    n_states: int
    n_components: int


def natural_params(gmm: GmmSet, var_floor: float = 1e-3) -> NaturalParams:
    S, K, D = gmm.means.shape
    v = jnp.maximum(gmm.vars, var_floor)
    a = -0.5 / v                                             # [S,K,D]
    b = gmm.means / v                                        # [S,K,D]
    c = (
        jnp.log(jnp.maximum(gmm.weights, 1e-30))
        - 0.5 * (D * LOG_2PI + jnp.sum(jnp.log(v), -1) + jnp.sum(gmm.means ** 2 / v, -1))
    )                                                        # [S,K]
    ab = jnp.concatenate(
        [a.transpose(2, 0, 1).reshape(D, S * K), b.transpose(2, 0, 1).reshape(D, S * K)],
        axis=0,
    )                                                        # [2D, S*K]
    return NaturalParams(ab=ab, c=c.reshape(S * K), n_states=S, n_components=K)


def quadratic_features(x: jax.Array) -> jax.Array:
    """[N, D] -> [N, 2D] with x^2 on the left to match NaturalParams.ab."""
    return jnp.concatenate([x * x, x], axis=-1)


def gmm_loglik(
    x: jax.Array,
    gmm: GmmSet,
    state_chunk: int = 128,
    precision=HIGHEST,
    mode: str = "sum",
    compute_dtype: str = "float32",
) -> jax.Array:
    """Pure-JAX scorer: [N, D] -> [N, S], chunked over states to bound memory.

    The plain reference, and the scorer on every platform but the GPU (see
    gmm_pallas.score_frames). Chunking keeps the [N, chunk*K] intermediate
    bounded instead of materializing [N, S*K] in device memory.

    mode="max" scores with the best component only (the classic Viterbi /
    max-approximation to the mixture: loglik ~ max_k log(w_k N_k)); it is a
    lower bound within log K nats of the exact value and skips the exp/log
    epilogue.

    compute_dtype="float16" rounds the product's operands to float16 and
    accumulates in float32 (the constant c is added in float32).
    """
    S, K, D = gmm.means.shape
    nat = natural_params(gmm)
    x2 = quadratic_features(x)  # [N, 2D]
    dt = jnp.dtype(compute_dtype)
    if dt != jnp.float32:
        x2 = x2.astype(dt)
        precision = None
    n_chunks = -(-S // state_chunk)
    S_pad = n_chunks * state_chunk
    ab = jnp.pad(nat.ab.reshape(2 * D, S, K), ((0, 0), (0, S_pad - S), (0, 0)))
    c = jnp.pad(nat.c.reshape(S, K), ((0, S_pad - S), (0, 0)))
    ab = ab.reshape(2 * D, n_chunks, state_chunk * K).transpose(1, 0, 2)
    c = c.reshape(n_chunks, state_chunk * K)

    def score_chunk(args):
        ab_c, c_c = args
        s = jnp.dot(x2, ab_c.astype(dt), precision=precision,
                    preferred_element_type=jnp.float32) + c_c[None, :]  # [N, chunk*K]
        s = s.reshape(x.shape[0], state_chunk, K)
        if mode == "max":
            return jnp.max(s, axis=-1)
        return jax.nn.logsumexp(s, axis=-1)

    out = jax.lax.map(score_chunk, (ab, c))  # [n_chunks, N, chunk]
    return out.transpose(1, 0, 2).reshape(x.shape[0], S_pad)[:, :S]


def gmm_loglik_np(x: np.ndarray, weights: np.ndarray, means: np.ndarray,
                  variances: np.ndarray, mode: str = "sum") -> np.ndarray:
    """NumPy float64 oracle.

    x: [N, D]; weights: [S, K]; means/variances: [S, K, D] -> [N, S] float64.
    mode="max" returns the best component's log-likelihood instead of the
    mixture's.
    """
    x = np.asarray(x, np.float64)
    w = np.asarray(weights, np.float64)
    mu = np.asarray(means, np.float64)
    var = np.asarray(variances, np.float64)
    S, K, D = mu.shape
    # log N(x; mu, var) summed over dims, per (n, s, k)
    diff = x[:, None, None, :] - mu[None, :, :, :]  # [N,S,K,D]
    ll = -0.5 * (D * LOG_2PI + np.log(var).sum(-1)[None] + (diff ** 2 / var[None]).sum(-1))
    ll = ll + np.log(np.maximum(w, 1e-30))[None]
    m = ll.max(axis=-1, keepdims=True)
    if mode == "max":
        return m[..., 0]
    return (m[..., 0] + np.log(np.exp(ll - m).sum(-1))).astype(np.float64)


def gmm_loglik_np_gemm(x: np.ndarray, weights: np.ndarray, means: np.ndarray, variances: np.ndarray) -> np.ndarray:
    """NumPy GEMM-form scorer — the *fast* CPU baseline (BLAS sgemm).

    Same math as gmm_loglik, float32. Used for CPU-baseline throughput
    measurement so the 50x claim compares against the best CPU formulation,
    not a naive loop.
    """
    x = np.asarray(x, np.float32)
    S, K, D = means.shape
    v = np.maximum(variances, 1e-3).astype(np.float32)
    mu = means.astype(np.float32)
    a = (-0.5 / v).transpose(2, 0, 1).reshape(D, S * K)
    b = (mu / v).transpose(2, 0, 1).reshape(D, S * K)
    c = (
        np.log(np.maximum(weights, 1e-30))
        - 0.5 * (D * LOG_2PI + np.log(v).sum(-1) + (mu ** 2 / v).sum(-1))
    ).reshape(S * K).astype(np.float32)
    x2 = np.concatenate([x * x, x], axis=1)  # [N, 2D]
    ab = np.concatenate([a, b], axis=0)      # [2D, S*K]
    scores = x2 @ ab + c[None, :]
    scores = scores.reshape(-1, S, K)
    m = scores.max(axis=-1)
    return m + np.log(np.exp(scores - m[..., None]).sum(-1))
