"""Fused diagonal-GMM scorer for NVIDIA GPUs (Pallas, Triton route).

The plain XLA scorer (``mogasr.am.gmm.gmm_loglik``) computes the
[N, 2D] x [2D, chunk*K] product for each 128-state chunk, writes the
[N, chunk*K] float32 scores to device memory and reads them back to reduce
over the K components. This kernel keeps those scores in registers: each
block owns a (frame tile, state tile) of the output and loops over the K
components inside the block, folding each component's [TM, TS] product into
a running max (``mode="max"``) or an online logsumexp (``mode="sum"``). Only
the [N, S] output is written.

Layout: the natural parameters are laid out component-major as
AB[K, R, S_pad] with R = 128 lanes: 2D quadratic-feature rows plus two rows
that carry the Gaussian constant c (scaled by 1/C_SCALE) split into a high
and a low part, matched by two C_SCALE-lanes in the frame operand. The
constant therefore rides in the product (the lanes are padding anyway) and
half-precision operands still recover c to about 20 mantissa bits.

Both grid axes are independent, so blocks run in any order. float32 inputs
take an IEEE fp32 product (no TF32). float16 inputs accumulate in float32;
they need |x| < 255 so that x^2 stays inside float16's range. float16 is the
half-precision type because its 10-bit mantissa keeps the scores within
0.25 nats of float32 on the headline model, where bfloat16 (7 bits) is off
by up to 2.2 nats (PERF.md).

``score_frames`` is the one scorer entry of the system: it runs this kernel
when the computation is lowered for a GPU and ``gmm_loglik`` everywhere
else, and wraps the call in ``shard_map`` when the frames are sharded over a
mesh (a ``pallas_call`` has no partitioning rule of its own).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mogasr.am.gmm import GmmSet, gmm_loglik, natural_params, quadratic_features

LANES = 128  # contraction width: 2D + 2 rounded up to a power of two
C_SCALE = 1024.0  # keeps c / C_SCALE inside float16's range
COMPUTE_DTYPES = ("float32", "float16")

# (block_m, block_s, num_warps, num_stages) per (compute dtype, mode).
# Chosen by the H100 sweep recorded in PERF.md.
BLOCKS = {
    ("float32", "sum"): (64, 64, 8, 3),
    ("float32", "max"): (64, 64, 8, 3),
    ("float16", "sum"): (64, 64, 4, 2),
    ("float16", "max"): (64, 64, 4, 3),
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _gmm_kernel(x_ref, ab_ref, out_ref, *, n_comp, n_rows, n_states, mode,
                precision):
    block_m, _ = x_ref.shape
    block_s = ab_ref.shape[-1]
    x = x_ref[...]

    def step(k, carry):
        m, s = carry
        sc = pl.dot(x, ab_ref[k], precision=precision)       # [TM, TS] f32
        if mode == "max":
            return jnp.maximum(m, sc), s
        # Online logsumexp with one exp per element: whichever of the running
        # max and the new score is larger contributes exp(0) = 1.
        d = sc - m
        e = jnp.exp(-jnp.abs(d))
        s = jnp.where(d > 0, s * e + 1.0, s + e)
        return jnp.maximum(m, sc), s

    m0 = jnp.full((block_m, block_s), -jnp.inf, jnp.float32)
    s0 = jnp.zeros((block_m, block_s), jnp.float32)
    m, s = jax.lax.fori_loop(0, n_comp, step, (m0, s0))
    out = m if mode == "max" else m + jnp.log(s)

    rows = pl.program_id(0) * block_m + jnp.arange(block_m)
    cols = pl.program_id(1) * block_s + jnp.arange(block_s)
    mask = (rows[:, None] < n_rows) & (cols[None, :] < n_states)
    plt.store(out_ref.at[pl.ds(pl.program_id(0) * block_m, block_m),
                         pl.ds(pl.program_id(1) * block_s, block_s)],
              out, mask=mask)


def kernel_operands(x: jax.Array, gmm: GmmSet, compute_dtype: str,
                    block_m: int, block_s: int):
    """Padded kernel operands: x2p [N_pad, LANES], ab [K, LANES, S_pad]."""
    S, K, D = gmm.means.shape
    if 2 * D + 2 > LANES:
        raise ValueError(f"feature dim {D} exceeds the kernel's {LANES} lanes")
    dt = jnp.dtype(compute_dtype)
    n = x.shape[0]
    n_pad = _round_up(max(n, 1), block_m)
    s_pad = _round_up(S, block_s)
    nat = natural_params(gmm)
    ab_t = nat.ab.reshape(2 * D, S, K).transpose(2, 0, 1)     # [K, 2D, S]
    c_t = nat.c.reshape(S, K).T                               # [K, S]
    c_t = c_t / C_SCALE
    c_hi = c_t.astype(dt)
    c_lo = (c_t - c_hi.astype(jnp.float32)).astype(dt)
    ab = jnp.zeros((K, LANES, s_pad), dt)
    ab = ab.at[:, : 2 * D, :S].set(ab_t.astype(dt))
    ab = ab.at[:, 2 * D, :S].set(c_hi)
    ab = ab.at[:, 2 * D + 1, :S].set(c_lo)
    x2p = jnp.zeros((n_pad, LANES), dt)
    x2p = x2p.at[:n, : 2 * D].set(quadratic_features(x).astype(dt))
    x2p = x2p.at[:n, 2 * D : 2 * D + 2].set(jnp.asarray(C_SCALE, dt))
    return x2p, ab


@functools.partial(
    jax.jit,
    static_argnames=("compute_dtype", "mode", "block_m", "block_s",
                     "num_warps", "num_stages", "interpret"),
)
def gmm_loglik_kernel(
    x: jax.Array,
    gmm: GmmSet,
    compute_dtype: str = "float32",
    mode: str = "sum",
    block_m: Optional[int] = None,
    block_s: Optional[int] = None,
    num_warps: Optional[int] = None,
    num_stages: Optional[int] = None,
    interpret: bool = False,
) -> jax.Array:
    """[N, D] x GmmSet -> [N, S] through the fused kernel.

    Compiles for the GPU unless ``interpret=True``, which runs the same
    kernel through the Pallas interpreter (for tests on a CPU)."""
    if mode not in ("sum", "max"):
        raise ValueError(f"mode must be 'sum' or 'max': {mode!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}: "
                         f"{compute_dtype!r}")
    bm, bs, nw, ns = BLOCKS[(compute_dtype, mode)]
    block_m, block_s = block_m or bm, block_s or bs
    S, K, _ = gmm.means.shape
    n = x.shape[0]
    x2p, ab = kernel_operands(x, gmm, compute_dtype, block_m, block_s)
    # HIGHEST lowers to an IEEE fp32 product; the half-precision product
    # accumulates in float32 either way.
    precision = jax.lax.Precision.HIGHEST if compute_dtype == "float32" else None
    kernel = functools.partial(
        _gmm_kernel, n_comp=K, n_rows=n, n_states=S, mode=mode,
        precision=precision)
    return pl.pallas_call(
        kernel,
        grid=(x2p.shape[0] // block_m, ab.shape[-1] // block_s),
        in_specs=[
            pl.BlockSpec((block_m, LANES), lambda i, j: (i, 0)),
            pl.BlockSpec((K, LANES, block_s), lambda i, j: (0, 0, j)),
        ],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((n, S), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps or nw, num_stages=num_stages or ns),
        interpret=interpret,
        name="gmm_loglik_kernel",
    )(x2p, ab)


def _score_rows(x2d, gmm, compute_dtype, mode, interpret):
    if interpret:
        return gmm_loglik_kernel(x2d, gmm, compute_dtype, mode, interpret=True)
    return jax.lax.platform_dependent(
        x2d, gmm,
        cuda=lambda a, g: gmm_loglik_kernel(a, g, compute_dtype, mode),
        default=lambda a, g: gmm_loglik(a, g, mode=mode,
                                        compute_dtype=compute_dtype),
    )


@functools.partial(jax.jit, static_argnames=("compute_dtype", "mode", "mesh",
                                             "interpret"))
def _score(feats, gmm, compute_dtype, mode, mesh, interpret):
    lead = feats.shape[:-1]

    def local(f, g):
        x2d = f.reshape(-1, f.shape[-1])
        out = _score_rows(x2d, g, compute_dtype, mode, interpret)
        return out.reshape(*f.shape[:-1], -1)

    if mesh is None:
        return local(feats, gmm)
    axis = mesh.axis_names[0]
    sharded = P(axis, *([None] * len(lead)))
    return jax.shard_map(
        local, mesh=mesh, in_specs=(sharded, P()), out_specs=sharded,
        check_vma=False)(feats, gmm)


def score_frames(
    feats: jax.Array,
    gmm: GmmSet,
    compute_dtype: str = "float32",
    mode: str = "sum",
    mesh: Optional[Mesh] = None,
    interpret: bool = False,
) -> jax.Array:
    """The system's GMM scorer: [..., D] -> [..., S] log-likelihoods.

    Lowered for a GPU it runs the fused kernel; on any other platform it
    runs ``gmm_loglik``. ``interpret=True`` runs the kernel through the
    Pallas interpreter instead (tests only). When the leading axis of
    ``feats`` is sharded over ``mesh`` (given, or read off a concrete
    array's ``NamedSharding``), the call runs per shard under ``shard_map``.
    """
    if mesh is None:
        sh = getattr(feats, "sharding", None)
        if (isinstance(sh, NamedSharding) and sh.mesh.size > 1
                and len(sh.spec) and sh.spec[0] is not None):
            mesh = sh.mesh
    if mesh is not None and mesh.size == 1:
        mesh = None
    return _score(feats, gmm, compute_dtype, mode, mesh, interpret)
