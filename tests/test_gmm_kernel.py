"""The fused GMM kernel (Pallas, Triton route) through the Pallas interpreter,
and the scorer entry around it: shapes, padding, block sizes, the choice of
scorer by platform, and the shard_map wrapper on the 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mogasr.am import gmm as G
from mogasr.am import gmm_pallas as GP
from mogasr.config import MeshConfig
from mogasr.dist import mesh as M

# (N, S, K, D): none a multiple of the blocks; K = 1; N = 1
SHAPES = [(23, 7, 5, 4), (129, 37, 8, 13), (70, 130, 1, 39), (1, 3, 2, 4)]
# float16 rounds the operands: its error grows with |x|^2 / var
TOL = {"float32": dict(atol=1e-4, rtol=1e-5), "float16": dict(atol=0.1, rtol=0)}


def _gmm(S, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return G.GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        jnp.asarray(rng.standard_normal((S, K, D)).astype(np.float32)),
        jnp.asarray((0.3 + rng.random((S, K, D))).astype(np.float32)),
    )


def _x(N, D, seed=1):
    return np.random.default_rng(seed).standard_normal((N, D)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_kernel_matches_oracle(shape, dtype, mode):
    N, S, K, D = shape
    g = _gmm(S, K, D)
    x = _x(N, D)
    ref = G.gmm_loglik_np(x, *map(np.asarray, g), mode=mode)
    got = np.asarray(GP.gmm_loglik_kernel(
        jnp.asarray(x), g, dtype, mode, block_m=16, block_s=16, interpret=True))
    assert got.shape == (N, S)
    np.testing.assert_allclose(got, ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_kernel_matches_plain_scorer_in_same_dtype(dtype):
    """Kernel and gmm_loglik round the same operands: they agree far inside
    the float16 rounding error itself."""
    g = _gmm(37, 8, 13)
    x = jnp.asarray(_x(129, 13))
    for mode in ("sum", "max"):
        got = np.asarray(GP.gmm_loglik_kernel(x, g, dtype, mode, block_m=32,
                                              block_s=16, interpret=True))
        ref = np.asarray(G.gmm_loglik(x, g, mode=mode, compute_dtype=dtype))
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_kernel_padding_rows_ignored(dtype):
    """Rows appended to the input leave the valid rows' scores unchanged."""
    g = _gmm(7, 5, 4)
    x = _x(23, 4)
    xp = np.concatenate([x, 50.0 * np.ones((9, 4), np.float32)])
    a = np.asarray(GP.gmm_loglik_kernel(jnp.asarray(x), g, dtype,
                                        block_m=16, block_s=16, interpret=True))
    b = np.asarray(GP.gmm_loglik_kernel(jnp.asarray(xp), g, dtype,
                                        block_m=16, block_s=16, interpret=True))
    np.testing.assert_array_equal(a, b[:23])


@pytest.mark.parametrize("blocks", [(16, 16), (32, 64), (64, 128)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_kernel_block_sizes_agree(blocks):
    """The tiling is invisible in the result."""
    g = _gmm(130, 3, 6)
    x = jnp.asarray(_x(70, 6))
    ref = np.asarray(GP.gmm_loglik_kernel(x, g, block_m=16, block_s=16,
                                          interpret=True))
    got = np.asarray(GP.gmm_loglik_kernel(x, g, block_m=blocks[0],
                                          block_s=blocks[1], interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)


def test_kernel_operands_layout():
    """Operands are padded to the blocks; the constant rides in two lanes."""
    g = _gmm(37, 8, 13)
    x = jnp.asarray(_x(50, 13))
    x2p, ab = GP.kernel_operands(x, g, "float32", 32, 16)
    assert x2p.shape == (64, GP.LANES) and ab.shape == (8, GP.LANES, 48)
    np.testing.assert_array_equal(np.asarray(x2p[50:]), 0.0)
    np.testing.assert_array_equal(np.asarray(x2p[:50, 26:28]), GP.C_SCALE)
    scores = jnp.einsum("nr,krs->nks", x2p, ab, precision="highest")
    ref = G.gmm_loglik_np(np.asarray(x), *map(np.asarray, g))
    got = jax.nn.logsumexp(scores, axis=1)[:50, :37]
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("kwargs", [dict(mode="mean"), dict(compute_dtype="int8")],
                         ids=["mode", "dtype"])
def test_kernel_rejects_unknown_options(kwargs):
    g = _gmm(7, 5, 4)
    with pytest.raises(ValueError):
        GP.gmm_loglik_kernel(jnp.asarray(_x(8, 4)), g, interpret=True, **kwargs)


@pytest.mark.parametrize("lead", [(23,), (2, 11), (2, 3, 4)], ids=str)
def test_score_frames_shapes(lead):
    """Any leading shape [..., D] -> [..., S], equal to the row-wise scorer."""
    g = _gmm(7, 5, 4)
    x = jnp.asarray(_x(int(np.prod(lead)), 4).reshape(*lead, 4))
    got = GP.score_frames(x, g, interpret=True)
    assert got.shape == (*lead, 7)
    ref = G.gmm_loglik_np(np.asarray(x).reshape(-1, 4), *map(np.asarray, g))
    np.testing.assert_allclose(np.asarray(got).reshape(-1, 7), ref,
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_score_frames_runs_plain_scorer_off_gpu(mode):
    """On the CPU the entry is gmm_loglik (up to XLA's fusion order)."""
    g = _gmm(37, 8, 13)
    x = jnp.asarray(_x(129, 13))
    got = np.asarray(GP.score_frames(x, g, mode=mode))
    ref = np.asarray(jax.jit(lambda a: G.gmm_loglik(a, g, mode=mode))(x))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_score_frames_lowers_the_compiled_kernel_for_gpu(dtype):
    """Lowered for CUDA, the entry is the Triton kernel: a compiled custom
    call, not the interpreter's loop."""
    g = _gmm(37, 8, 13)
    x = jnp.asarray(_x(129, 13))
    hlo = jax.jit(lambda a: GP.score_frames(a, g, dtype, "max")).trace(
        x).lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in hlo
    assert 'name = "gmm_loglik_kernel"' in hlo


def test_score_frames_never_interprets_unless_asked(monkeypatch):
    """Every kernel call the entry makes is compiled, unless the caller
    passes interpret=True."""
    calls = []
    real = GP.gmm_loglik_kernel

    def spy(*args, **kwargs):
        calls.append(kwargs.get("interpret", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(GP, "gmm_loglik_kernel", spy)
    g = _gmm(7, 5, 4)
    x = jnp.asarray(_x(12, 4))
    GP.score_frames(x, g, mode="max")           # traces the GPU branch too
    assert calls and not any(calls)
    calls.clear()
    GP.score_frames(x, g, mode="max", interpret=True)
    assert calls == [True]


@pytest.fixture(scope="module")
def mesh():
    return M.make_mesh(MeshConfig())


@pytest.mark.parametrize("how", ["explicit_mesh", "named_sharding"])
def test_sharded_scorer_matches_local(mesh, how):
    """Batch-sharded scoring over the 8-device mesh equals the local call."""
    g = _gmm(37, 4, 13)
    feats = jnp.asarray(_x(16 * 9, 13).reshape(16, 9, 13))
    local = np.asarray(GP.score_frames(feats, g))
    fs = jax.device_put(feats, M.data_sharding(mesh))
    if how == "explicit_mesh":
        got = jax.jit(lambda f: GP.score_frames(f, g, mesh=mesh))(fs)
    else:
        got = GP.score_frames(fs, g)
        assert isinstance(got.sharding, NamedSharding)
        assert got.sharding.spec[0] == "data"
    np.testing.assert_allclose(np.asarray(got), local, atol=1e-5, rtol=1e-6)


def test_sharded_kernel_matches_local(mesh):
    """The kernel itself (interpreted) under the shard_map wrapper."""
    g = _gmm(37, 4, 13)
    feats = jnp.asarray(_x(8 * 5, 13).reshape(8, 5, 13))
    local = np.asarray(GP.score_frames(feats, g, interpret=True))
    fs = jax.device_put(feats, NamedSharding(mesh, P("data")))
    got = np.asarray(GP.score_frames(fs, g, interpret=True))
    np.testing.assert_allclose(got, local, atol=1e-5, rtol=1e-6)


def test_replicated_input_scored_locally(mesh):
    """A replicated array on the mesh is scored without the shard_map
    wrapper and gives the local result."""
    g = _gmm(7, 5, 4)
    feats = jnp.asarray(_x(8, 4).reshape(2, 4, 4))
    got = GP.score_frames(jax.device_put(feats, M.replicated(mesh)), g)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(GP.score_frames(feats, g)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("mode", ["sum", "max"])
def test_compiled_kernel_on_gpu_matches_oracle(gpu, dtype, mode):
    """The kernel as compiled for the card (no interpreter), at the feature
    width of the system and awkward N and S."""
    g = _gmm(130, 16, 39)
    x = _x(1000, 39)
    ref = G.gmm_loglik_np(x, *map(np.asarray, g), mode=mode)
    got = np.asarray(GP.gmm_loglik_kernel(
        jax.device_put(jnp.asarray(x), gpu), jax.device_put(g, gpu), dtype, mode))
    np.testing.assert_allclose(got, ref, **TOL[dtype])
