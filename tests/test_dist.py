"""Multi-chip tests on the faked 8-device CPU mesh (SURVEY.md §4):
shard_map-free sharded steps must be bit-identical to single-device."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mogasr.am import em
from mogasr.am.gmm import GmmSet
from mogasr.config import MeshConfig, TrainConfig, TopologyConfig
from mogasr.dist import mesh as M
from mogasr.dist.sharded import (
    make_sharded_align_step,
    make_sharded_em_step,
    make_sharded_stats_step,
    make_sharded_train_step,
)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8, "conftest should fake 8 CPU devices"
    return M.make_mesh(MeshConfig())


def test_mesh_shape(mesh):
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ("data",)


def test_sharded_em_matches_local(mesh, rng):
    S, K, D, N = 5, 2, 3, 64
    g = GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        jnp.asarray(rng.standard_normal((S, K, D)).astype(np.float32)),
        jnp.asarray((0.5 + rng.random((S, K, D))).astype(np.float32)),
    )
    feats = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, S, N).astype(np.int64)
    labels[-5:] = -1

    local = em.accumulate_stats(g, jnp.asarray(feats), jnp.asarray(labels))
    step = make_sharded_em_step(mesh)
    gr = M.replicate(g, mesh)
    fs, ls = M.shard_batch((feats, labels), mesh)
    dist = step(gr, fs, ls)
    np.testing.assert_allclose(np.asarray(dist.occ), np.asarray(local.occ), atol=1e-5)
    np.testing.assert_allclose(np.asarray(dist.sx), np.asarray(local.sx), atol=1e-5)
    np.testing.assert_allclose(float(dist.loglik), float(local.loglik), rtol=1e-6)


def test_sharded_adaptation_stats_match_local(mesh, rng):
    """fMLLR and MLLR sufficient statistics accumulated over the 8-device
    mesh equal the single-device result (the speaker-adaptation allreduce)."""
    from mogasr.am.fmllr import accumulate_fmllr_stats
    from mogasr.am.mllr import accumulate_mllr_stats

    S, K, D, N = 5, 2, 3, 64
    g = GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=S).astype(np.float32)),
        jnp.asarray(rng.standard_normal((S, K, D)).astype(np.float32)),
        jnp.asarray((0.5 + rng.random((S, K, D))).astype(np.float32)),
    )
    feats = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, S, N).astype(np.int64)
    labels[-3:] = -1
    gr = M.replicate(g, mesh)
    fs, ls = M.shard_batch((feats, labels), mesh)
    for acc in (accumulate_fmllr_stats, accumulate_mllr_stats):
        local = acc(g, jnp.asarray(feats), jnp.asarray(labels))
        dist = make_sharded_stats_step(mesh, acc)(gr, fs, ls)
        for l, d in zip(jax.tree.leaves(local), jax.tree.leaves(dist)):
            scale = max(float(np.abs(np.asarray(l)).max()), 1.0)
            np.testing.assert_allclose(
                np.asarray(d), np.asarray(l), atol=1e-5 * scale
            )


def test_sharded_align_matches_local(mesh, rng):
    from mogasr.hmm import graph as gr_mod
    from mogasr.hmm.lexicon import make_lexicon
    from mogasr.hmm.topology import build_topology
    from mogasr.decoder import viterbi as vit

    lex = make_lexicon({"ab": ["a", "b"]})
    topo = build_topology(lex, TopologyConfig(states_per_phone=1, sil_states=1))
    B, T = 8, 12
    g = gr_mod.align_graph(topo, lex.words_to_phone_ids(["ab"]))
    graphs_np = gr_mod.batch_graphs([g] * B)
    feats = rng.standard_normal((B, T, 4)).astype(np.float32)
    gmm = GmmSet(
        jnp.ones((topo.n_pdfs, 1)),
        jnp.asarray(rng.standard_normal((topo.n_pdfs, 1, 4)).astype(np.float32)),
        jnp.ones((topo.n_pdfs, 1, 4)),
    )
    n_frames = np.full(B, T, np.int32)

    from mogasr.am.gmm import gmm_loglik

    ll = gmm_loglik(jnp.asarray(feats.reshape(-1, 4)), gmm).reshape(B, T, -1)
    local = vit.viterbi(ll, {k: jnp.asarray(v) for k, v in graphs_np.items()}, jnp.asarray(n_frames))

    step = make_sharded_align_step(mesh)
    gmm_r = M.replicate(gmm, mesh)
    feats_s, nf_s = M.shard_batch((feats, n_frames), mesh)
    graphs_s = M.shard_batch({k: v for k, v in graphs_np.items()}, mesh)
    dist = step(gmm_r, feats_s, nf_s, graphs_s)
    np.testing.assert_allclose(np.asarray(dist.score), np.asarray(local.score), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(dist.path), np.asarray(local.path))


def test_sharded_train_step_matches_local(mesh, rng):
    from mogasr.am.neural import build_model
    from mogasr.am.train_nn import init_train_state, make_train_step

    cfg = TrainConfig(nn_hidden=16, nn_layers=1, nn_context=1, lr=1e-2, num_nn_steps=10)
    model = build_model("mlp", 4, cfg)
    state = init_train_state(model, cfg, 5, jax.random.key(0))
    feats = rng.standard_normal((8, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 4, (8, 6)).astype(np.int64)
    n_frames = np.full(8, 6, np.int32)

    local_step = make_train_step(model, cfg)
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames), jnp.asarray(labels)
    )

    dist_step = make_sharded_train_step(model, cfg, mesh)
    state_r = M.replicate(state, mesh)
    fs, nfs, ls = M.shard_batch((feats, n_frames, labels), mesh)
    s_dist, m_dist = dist_step(state_r, fs, nfs, ls)
    np.testing.assert_allclose(float(m_dist["loss"]), float(m_local["loss"]), rtol=1e-5)
    # parameters after one step agree
    flat_l = jax.tree.leaves(s_local.params)
    flat_d = jax.tree.leaves(s_dist.params)
    for a, b in zip(flat_l, flat_d):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_sharded_ctc_train_step_matches_local(mesh, rng):
    from mogasr.am import ctc as C
    from mogasr.am.neural import build_model
    from mogasr.dist.sharded import make_sharded_ctc_train_step

    cfg = TrainConfig(nn_hidden=16, nn_layers=1, nn_context=1, lr=1e-2, num_nn_steps=10)
    V = 4
    model = build_model("mlp", V, cfg)
    state = C.init_ctc_train_state(model, cfg, 5, jax.random.key(0))
    feats = rng.standard_normal((8, 10, 5)).astype(np.float32)
    n_frames = np.full(8, 10, np.int32)
    labels = rng.integers(0, V - 1, (8, 3)).astype(np.int32)
    n_labels = np.full(8, 3, np.int32)

    local_step = C.make_ctc_train_step(model, cfg)
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames),
        jnp.asarray(labels), jnp.asarray(n_labels),
    )
    dist_step = make_sharded_ctc_train_step(model, cfg, mesh)
    state_r = M.replicate(state, mesh)
    fs, nfs, ls, nls = M.shard_batch((feats, n_frames, labels, n_labels), mesh)
    s_dist, m_dist = dist_step(state_r, fs, nfs, ls, nls)
    np.testing.assert_allclose(float(m_dist["loss"]), float(m_local["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s_local.params), jax.tree.leaves(s_dist.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_sharded_distill_train_step_matches_local(mesh, rng):
    from mogasr.am import ctc as C
    from mogasr.am.distill import make_distill_train_step
    from mogasr.am.neural import build_model
    from mogasr.dist.sharded import make_sharded_distill_train_step

    cfg = TrainConfig(nn_hidden=16, nn_layers=1, nn_context=1, lr=1e-2,
                      num_nn_steps=10)
    V = 4
    teacher = build_model("mlp", V, cfg)
    t_params = teacher.init(jax.random.key(7),
                            jnp.zeros((2, 8, 5)), jnp.asarray([8, 8]))
    student = build_model("mlp", V, cfg)
    state = C.init_ctc_train_state(student, cfg, 5, jax.random.key(0))
    feats = rng.standard_normal((8, 10, 5)).astype(np.float32)
    n_frames = np.full(8, 10, np.int32)
    labels = rng.integers(0, V - 1, (8, 3)).astype(np.int32)
    n_labels = np.full(8, 3, np.int32)

    local_step = make_distill_train_step(
        student, teacher, t_params, cfg, alpha=0.6, temperature=2.0
    )
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames),
        jnp.asarray(labels), jnp.asarray(n_labels),
    )
    dist_step = make_sharded_distill_train_step(
        student, teacher, M.replicate(t_params, mesh), cfg, mesh,
        alpha=0.6, temperature=2.0,
    )
    state_r = M.replicate(state, mesh)
    fs, nfs, ls, nls = M.shard_batch((feats, n_frames, labels, n_labels), mesh)
    s_dist, m_dist = dist_step(state_r, fs, nfs, ls, nls)
    for key in ("loss", "kl", "ctc"):
        np.testing.assert_allclose(float(m_dist[key]), float(m_local[key]),
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(s_local.params), jax.tree.leaves(s_dist.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_sharded_mpc_step_matches_local(mesh, rng):
    from mogasr.am import pretrain as P
    from mogasr.am.neural import build_model
    from mogasr.dist.sharded import make_sharded_mpc_step

    cfg = TrainConfig(nn_hidden=16, nn_layers=1, nn_context=1, lr=1e-2,
                      num_nn_steps=10)
    model = build_model("mlp", 5, cfg)  # feat_dim-wide reconstruction head
    state = P.init_mpc_state(model, cfg, 5, jax.random.key(0))
    feats = rng.standard_normal((8, 10, 5)).astype(np.float32)
    n_frames = np.full(8, 10, np.int32)

    local_step = P.make_mpc_train_step(model, cfg)
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames))
    dist_step = make_sharded_mpc_step(model, cfg, mesh)
    s_dist, m_dist = dist_step(
        M.replicate(state, mesh), *M.shard_batch((feats, n_frames), mesh))
    np.testing.assert_allclose(float(m_dist["loss"]), float(m_local["loss"]),
                               rtol=1e-5)
    assert int(m_dist["masked_frames"]) == int(m_local["masked_frames"])
    for a, b in zip(jax.tree.leaves(s_local.params),
                    jax.tree.leaves(s_dist.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_sharded_rnnt_train_step_matches_local(mesh, rng):
    from mogasr.am import rnnt as R
    from mogasr.dist.sharded import make_sharded_rnnt_train_step

    cfg = TrainConfig(lr=1e-2, num_nn_steps=10)
    model = R.RnntModel(n_labels=3, enc_hidden=16, enc_layers=1,
                        pred_hidden=8, joint_hidden=8)
    state = R.init_rnnt_train_state(model, cfg, 5, 3, jax.random.key(0))
    feats = rng.standard_normal((8, 10, 5)).astype(np.float32)
    n_frames = np.full(8, 10, np.int32)
    labels = rng.integers(0, 3, (8, 3)).astype(np.int32)
    n_labels = np.full(8, 3, np.int32)

    local_step = R.make_rnnt_train_step(model, cfg)
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames),
        jnp.asarray(labels), jnp.asarray(n_labels),
    )
    dist_step = make_sharded_rnnt_train_step(model, cfg, mesh)
    state_r = M.replicate(state, mesh)
    fs, nfs, ls, nls = M.shard_batch((feats, n_frames, labels, n_labels), mesh)
    s_dist, m_dist = dist_step(state_r, fs, nfs, ls, nls)
    np.testing.assert_allclose(float(m_dist["loss"]), float(m_local["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s_local.params), jax.tree.leaves(s_dist.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_sharded_nn_mmi_step_matches_local(mesh, rng):
    from mogasr import pipeline as pipe
    from mogasr.am.neural import build_model
    from mogasr.am.nn_seq import make_nn_mmi_step
    from mogasr.am.train_nn import init_train_state
    from mogasr.config import DecodeConfig
    from mogasr.dist.sharded import make_sharded_nn_mmi_step
    from mogasr.hmm import graph as gr
    from mogasr.hmm.lexicon import synthetic_lexicon
    from mogasr.hmm.topology import build_topology

    lex = synthetic_lexicon()
    topo = build_topology(lex, TopologyConfig())
    cfg = TrainConfig(nn_arch="mlp", nn_hidden=16, nn_layers=1,
                      nn_context=1, lr=1e-2)
    model = build_model("mlp", topo.n_pdfs, cfg)
    B, T, D = 8, 40, 5
    state = init_train_state(model, cfg, D, jax.random.key(0))
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    n_frames = np.full(B, T, np.int32)
    words = [[lex.words[b % len(lex.words)]] for b in range(B)]
    num_g = {k: jnp.asarray(v)
             for k, v in pipe.build_align_graphs(words, lex, topo).items()}
    den_graph = pipe.word_decode_graph(lex, topo, DecodeConfig())
    den_g = {k: jnp.asarray(v)
             for k, v in gr.batch_graphs([den_graph] * B).items()}
    log_priors = jnp.zeros(topo.n_pdfs)

    local_step = make_nn_mmi_step(model, cfg, log_priors)
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames), num_g, den_g)

    dist_step = make_sharded_nn_mmi_step(model, cfg, mesh, log_priors)
    state_r = M.replicate(state, mesh)
    fs, nfs = M.shard_batch((feats, n_frames), mesh)
    dsh = M.data_sharding(mesh)
    num_s = {k: jax.device_put(v, dsh) for k, v in num_g.items()}
    den_s = {k: jax.device_put(v, dsh) for k, v in den_g.items()}
    s_dist, m_dist = dist_step(state_r, fs, nfs, num_s, den_s)
    np.testing.assert_allclose(float(m_dist["loss"]), float(m_local["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s_local.params),
                    jax.tree.leaves(s_dist.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_sharded_rnnt_pruned_train_step_matches_local(mesh, rng):
    from mogasr.am import rnnt as R
    from mogasr.am.rnnt_pruned import make_rnnt_pruned_train_step
    from mogasr.dist.sharded import make_sharded_rnnt_pruned_train_step

    cfg = TrainConfig(lr=1e-2, num_nn_steps=10)
    model = R.RnntModel(n_labels=3, enc_hidden=16, enc_layers=1,
                        pred_hidden=8, joint_hidden=8, simple_heads=True)
    state = R.init_rnnt_train_state(model, cfg, 5, 3, jax.random.key(0))
    feats = rng.standard_normal((8, 10, 5)).astype(np.float32)
    n_frames = np.full(8, 10, np.int32)
    labels = rng.integers(0, 3, (8, 3)).astype(np.int32)
    n_labels = np.full(8, 3, np.int32)

    local_step = make_rnnt_pruned_train_step(model, cfg, band=2)
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames),
        jnp.asarray(labels), jnp.asarray(n_labels),
    )
    dist_step = make_sharded_rnnt_pruned_train_step(model, cfg, mesh, band=2)
    state_r = M.replicate(state, mesh)
    fs, nfs, ls, nls = M.shard_batch((feats, n_frames, labels, n_labels), mesh)
    s_dist, m_dist = dist_step(state_r, fs, nfs, ls, nls)
    np.testing.assert_allclose(float(m_dist["loss"]), float(m_local["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s_local.params), jax.tree.leaves(s_dist.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_sharded_aed_train_step_matches_local(mesh, rng):
    from mogasr.am import aed as A
    from mogasr.dist.sharded import make_sharded_aed_train_step

    cfg = TrainConfig(lr=1e-2, num_nn_steps=10, nn_hidden=16, nn_layers=1)
    model = A.build_aed_model(3, cfg)
    state = A.init_aed_train_state(model, cfg, 5, 3, jax.random.key(0))
    feats = rng.standard_normal((8, 16, 5)).astype(np.float32)
    n_frames = np.full(8, 16, np.int32)
    labels = rng.integers(0, 3, (8, 3)).astype(np.int32)
    n_labels = np.full(8, 3, np.int32)

    local_step = A.make_aed_train_step(model, cfg)
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames),
        jnp.asarray(labels), jnp.asarray(n_labels),
    )
    dist_step = make_sharded_aed_train_step(model, cfg, mesh)
    state_r = M.replicate(state, mesh)
    fs, nfs, ls, nls = M.shard_batch((feats, n_frames, labels, n_labels), mesh)
    s_dist, m_dist = dist_step(state_r, fs, nfs, ls, nls)
    np.testing.assert_allclose(float(m_dist["loss"]), float(m_local["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s_local.params), jax.tree.leaves(s_dist.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_sharded_aed_mwer_step_matches_local(mesh, rng):
    from mogasr.am import aed as A
    from mogasr.dist.sharded import make_sharded_aed_mwer_step

    cfg = TrainConfig(lr=1e-2, num_nn_steps=10, nn_hidden=16, nn_layers=1)
    model = A.build_aed_model(3, cfg)
    state = A.init_aed_train_state(model, cfg, 5, 3, jax.random.key(0))
    B, N, U = 8, 2, 4
    feats = rng.standard_normal((B, 16, 5)).astype(np.float32)
    n_frames = np.full(B, 16, np.int32)
    labels = rng.integers(0, 3, (B, 3)).astype(np.int32)
    n_labels = np.full(B, 3, np.int32)
    hyps = np.full((B, N, U), -1, np.int32)
    n_h = np.zeros((B, N), np.int32)
    for b in range(B):
        for n in range(N):
            k = 2 + (b + n) % 3
            hyps[b, n, :k] = rng.integers(0, 3, k)
            n_h[b, n] = k
    h_mask = np.ones((B, N), bool)
    h_mask[3, 1] = False  # one duplicate/empty slot
    risks = rng.random((B, N)).astype(np.float32)

    local_step = A.make_aed_mwer_step(model, cfg, ce_weight=0.1)
    s_local, m_local = local_step(
        state, jnp.asarray(feats), jnp.asarray(n_frames), jnp.asarray(hyps),
        jnp.asarray(n_h), jnp.asarray(h_mask), jnp.asarray(risks),
        jnp.asarray(labels), jnp.asarray(n_labels),
    )
    dist_step = make_sharded_aed_mwer_step(model, cfg, mesh, ce_weight=0.1)
    state_r = M.replicate(state, mesh)
    sharded = M.shard_batch(
        (feats, n_frames, hyps, n_h, h_mask, risks, labels, n_labels), mesh
    )
    s_dist, m_dist = dist_step(state_r, *sharded)
    np.testing.assert_allclose(
        float(m_dist["loss"]), float(m_local["loss"]), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        float(m_dist["expected_risk"]), float(m_local["expected_risk"]),
        rtol=1e-5,
    )
    for a, b in zip(jax.tree.leaves(s_local.params), jax.tree.leaves(s_dist.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_pad_to_multiple():
    a = np.arange(10)
    p, n = M.pad_to_multiple(a, 8)
    assert p.shape == (16,) and n == 10
    p2, n2 = M.pad_to_multiple(a, 5)
    assert p2.shape == (10,) and n2 == 10


def _toy_system(rng, B=8, T=12, D=4):
    """Shared fixture for the decode/soft-EM mesh tests."""
    from mogasr.hmm import graph as gr_mod
    from mogasr.hmm.lexicon import make_lexicon
    from mogasr.hmm.topology import build_topology

    lex = make_lexicon({"ab": ["a", "b"]})
    topo = build_topology(lex, TopologyConfig(states_per_phone=1, sil_states=1))
    g = gr_mod.align_graph(topo, lex.words_to_phone_ids(["ab"]))
    graphs_np = gr_mod.batch_graphs([g] * B)
    feats = rng.standard_normal((B, T, D)).astype(np.float32)
    K = 2
    gmm = GmmSet(
        jnp.asarray(rng.dirichlet(np.ones(K), size=topo.n_pdfs).astype(np.float32)),
        jnp.asarray(rng.standard_normal((topo.n_pdfs, K, D)).astype(np.float32)),
        jnp.asarray((0.5 + rng.random((topo.n_pdfs, K, D))).astype(np.float32)),
    )
    n_frames = np.full(B, T, np.int32)
    n_frames[-1] = T - 3  # ragged lengths must survive the sharding
    return gmm, feats, n_frames, graphs_np


def test_sharded_soft_em_matches_local(mesh, rng):
    """Baum-Welch stats accumulated over the mesh == single-device (the
    soft-EM counterpart of the hard-EM allreduce)."""
    from mogasr.am.gmm import gmm_loglik
    from mogasr.decoder import forward_backward as fbd
    from mogasr.dist.sharded import make_sharded_soft_em_step

    gmm, feats, n_frames, graphs_np = _toy_system(rng)
    B, T, D = feats.shape
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}

    ll = gmm_loglik(jnp.asarray(feats.reshape(-1, D)), gmm).reshape(B, T, -1)
    res = fbd.forward_backward(ll, graphs, jnp.asarray(n_frames))
    post = fbd.state_posteriors_to_pdf(
        res.log_gamma, graphs["emit_id"], gmm.means.shape[0])
    local = em.accumulate_stats_soft(
        gmm, jnp.asarray(feats.reshape(-1, D)),
        post.reshape(-1, gmm.means.shape[0]))
    local = local._replace(
        loglik=jnp.sum(jnp.where(jnp.asarray(n_frames) > 0, res.loglik, 0.0)))

    step = make_sharded_soft_em_step(mesh)
    dist = step(
        M.replicate(gmm, mesh),
        *M.shard_batch((feats, n_frames), mesh),
        M.shard_batch({k: v for k, v in graphs_np.items()}, mesh),
    )
    for name in ("occ", "sx", "sxx"):
        l, d = getattr(local, name), getattr(dist, name)
        np.testing.assert_allclose(np.asarray(d), np.asarray(l), atol=2e-5)
    np.testing.assert_allclose(float(dist.loglik), float(local.loglik), rtol=1e-5)

    # and the M-step on the distributed stats yields a usable model
    g2 = em.m_step(gmm, dist)
    assert np.isfinite(np.asarray(g2.means)).all()


def test_sharded_decode_matches_local(mesh, rng):
    """Sharded eval/decode step: per-chip paths equal local decode and the
    psum-ed frame/score totals equal the host-side sums."""
    from mogasr.am.gmm import gmm_loglik
    from mogasr.decoder import viterbi as vit
    from mogasr.dist.sharded import make_sharded_decode_step

    gmm, feats, n_frames, graphs_np = _toy_system(rng)
    B, T, D = feats.shape
    graphs = {k: jnp.asarray(v) for k, v in graphs_np.items()}

    ll = gmm_loglik(jnp.asarray(feats.reshape(-1, D)), gmm).reshape(B, T, -1)
    local = vit.viterbi(ll, graphs, jnp.asarray(n_frames))

    step = make_sharded_decode_step(mesh)
    res, totals = step(
        M.replicate(gmm, mesh),
        *M.shard_batch((feats, n_frames), mesh),
        M.shard_batch({k: v for k, v in graphs_np.items()}, mesh),
    )
    np.testing.assert_array_equal(np.asarray(res.path), np.asarray(local.path))
    np.testing.assert_allclose(
        np.asarray(res.score), np.asarray(local.score), atol=1e-4)
    assert int(totals["frames"]) == int(n_frames.sum())
    np.testing.assert_allclose(
        float(totals["score"]), float(np.asarray(local.score).sum()), rtol=1e-5)
