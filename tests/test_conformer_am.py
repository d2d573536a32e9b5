"""ConformerAm (4x-subsampled Conformer encoder, repeat-upsampled to the
frame rate): contract shape, padding invariance, and CTC learnability —
the matmul-friendly encoder option for the CTC/hybrid families."""

import numpy as np
import jax
import jax.numpy as jnp

from mogasr.am.neural import ConformerAm, build_model
from mogasr.config import TrainConfig


def _model(n_pdfs=4):
    return ConformerAm(n_pdfs=n_pdfs, hidden=32, layers=1, conv_kernel=7)


def test_build_model_conformer():
    cfg = TrainConfig(nn_hidden=64, nn_layers=2)
    m = build_model("conformer", 10, cfg)
    assert isinstance(m, ConformerAm) and m.n_pdfs == 10


def test_output_shape_any_length():
    m = _model()
    for T in (13, 16, 47):
        feats = jnp.zeros((2, T, 5))
        n = jnp.asarray([T, T - 3])
        params = m.init(jax.random.key(0), feats, n)
        out = m.apply(params, feats, n)
        assert out.shape == (2, T, 4), (T, out.shape)


def test_padding_invariance():
    m = _model()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 24, 5)).astype(np.float32)
    n = np.asarray([24, 15], np.int32)
    params = m.init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(n))
    out = np.asarray(m.apply(params, jnp.asarray(feats), jnp.asarray(n)))
    junk = feats.copy()
    junk[1, 15:] = 99.0
    out2 = np.asarray(m.apply(params, jnp.asarray(junk), jnp.asarray(n)))
    np.testing.assert_allclose(out[1, :15], out2[1, :15], atol=1e-5)


def test_conformer_ctc_learns_unit_task():
    from mogasr.am import ctc as C
    from tests.test_aed import _unit_task

    # B=8 / 4-unit rows: pure CTC on a transformer encoder needs a bit more
    # data than the AED's joint CTC/attention loss to escape the collapsed
    # optimum (the 4-utterance variant plateaus with dropped labels)
    feats, n_frames, labels, n_labels, seqs = _unit_task(B=8, units_T=4)
    # hidden 48 / 600 steps: under the fixed (1,1) subsample padding the
    # 32-hidden variant plateaus with one under-fit repeated-bigram row
    cfg = TrainConfig(nn_hidden=48, nn_layers=1, lr=2e-3, num_nn_steps=600)
    model = build_model("conformer", 4, cfg)  # 3 units + blank
    state = C.init_ctc_train_state(
        model, cfg, feats.shape[-1], jax.random.key(0)
    )
    step = C.make_ctc_train_step(model, cfg)
    first = None
    for _ in range(cfg.num_nn_steps):
        state, met = step(state, feats, n_frames, labels, n_labels)
        if first is None:
            first = float(met["loss"])
    assert float(met["loss"]) < first * 0.5, (first, float(met["loss"]))
    logits = model.apply(state.params, feats, n_frames)
    hyps = C.ctc_greedy_decode(
        jax.nn.log_softmax(logits, axis=-1), n_frames
    )
    assert hyps == seqs, (hyps, seqs)
