"""MPC self-supervised pretraining (mogasr.am.pretrain): mask sampling
respects padding, the reconstruction loss learns, trunk-parameter transfer
is exact (head skipped by shape), fine-tuning from the pretrained trunk is
stable and measurably warm, and the CLI chain pretrain -> finetune ->
decode runs."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mogasr.am import pretrain as P
from mogasr.config import TrainConfig


def test_span_mask_respects_padding_and_is_deterministic():
    key = jax.random.key(0)
    n_frames = jnp.asarray([20, 7, 1])
    m1 = np.asarray(P.span_time_mask(key, n_frames, 24, n_masks=3, width=6))
    m2 = np.asarray(P.span_time_mask(key, n_frames, 24, n_masks=3, width=6))
    np.testing.assert_array_equal(m1, m2)
    for b, nf in enumerate([20, 7, 1]):
        assert not m1[b, nf:].any(), "mask leaked into padding"
    assert m1.any(), "nothing masked at all"


def test_mpc_objective_scores_masked_positions_only():
    """Junk in UNMASKED positions of the prediction target can't leak:
    perturbing input frames outside the mask changes the loss only through
    the network; with an identity 'model' the loss is exactly the masked
    MSE of the zeroing itself."""
    feats = jnp.asarray(np.random.default_rng(0).standard_normal((2, 6, 3)),
                        jnp.float32)
    n_frames = jnp.asarray([6, 4])
    mask = jnp.asarray([[True, False, False, False, False, False],
                        [False, True, False, False, False, False]])

    class Identity:
        def apply(self, params, x, n):
            return x

    loss, n = P.mpc_objective(Identity(), None, feats, n_frames, mask)
    # identity on the zeroed input predicts 0 at masked spots -> MSE of feats
    expect = float((jnp.sum(feats[0, 0] ** 2) + jnp.sum(feats[1, 1] ** 2))
                   / (2 * 3))
    np.testing.assert_allclose(float(loss), expect, rtol=1e-6)
    assert int(n) == 2


def test_transfer_copies_trunk_exactly_and_skips_head():
    from mogasr.am.ctc import init_ctc_train_state
    from mogasr.am.neural import build_model

    cfg = TrainConfig(nn_arch="mlp", nn_hidden=16, nn_layers=2, nn_context=1,
                      num_nn_steps=1)
    D, V = 5, 9
    pre_model = build_model("mlp", D, cfg)    # reconstruction head: D wide
    pre_params = pre_model.init(jax.random.key(1),
                                jnp.zeros((2, 8, D)), jnp.asarray([8, 8]))
    tgt = init_ctc_train_state(build_model("mlp", V + 1, cfg), cfg, D,
                               jax.random.key(2)).params

    merged, copied, total = P.transfer_pretrained(pre_params, tgt)
    # everything except the head Dense kernel+bias transfers
    assert copied == total - 2, (copied, total)
    flat_pre = dict(jax.tree_util.tree_flatten_with_path(pre_params)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(merged)[0]:
        src = flat_pre.get(path)
        tgt_leaf = dict(jax.tree_util.tree_flatten_with_path(tgt)[0])[path]
        if src is not None and src.shape == leaf.shape:
            np.testing.assert_array_equal(np.asarray(leaf), np.asarray(src))
        else:
            np.testing.assert_array_equal(np.asarray(leaf),
                                          np.asarray(tgt_leaf))


@pytest.fixture(scope="module")
def small_corpus():
    from mogasr import pipeline as pipe
    from mogasr.config import BatchConfig, FrontendConfig
    from mogasr.data.synthetic import LEXICON, make_corpus
    from mogasr.hmm.lexicon import make_lexicon

    vocab = ["fish", "cat", "see", "sun", "tree", "dog"]
    lex = make_lexicon({w: LEXICON[w] for w in vocab})
    utts = make_corpus(24, words_per_utt=(2, 3), seed=7, vocab=vocab)
    batches = pipe.featurize(
        [(u.utt_id, u.wave, u.words) for u in utts],
        FrontendConfig(), BatchConfig(batch_size=8, bucket_boundaries=(250, 400)),
    )
    return lex, batches


def test_mpc_pretraining_learns(small_corpus):
    _lex, batches = small_corpus
    cfg = TrainConfig(nn_arch="mlp", nn_hidden=64, nn_layers=2, nn_context=3,
                      lr=3e-3, num_nn_steps=120)
    model, params = P.pretrain_mpc(batches, cfg, arch="mlp")
    state0 = P.init_mpc_state(model, cfg, batches[0].feats.shape[-1],
                              jax.random.key(cfg.seed))

    key = jax.random.key(123)
    fb = batches[0]
    mask = P.span_time_mask(key, fb.n_frames, fb.feats.shape[1])
    l0, _ = P.mpc_objective(model, state0.params, fb.feats, fb.n_frames, mask)
    l1, _ = P.mpc_objective(model, params, fb.feats, fb.n_frames, mask)
    assert float(l1) < 0.5 * float(l0), (float(l0), float(l1))


def test_warm_start_trains_from_pretrained_trunk(small_corpus):
    """Fine-tuning from the MPC trunk must actually start FROM it (the
    warm init measurably changes the trajectory) and still learn the task.

    Honesty note: on this trivially separable synthetic corpus a warm
    start is NEUTRAL, not a win (measured): e.g.
    ft=30 steps cold 3.14 / warm 4.36, ft=60 cold 2.47 / warm 2.39 total
    CTC NLL on an 8-utt label budget. The capability under test is the
    mechanism — exact trunk transfer + stable fine-tuning — which is what
    transfers to corpora hard enough for representations to matter."""
    from mogasr import pipeline as pipe
    from mogasr.am.ctc import ctc_objective, ctc_labels_from_words, pack_label_batch

    lex, batches = small_corpus
    cfg = TrainConfig(nn_arch="mlp", nn_hidden=64, nn_layers=2, nn_context=3,
                      lr=3e-3, num_nn_steps=60)
    pre_cfg = TrainConfig(nn_arch="mlp", nn_hidden=64, nn_layers=2,
                          nn_context=3, lr=3e-3, num_nn_steps=150)
    _pre_model, pre_params = P.pretrain_mpc(batches, pre_cfg, arch="mlp")

    def ctc_loss_of(model, params):
        total = 0.0
        for fb in batches:
            seqs = [ctc_labels_from_words(lex, fb.words[b])
                    for b in range(fb.size)]
            rows = int(fb.feats.shape[0])
            seqs += [[] for _ in range(rows - fb.size)]
            labels, n_labels = pack_label_batch(seqs)
            loss, _ = ctc_objective(model, params, fb.feats, fb.n_frames,
                                    jnp.asarray(labels), jnp.asarray(n_labels))
            total += float(loss)
        return total

    model_w, params_w = pipe.train_ctc(
        batches, lex, cfg, arch="mlp", init_params=pre_params)
    model_c, params_c = pipe.train_ctc(batches, lex, cfg, arch="mlp")
    warm, cold = ctc_loss_of(model_w, params_w), ctc_loss_of(model_c, params_c)
    # both learn: an untrained model scores ~90 total over these 3 batches
    # (measured ~8-9 after 60 steps for either init)
    assert warm < 15.0 and cold < 15.0, (warm, cold)
    # ... and the warm start demonstrably started elsewhere
    diffs = [
        float(jnp.abs(a - b).max())
        for a, b in zip(jax.tree_util.tree_leaves(params_w),
                        jax.tree_util.tree_leaves(params_c))
    ]
    assert max(diffs) > 1e-3, "warm start did not change the trajectory"


def test_pretrain_cli_chain(tmp_path, monkeypatch):
    """CLI: train_nn --objective mpc (unsupervised) -> train_nn --objective
    ctc --init-from (warm start logged) -> decode --ctc."""
    from cli import decode, train_nn

    def run_cli(module, argv):
        monkeypatch.setattr(sys, "argv", ["prog"] + argv)
        module.main()

    run_cli(train_nn,
            ["--synthetic", "3", "--run-dir", str(tmp_path / "pre"),
             "--arch", "mlp", "--hidden", "16", "--layers", "2",
             "--steps", "6", "--objective", "mpc"])
    run_cli(train_nn,
            ["--synthetic", "3", "--run-dir", str(tmp_path / "ft"),
             "--arch", "mlp", "--hidden", "16", "--layers", "2",
             "--steps", "6", "--objective", "ctc",
             "--init-from", str(tmp_path / "pre" / "nn_mpc_mlp")])
    metrics = [json.loads(l) for l in open(tmp_path / "ft" / "metrics.jsonl")]
    warm = [m for m in metrics if m.get("stage") == "ctc_warm_start"]
    assert warm and warm[0]["leaves_copied"] > 0

    out = str(tmp_path / "hyp.jsonl")
    run_cli(decode,
            ["--synthetic", "2", "--run-dir", str(tmp_path / "dec"),
             "--am", "mlp", "--ctc",
             "--nn-ckpt", str(tmp_path / "ft" / "nn_ctc_mlp"),
             "--nn-hidden", "16", "--nn-layers", "2", "--out", out])
    recs = [json.loads(l) for l in open(out)]
    assert len(recs) == 2 and all("hyp" in r for r in recs)
