"""mogasr: a speech-recognition framework in JAX (GMM-HMM and neural models).

Built from scratch with the capabilities of the reference repo
taufikxu/MOG-ASR (see SURVEY.md): LibriSpeech audio front end, diagonal-GMM
and neural (MLP/LSTM) acoustic scorers, on-device Viterbi/beam decoding and
forced alignment, EM and SGD training, data-parallel evaluation over a mesh.

Public entry points mirror the reference's surface (BASELINE.json
north_star: "feature-extraction and scoring entry points"):

    mogasr.extract_features(wave, cfg)   -> [T, D] float32 features
    mogasr.gmm_loglik(x, gmm)            -> [N, S] log-likelihoods (plain XLA)
    mogasr.score_frames(feats, gmm)      -> [..., S] (the system's scorer:
                                            fused kernel on a GPU)
    mogasr.viterbi / mogasr.forward_backward
    mogasr.ctc_loss / mogasr.rnnt_loss / mogasr.train_bpe
    mogasr.aed_decode_batch (attention encoder-decoder beam search)
    mogasr.aed_stream_init / mogasr.make_aed_stream_step (streaming AED)
    mogasr.pipeline.{featurize, train_gmm, train_ctc, train_rnnt,
                     train_aed, evaluate, ...}
"""

__version__ = "0.1.0"

from mogasr.config import (  # noqa: F401
    BatchConfig,
    DecodeConfig,
    FrontendConfig,
    GmmConfig,
    MeshConfig,
    PipelineConfig,
    TopologyConfig,
    TrainConfig,
)


def __getattr__(name):  # lazy: keep `import mogasr` light, no jax at import
    if name == "extract_features":
        from mogasr.frontend.jax_frontend import extract_features

        return extract_features
    if name in ("GmmSet", "gmm_loglik", "init_gmm"):
        import mogasr.am.gmm as _g

        return getattr(_g, name)
    if name == "score_frames":
        from mogasr.am.gmm_pallas import score_frames

        return score_frames
    if name == "viterbi":
        from mogasr.decoder.viterbi import viterbi

        return viterbi
    if name == "forward_backward":
        from mogasr.decoder.forward_backward import forward_backward

        return forward_backward
    if name == "corpus_wer":
        from mogasr.eval.wer import corpus_wer

        return corpus_wer
    if name == "ctc_loss":
        from mogasr.am.ctc import ctc_loss

        return ctc_loss
    if name == "rnnt_loss":
        from mogasr.am.rnnt import rnnt_loss

        return rnnt_loss
    if name == "aed_decode_batch":
        from mogasr.am.aed import aed_decode_batch

        return aed_decode_batch
    if name == "aed_stream_init":
        from mogasr.am.aed import aed_stream_init

        return aed_stream_init
    if name == "make_aed_stream_step":
        from mogasr.am.aed import make_aed_stream_step

        return make_aed_stream_step
    if name == "train_bpe":
        from mogasr.data.bpe import train_bpe

        return train_bpe
    if name == "pipeline":
        import mogasr.pipeline as _p

        return _p
    raise AttributeError(f"module 'mogasr' has no attribute {name!r}")
