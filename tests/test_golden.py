"""Golden-file regression tests (SURVEY.md §4 fixture strategy): frozen
waveform -> frozen features -> frozen GMM logliks. Catches any silent drift
in front-end conventions (window, mel scale, log base, frame counts) or
scorer math across rounds."""

import os

import numpy as np
import jax.numpy as jnp

from mogasr.am.gmm import GmmSet
from mogasr.am.gmm_pallas import gmm_loglik_kernel
from mogasr.config import FrontendConfig
from mogasr.frontend.jax_frontend import extract_features
from mogasr.frontend.numpy_ref import extract_features_np

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden.npz")


def test_frontend_matches_golden():
    data = np.load(FIXTURE)
    got = extract_features(data["wave"], FrontendConfig())
    assert got.shape == data["feats"].shape
    np.testing.assert_allclose(got, data["feats"], atol=3e-4, rtol=3e-4)


def test_oracle_matches_golden():
    """The NumPy oracle itself must not drift (it anchors all parity)."""
    data = np.load(FIXTURE)
    ref = extract_features_np(data["wave"], FrontendConfig())
    np.testing.assert_allclose(ref, data["feats"], atol=1e-6)


def test_gmm_scorer_matches_golden():
    data = np.load(FIXTURE)
    g = GmmSet(
        jnp.asarray(data["gmm_w"]), jnp.asarray(data["gmm_mu"]), jnp.asarray(data["gmm_var"])
    )
    got = np.asarray(gmm_loglik_kernel(
        jnp.asarray(data["feats"][:50]), g, block_m=64, interpret=True))
    np.testing.assert_allclose(got, data["loglik"], atol=1e-3, rtol=1e-4)
