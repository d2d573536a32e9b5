"""Tensor (model) parallelism over a 2-D ``('data', 'model')`` mesh.

DP over utterances (mogasr/dist/sharded.py) is the system's first-class
parallelism (BASELINE.json north_star). This module adds the model axis for
acoustic models too large for one chip's HBM:

- **State-sharded GMM scoring**: the GMM pytree's state dimension is laid out
  over 'model'; each chip scores its state shard for its utterance shard and
  XLA inserts one all-gather over the model axis to produce the full [B,T,S]
  loglik block the decoder needs.  At BASELINE configs[1] scale (1000 states
  x 256 comps x 39 dims) the natural parameters are ~80 MB — single-chip fits
  today, but a 100k-pdf senone inventory would not; the sharding is the same
  annotation either way.
- **Megatron-style MLP**: Dense kernels alternate column-parallel
  (P(None,'model')) and row-parallel (P('model',None)); activations stay
  sharded on the hidden dim between the pair and XLA emits the psum after
  each row-parallel GEMM.  Works on the unmodified Flax modules from
  mogasr/am/neural.py — parallelism is expressed entirely as shardings,
  exactly the pick-mesh / annotate / let-XLA-insert-collectives recipe.

Everything here is jit-over-NamedSharding; there are no manual collectives.
Equality vs the single-device paths is tested on the faked 8-device CPU mesh
(tests/test_tensor_parallel.py) and exercised by __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mogasr.am.gmm import LOG_2PI, GmmSet
from mogasr.config import TrainConfig


def make_tp_mesh(n_data: int, n_model: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D device mesh with axes ('data', 'model').

    The model axis is innermost, so it spans adjacent devices in
    jax.devices() order.
    """
    devs = list(devices) if devices is not None else jax.devices()
    if len(devs) < n_data * n_model:
        raise ValueError(f"need {n_data * n_model} devices, have {len(devs)}")
    grid = np.array(devs[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, ("data", "model"))


def shard_gmm_states(gmm: GmmSet, mesh: Mesh) -> GmmSet:
    """Lay the GMM out with its state dimension over the 'model' axis."""
    sh = NamedSharding(mesh, P("model"))
    return jax.tree.map(lambda a: jax.device_put(a, sh), gmm)


def make_tp_score_step(mesh: Mesh, mode: str = "sum", var_floor: float = 1e-3):
    """(gmm state-sharded, feats[B,T,D] data-sharded) -> loglik[B,T,S].

    The output is replicated over 'model' (full state row per utterance), so
    XLA inserts the all-gather over the model axis; over 'data' it stays
    sharded for the downstream (also data-sharded) decoder.

    Scoring is the einsum form in the native [S,K,D] layout — the reshape-to-
    GEMM trick of gmm.natural_params would mix the sharded S into an S*K dim
    and force a resharding; the einsum partitions cleanly instead.
    """
    gmm_sh = NamedSharding(mesh, P("model"))
    feat_sh = NamedSharding(mesh, P("data"))
    out_sh = NamedSharding(mesh, P("data"))

    @functools.partial(
        jax.jit,
        in_shardings=(jax.tree.map(lambda _: gmm_sh, GmmSet(0, 0, 0)), feat_sh),
        out_shardings=out_sh,
    )
    def score(gmm: GmmSet, feats: jax.Array) -> jax.Array:
        v = jnp.maximum(gmm.vars, var_floor)                       # [S,K,D]
        a = -0.5 / v
        b = gmm.means / v
        c = (
            jnp.log(jnp.maximum(gmm.weights, 1e-30))
            - 0.5 * (
                gmm.means.shape[-1] * LOG_2PI
                + jnp.sum(jnp.log(v), -1)
                + jnp.sum(gmm.means ** 2 / v, -1)
            )
        )                                                          # [S,K]
        x = feats
        s = (
            jnp.einsum("btd,skd->btsk", x * x, a,
                       precision=jax.lax.Precision.HIGHEST)
            + jnp.einsum("btd,skd->btsk", x, b,
                         precision=jax.lax.Precision.HIGHEST)
            + c[None, None]
        )
        if mode == "max":
            return jnp.max(s, axis=-1)
        return jax.nn.logsumexp(s, axis=-1)

    return score


# ---------------------------------------------------------------- MLP (TP)

def _dense_sharding(path, mesh: Mesh) -> NamedSharding:
    """Alternating column/row parallel spec for a Flax Dense param path."""
    names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
    names = [n for n in names if isinstance(n, str)]
    dense = [n for n in names if n.startswith("Dense_")]
    if dense:
        i = int(dense[-1].split("_")[1])
        col = i % 2 == 0
        if names[-1] == "kernel":
            return NamedSharding(mesh, P(None, "model") if col else P("model", None))
        if names[-1] == "bias":
            return NamedSharding(mesh, P("model") if col else P())
    return NamedSharding(mesh, P())


def mlp_shardings(tree, mesh: Mesh):
    """Sharding pytree for MLP params OR a whole TrainState (the optimizer
    moments mirror the param tree, so the same path rule applies).

    Dims not divisible by the model-axis size fall back to replicated —
    e.g. an output head whose pdf count doesn't pad to the axis (production
    senone inventories are padded instead; see gmm_pallas's lane padding).
    """
    m = mesh.shape["model"]

    def fn(path, leaf):
        sh = _dense_sharding(path, mesh)
        shape = getattr(leaf, "shape", None)
        if shape is None or len(sh.spec) == 0:
            return sh
        spec = tuple(
            None if (ax == "model" and i < len(shape) and shape[i] % m != 0) else ax
            for i, ax in enumerate(sh.spec)
        )
        return sh if spec == tuple(sh.spec) else NamedSharding(mesh, P(*spec))

    return jax.tree_util.tree_map_with_path(fn, tree)


def shard_mlp_state(state, mesh: Mesh):
    sh = mlp_shardings(state, mesh)
    return jax.tree.map(jax.device_put, state, sh)


def make_tp_forward(model, mesh: Mesh):
    """(variables TP-sharded, feats[B,T,D] data-sharded, n_frames) -> logits.

    `variables` is the model.init output (the same tree the single-device
    paths pass to model.apply).
    """
    dsh = NamedSharding(mesh, P("data"))

    def fwd(variables, feats, n_frames):
        return model.apply(variables, feats, n_frames)

    return jax.jit(fwd, out_shardings=dsh)


def make_tp_train_step(model, cfg: TrainConfig, mesh: Mesh):
    """DP x TP train step: batch over 'data', hidden dim over 'model'.

    Mirrors am.train_nn.make_train_step (same optimizer, same frame-CE
    objective, same TrainState tuple) with parallelism expressed purely as
    shardings: grads and optimizer moments inherit the parameter layout, so
    each model shard updates locally after the psum implied by the loss mean.
    """
    from mogasr.am.train_nn import TrainState, frame_ce_loss, make_optimizer

    import optax

    opt = make_optimizer(cfg)
    dsh = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def train_step(state, feats, n_frames, labels):
        def loss_fn(params):
            logits = model.apply(params, feats, n_frames)
            return frame_ce_loss(logits, labels)

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), {
            "loss": loss,
            "frame_acc": acc,
        }

    def jitted(state, feats, n_frames, labels):
        ssh = mlp_shardings(state, mesh)
        step = jax.jit(
            train_step,
            in_shardings=(ssh, dsh, dsh, dsh),
            out_shardings=(ssh, {"loss": rep, "frame_acc": rep}),
        )
        return step(state, feats, n_frames, labels)

    return jitted
