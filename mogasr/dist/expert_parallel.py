"""Expert parallelism (MoE FFN) over an ``('expert',)`` mesh.

Mixture-of-experts frame classifier layer with one expert per device:
tokens (frames) are data-sharded over the same axis, a replicated router
picks each token's expert (top-1, softmax gate), and two
``jax.lax.all_to_all`` shuffles move tokens to their expert's device and
back. The dispatch uses fixed-capacity slot buffers ([E, C, H] per
device) so every shape is static — tokens past an expert's capacity are
dropped (their combine weight is exactly 0), the standard Switch-style
overflow rule, tested explicitly.

This is the XLA-native MoE recipe: the all_to_all is a collective, buffers are
lane-aligned, and autodiff differentiates through both shuffles (the
transpose of all_to_all is all_to_all), so ``make_ep_train_step`` is
plain ``jax.grad`` with a load-balance auxiliary loss (Shazeer et al.'s
importance/load proxy: mean gate fraction x mean route fraction per
expert, scaled by E).

Equality vs the dense per-token reference is tested on the faked
8-device CPU mesh (tests/test_expert_parallel.py) and exercised by
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_ep_mesh(n_experts: int, devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if len(devs) < n_experts:
        raise ValueError(f"need {n_experts} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_experts]), ("expert",))


def init_moe_params(key, n_experts: int, hidden: int, ffn: int, n_out: int):
    """Router (replicated), per-expert FFN stacks (sharded on axis 0), and a
    replicated classifier head."""
    kr, k1, k2, ko = jax.random.split(key, 4)
    s_h, s_f = 1.0 / np.sqrt(hidden), 1.0 / np.sqrt(ffn)
    return {
        "Wr": jax.random.normal(kr, (hidden, n_experts), jnp.float32) * s_h,
        "W1": jax.random.normal(k1, (n_experts, hidden, ffn), jnp.float32) * s_h,
        "b1": jnp.zeros((n_experts, ffn), jnp.float32),
        "W2": jax.random.normal(k2, (n_experts, ffn, hidden), jnp.float32) * s_f,
        "b2": jnp.zeros((n_experts, hidden), jnp.float32),
        "Wo": jax.random.normal(ko, (hidden, n_out), jnp.float32) * s_h,
        "bo": jnp.zeros((n_out,), jnp.float32),
    }


def shard_moe_params(params, mesh: Mesh):
    ex = NamedSharding(mesh, P("expert"))
    rep = NamedSharding(mesh, P())
    spec = {"Wr": rep, "W1": ex, "b1": ex, "W2": ex, "b2": ex,
            "Wo": rep, "bo": rep}
    return {k: jax.device_put(v, spec[k]) for k, v in params.items()}


def _expert_ffn(W1, b1, W2, b2, h):
    return jax.nn.relu(h @ W1 + b1) @ W2 + b2


def moe_dense_reference(params, x):
    """Per-token dense reference (no dropping): each token through its
    routed expert, gated; then the classifier head. [N, H] -> [N, V]."""
    scores = x @ params["Wr"]
    e = jnp.argmax(scores, axis=-1)
    gate = jnp.take_along_axis(
        jax.nn.softmax(scores, axis=-1), e[:, None], axis=-1)[:, 0]
    ys = jnp.einsum("nh,ehf->nef", x, params["W1"]) + params["b1"][None]
    ys = jnp.einsum("nef,efh->neh", jax.nn.relu(ys), params["W2"])
    ys = ys + params["b2"][None]
    h = gate[:, None] * ys[jnp.arange(x.shape[0]), e]
    return h @ params["Wo"] + params["bo"]


def make_moe_forward(mesh: Mesh, capacity: int):
    """(params sharded, x [N, H] sharded over 'expert') -> (logits [N, V]
    sharded, aux) with fixed per-(device, expert) capacity C = ``capacity``.

    aux = (load_balance_loss, dropped_fraction) — both replicated scalars.
    """
    n_exp = mesh.shape["expert"]

    def body(Wr, W1, b1, W2, b2, Wo, bo, x):
        # x [n, H] local tokens; W1 [1, H, F] local expert
        n, H = x.shape
        scores = x @ Wr                                    # [n, E]
        probs = jax.nn.softmax(scores, axis=-1)
        e = jnp.argmax(scores, axis=-1)                    # [n]
        gate = jnp.take_along_axis(probs, e[:, None], axis=-1)[:, 0]
        onehot = jax.nn.one_hot(e, n_exp, dtype=jnp.int32)  # [n, E]
        rank = jnp.cumsum(onehot, axis=0) - onehot          # slots before me
        r = jnp.take_along_axis(rank, e[:, None], axis=-1)[:, 0]
        keep = r < capacity
        # dispatch buffer [E, C, H]: token i -> (e_i, r_i)
        buf = jnp.zeros((n_exp, capacity, H), x.dtype)
        buf = buf.at[e, jnp.minimum(r, capacity - 1)].add(
            jnp.where(keep[:, None], x, 0.0))
        recv = jax.lax.all_to_all(
            buf, "expert", split_axis=0, concat_axis=0, tiled=True)
        y = _expert_ffn(W1[0], b1[0], W2[0], b2[0],
                        recv.reshape(n_exp * capacity, H))
        back = jax.lax.all_to_all(
            y.reshape(n_exp, capacity, H), "expert",
            split_axis=0, concat_axis=0, tiled=True)
        out = back[e, jnp.minimum(r, capacity - 1)]         # [n, H]
        out = jnp.where(keep[:, None], gate[:, None] * out, 0.0)
        logits = out @ Wo + bo
        # Switch-style load balance: E * sum_e mean(prob_e) * mean(route_e)
        me = jax.lax.pmean(jnp.mean(probs, axis=0), "expert")
        ce = jax.lax.pmean(
            jnp.mean(onehot.astype(jnp.float32), axis=0), "expert")
        lb = n_exp * jnp.sum(me * ce)
        dropped = 1.0 - jax.lax.pmean(
            jnp.mean(keep.astype(jnp.float32)), "expert")
        return logits, lb, dropped

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("expert"), P("expert"), P("expert"), P("expert"),
                  P(), P(), P("expert")),
        out_specs=(P("expert"), P(), P()),
    )

    @jax.jit
    def forward(params, x):
        return mapped(params["Wr"], params["W1"], params["b1"],
                      params["W2"], params["b2"], params["Wo"],
                      params["bo"], x)

    return forward


# ---------------------------------------------------------------------------
# Production MoeAm expert parallelism (round-4 graduation, VERDICT r3 item 7):
# the SAME flax parameter tree that mogasr.am.neural.MoeAm trains densely on
# one chip executes here with all_to_all token dispatch over an ('expert',)
# mesh — one expert's FFN stack per device, router/projections replicated —
# and the full production train step (optax AdamW from make_optimizer, frame
# CE + load-balance aux) runs jitted over the mesh. Equality vs the dense
# module is tested at full capacity (tests/test_expert_parallel.py) and the
# step is exercised by __graft_entry__.dryrun_multichip.
# ---------------------------------------------------------------------------


def _ln(x, p, eps=1e-6):
    """flax nn.LayerNorm (fast-variance form) as a pure function."""
    mu = jnp.mean(x, axis=-1, keepdims=True)
    mu2 = jnp.mean(x * x, axis=-1, keepdims=True)
    var = jnp.maximum(mu2 - mu * mu, 0.0)
    return (x - mu) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def moe_am_param_specs(params) -> object:
    """PartitionSpec tree for a MoeAm param pytree: per-expert FFN stacks
    (W1_l/b1_l/W2_l/b2_l, expert-major axis 0) shard over 'expert'; router,
    projections, and norms replicate."""
    def spec_of(path, _leaf):
        name = str(path[-2].key if len(path) >= 2 else "")
        leafname = str(path[-1].key) if hasattr(path[-1], "key") else ""
        for n in (name, leafname):
            if any(n.startswith(pfx) for pfx in ("W1_", "b1_", "W2_", "b2_")):
                return P("expert")
        return P()

    return jax.tree_util.tree_map_with_path(spec_of, params)


def shard_moe_am_params(params, mesh: Mesh):
    """device_put a dense-trained MoeAm param tree onto the EP mesh."""
    specs = moe_am_param_specs(params)
    return jax.tree.map(
        lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), params, specs)


def _ep_moe_block(x, Wr, W1, b1, W2, b2, valid, capacity: int):
    """One top-1 MoE FFN block on local tokens x [n, H], local expert
    weights W1 [1, H, F] (this device's expert), replicated router Wr.
    Mirrors mogasr.am.neural.moe_block_dense token-for-token when no token
    overflows ``capacity``; overflowed tokens combine with weight exactly 0
    (Switch drop rule). Returns (y [n, H], load_balance_loss replicated)."""
    n_exp = Wr.shape[1]
    n, H = x.shape
    scores = x @ Wr
    probs = jax.nn.softmax(scores, axis=-1)
    e = jnp.argmax(scores, axis=-1)
    gate = jnp.take_along_axis(probs, e[:, None], axis=-1)[:, 0]
    # padding tokens must not consume expert capacity (CLAUDE.md padding
    # rule): splice-clamped padding duplicates the last valid frame, so an
    # unmasked rank would fill slots with padding and evict VALID tokens —
    # making outputs depend on how much bucket padding a batch carries.
    # Padding is excluded from the rank count AND never kept; its output
    # row is garbage, exactly like the dense path (loss-masked).
    onehot = jax.nn.one_hot(e, n_exp, dtype=jnp.int32) * valid[:, None]
    rank = jnp.cumsum(onehot, axis=0) - onehot
    r = jnp.take_along_axis(rank, e[:, None], axis=-1)[:, 0]
    keep = (r < capacity) & valid
    slot = jnp.minimum(r, capacity - 1)
    buf = jnp.zeros((n_exp, capacity, H), x.dtype)
    buf = buf.at[e, slot].add(jnp.where(keep[:, None], x, 0.0))
    recv = jax.lax.all_to_all(
        buf, "expert", split_axis=0, concat_axis=0, tiled=True)
    y = _expert_ffn(W1[0], b1[0], W2[0], b2[0],
                    recv.reshape(n_exp * capacity, H))
    back = jax.lax.all_to_all(
        y.reshape(n_exp, capacity, H), "expert",
        split_axis=0, concat_axis=0, tiled=True)
    out = back[e, slot]
    out = jnp.where(keep[:, None], gate[:, None] * out, 0.0)
    # load balance over GLOBAL valid tokens — psum of sums / psum of counts
    # reproduces the dense module's single-device mean exactly
    vw = valid.astype(jnp.float32)
    nv = jnp.maximum(jax.lax.psum(jnp.sum(vw), "expert"), 1.0)
    me = jax.lax.psum(jnp.sum(probs * vw[:, None], axis=0), "expert") / nv
    ce = jax.lax.psum(
        jnp.sum(onehot.astype(jnp.float32) * vw[:, None], axis=0),
        "expert") / nv
    lb = n_exp * jnp.sum(me * ce)
    return out, lb


def _moe_am_body(model, params, feats, n_frames, capacity: int):
    """MoeAm forward on one device's batch shard, inside shard_map. Returns
    (logits [b, T, P] local, lb_sum replicated, valid [b*T] local)."""
    from mogasr.am.neural import splice_frames

    p = params["params"]
    B, T, _ = feats.shape
    H = model.hidden
    x = splice_frames(feats, n_frames, model.context)
    x = x @ p["in_proj"]["kernel"] + p["in_proj"]["bias"]
    valid = (jnp.arange(T)[None, :] < n_frames[:, None]).reshape(-1)
    lb_sum = jnp.zeros(())
    for l in range(model.layers):
        h = _ln(x, p[f"ln_{l}"]).reshape(B * T, H)
        y, lb = _ep_moe_block(
            h, p[f"Wr_{l}"], p[f"W1_{l}"], p[f"b1_{l}"],
            p[f"W2_{l}"], p[f"b2_{l}"], valid, capacity)
        lb_sum = lb_sum + lb
        x = x + y.reshape(B, T, H)
    x = _ln(x, p["ln_out"])
    logits = x @ p["head"]["kernel"] + p["head"]["bias"]
    return logits, lb_sum, valid


def make_moe_am_ep_forward(model, mesh: Mesh, capacity: int):
    """Jitted EP forward: (sharded params, feats [B, T, D], n_frames [B]) ->
    logits [B, T, n_pdfs], batch-sharded over 'expert'. At capacity >=
    (local tokens) this equals MoeAm.apply exactly (tested)."""
    if mesh.shape["expert"] != model.n_experts:
        raise ValueError(
            f"EP needs one expert per device: mesh has {mesh.shape['expert']} "
            f"devices, model has {model.n_experts} experts")

    def fwd(params, feats, n_frames):
        logits, _lb, _v = _moe_am_body(model, params, feats, n_frames, capacity)
        return logits

    @jax.jit
    def forward(params, feats, n_frames):
        mapped = shard_map(
            fwd, mesh=mesh,
            in_specs=(moe_am_param_specs(params), P("expert"), P("expert")),
            out_specs=P("expert"),
        )
        return mapped(params, feats, n_frames)

    return forward


def make_moe_am_ep_train_step(model, cfg, mesh: Mesh, capacity: int):
    """The production EP train step: frame CE on forced-alignment labels +
    cfg.moe_lb_weight * load-balance aux, optax AdamW (the exact optimizer
    of the dense path, am.train_nn.make_optimizer), gradients flowing
    through both all_to_all shuffles; expert grads (and their AdamW moments)
    land expert-sharded. Call with params from shard_moe_am_params and
    opt_state from ep_opt_init."""
    from mogasr.am.train_nn import make_optimizer

    if mesh.shape["expert"] != model.n_experts:
        raise ValueError(
            f"EP needs one expert per device: mesh has {mesh.shape['expert']} "
            f"devices, model has {model.n_experts} experts")
    opt = make_optimizer(cfg)

    def loss_body(params, feats, n_frames, labels):
        logits, lb_sum, _valid = _moe_am_body(
            model, params, feats, n_frames, capacity)
        lv = labels >= 0
        safe = jnp.maximum(labels, 0)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, safe[:, :, None], axis=-1)[:, :, 0]
        n = jnp.maximum(jax.lax.psum(jnp.sum(lv), "expert"), 1)
        ce = jax.lax.psum(jnp.sum(jnp.where(lv, nll, 0.0)), "expert") / n
        acc = jax.lax.psum(jnp.sum(jnp.where(
            lv, jnp.argmax(logits, -1) == safe, False)), "expert") / n
        return ce + cfg.moe_lb_weight * lb_sum, ce, acc

    def run(params, feats, n_frames, labels):
        mapped = shard_map(
            loss_body, mesh=mesh,
            in_specs=(moe_am_param_specs(params), P("expert"),
                      P("expert"), P("expert")),
            out_specs=(P(), P(), P()),
        )
        return mapped(params, feats, n_frames, labels)

    @jax.jit
    def step(params, opt_state, feats, n_frames, labels):
        def loss_fn(p):
            loss, ce, acc = run(p, feats, n_frames, labels)
            return loss, (ce, acc)

        (loss, (ce, acc)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state2 = opt.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        # same metric contract as make_train_step (ADVICE r4): "loss" is the
        # TOTAL optimized objective, "ce" the CE term alone
        return new_params, opt_state2, {"loss": loss, "ce": ce,
                                        "frame_acc": acc}

    return step


def ep_opt_init(model, cfg, params):
    """AdamW state for the EP step (moments inherit the params' shardings
    when initialized under jit on device_put params)."""
    from mogasr.am.train_nn import make_optimizer

    return jax.jit(make_optimizer(cfg).init)(params)


def make_ep_train_step(mesh: Mesh, capacity: int, lr: float = 1e-2,
                       lb_weight: float = 0.01):
    """One EP-MoE CE training step on expert-sharded tokens: grads flow
    through both all_to_all shuffles; expert grads land expert-sharded."""
    forward = make_moe_forward(mesh, capacity)

    def loss_fn(params, x, y):
        logits, lb, _ = forward(params, x)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(logp, y[:, None], axis=-1)[:, 0]
        return -jnp.mean(ll) + lb_weight * lb

    @jax.jit
    def step(params, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        new = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return new, loss

    return step
