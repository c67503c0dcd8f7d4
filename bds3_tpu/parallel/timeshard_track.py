"""Time-sharded closed-loop tracking with loop-state handoff — the
receiver-domain analog of sequence/context parallelism (SURVEY.md
section 2.5; the reference's latent axis is the sequential `fread`
stream, `BDS-3_B2a/tracking.m:237-254`).

The IF stream is cut into n_dev consecutive segments, one per device on
a "time" mesh axis.  Closed-loop tracking is strictly sequential per
channel (the DLL/PLL state recurrence), so a single channel group would
leave n_dev - 1 devices idle; instead the channels are split into G
groups and pipelined: at pipeline stage s, device d tracks group
g = s - d through its local segment, then hands the group's 9-field
ChannelState to device d+1 via `ppermute` (cursor rebased by the
per-segment shift, exactly as the single-device driver rebases between
blocks).  After n_dev + G - 1 stages every group has traversed every
segment; per-epoch outputs stay resident where they were produced and
are reassembled on the host.

Equivalence: each device's local block is the same signal slice the
sequential driver would feed to its block loop, and the state handoff is
the same arithmetic as the driver's cursor rebase, so an N-shard run
reproduces the 1-device run to float32 tolerance (tests/test_timeshard_
track.py asserts this on the 8-device CPU mesh; `chip_smoke.py --four`
on four GPUs).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from bds3_tpu.config import Settings
from bds3_tpu.track.driver import channel_code_tables
from bds3_tpu.track.scan import output_names, track_block
from bds3_tpu.track.state import (
    ChannelConsts,
    ChannelState,
    channel_consts,
    code_coarse_tables,
    initial_state,
    make_track_config,
)


def _stage_worker(local_block, state_all, consts_all, data_g, p11_g, p61_g,
                  ckd_i, ckd_f, ck61_i, ck61_f, *, cfg, n_dev, G, shift,
                  axis):
    """Per-device shard_map body: run the full software pipeline."""
    local_block = local_block.reshape(-1)         # (1, B) -> (B,)
    d = jax.lax.axis_index(axis)
    F = len(output_names(cfg))
    W = cfg.epochs_per_block
    Cg = data_g.shape[1]
    outs_buf = jnp.zeros((G, F, W, Cg), jnp.float32)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def take(tree, g):
        return jax.tree_util.tree_map(
            lambda a: jax.lax.dynamic_index_in_dim(a, g, 0, keepdims=False),
            tree)

    def put(tree, sub, g):
        return jax.tree_util.tree_map(
            lambda a, v: jax.lax.dynamic_update_index_in_dim(a, v, g, 0),
            tree, sub)

    for s in range(n_dev + G - 1):
        g = s - d                                  # active group (traced)
        valid = (g >= 0) & (g < G)
        gc = jnp.clip(g, 0, G - 1)
        st = take(state_all, gc)
        new_st, outs = track_block(
            cfg, local_block,
            jax.lax.dynamic_index_in_dim(data_g, gc, 0, keepdims=False),
            jax.lax.dynamic_index_in_dim(p11_g, gc, 0, keepdims=False),
            jax.lax.dynamic_index_in_dim(p61_g, gc, 0, keepdims=False),
            ckd_i, ckd_f, ck61_i, ck61_f,
            take(consts_all, gc), st,
        )
        # cursor rebase for the next segment (same as the driver's
        # per-block `cursor - shift`)
        new_st = new_st._replace(cursor=new_st.cursor - shift)
        # write back only where this device is in the active band
        upd = jax.tree_util.tree_map(
            lambda old, new: jnp.where(valid, new, old), st, new_st)
        state_all = put(state_all, upd, gc)
        packed = jnp.stack([outs[k].astype(jnp.float32)
                            for k in output_names(cfg)])   # (F, W, Cg)
        old = jax.lax.dynamic_index_in_dim(outs_buf, gc, 0, keepdims=False)
        outs_buf = jax.lax.dynamic_update_index_in_dim(
            outs_buf, jnp.where(valid, packed, old), gc, 0)
        # hand every group's state to the right neighbor; untouched slots
        # carry their initial values around the ring, finished slots are
        # never read again
        state_all = jax.tree_util.tree_map(
            lambda a: jax.lax.ppermute(a, axis, perm), state_all)

    return outs_buf[None]                          # (1, G, F, W, Cg)


def time_sharded_track(
    mesh: Mesh,
    signal: np.ndarray,
    settings: Settings,
    inits,
    n_epochs: int,
    n_groups: int | None = None,
    axis: str = "time",
    channel_axis: str | None = None,
    correlator: str = "auto",
):
    """Track `inits` channels over `n_epochs` epochs with the sample
    stream time-sharded across mesh[axis].

    n_epochs must divide evenly into mesh_size segments; channels are
    split into n_groups pipeline groups (default: time-axis size, capped
    by the channel count).  Returns a dict name -> (C, n_epochs) f32.

    channel_axis: optional second mesh axis ("time", "channel"): each
    pipeline group's channels are sharded
    across mesh[channel_axis], so a 2-D mesh composes the loop-state
    handoff ring with channel fan-out (SURVEY.md section 2.5;
    tracking.m:237-254's stream axis x its channel loop).
    correlator: the block correlator, resolved as in track/driver.py."""
    n_dev = mesh.shape[axis]
    if n_epochs % n_dev:
        raise ValueError(f"n_epochs {n_epochs} % n_dev {n_dev} != 0")
    W = n_epochs // n_dev
    C = len(inits)
    if n_groups is None:
        n_groups = min(n_dev, C)
    if C % n_groups:
        raise ValueError(f"channels {C} % groups {n_groups} != 0")
    Cg = C // n_groups
    n_ch_dev = mesh.shape[channel_axis] if channel_axis else 1
    if Cg % n_ch_dev:
        raise ValueError(
            f"group channels {Cg} % mesh[{channel_axis}] {n_ch_dev} != 0")

    cfg = make_track_config(settings, np.iscomplexobj(signal), W, correlator)
    consts = channel_consts(cfg, inits, settings)
    data_t, p11_t, p61_t = channel_code_tables(cfg, inits)
    ckd_i, ckd_f = code_coarse_tables(cfg, cfg.m_data)
    if cfg.m_p61:
        ck61_i, ck61_f = code_coarse_tables(cfg, cfg.m_p61)
    else:
        ck61_i, ck61_f = ckd_i, ckd_f

    cursors0 = np.array([c.code_phase for c in inits], dtype=np.int64)
    s0 = int(cursors0.min())
    state = initial_state(cfg, inits, consts, cursors0 - s0)

    # same block geometry as the sequential driver (track/driver.py)
    per_epoch_max = cfg.q0_int + 3
    block_len = int(cursors0.max() - s0) + W * per_epoch_max + cfg.n_max \
        + 2 * cfg.q0_int + 4 * per_epoch_max + W + 64
    exp_adv = cfg.code_length / (
        cfg.step_base + consts.init_dstep.astype(np.float64))
    shift = max(int(np.floor(W * (exp_adv.min() - 0.1))), 0)

    need = s0 + (n_dev - 1) * shift + block_len
    if need > len(signal):
        raise ValueError(f"signal too short: need {need}, have {len(signal)}")
    blocks = np.stack([
        np.asarray(signal[s0 + d * shift: s0 + d * shift + block_len])
        for d in range(n_dev)
    ])
    if not cfg.complex_input and blocks.dtype != np.int8:
        blocks = blocks.astype(np.float32)

    def group(arr):      # (C, ...) -> (G, Cg, ...)
        return np.asarray(arr).reshape((n_groups, Cg) + arr.shape[1:])

    state_all = ChannelState(*(group(x) for x in state))
    consts_all = ChannelConsts(*(group(x) for x in consts))
    data_g, p11_g = group(data_t), group(p11_t)
    p61_g = group(p61_t)

    # with a channel axis, the per-group channel dim (dim 1 of every
    # state/consts/code leaf) is sharded across mesh[channel_axis]; the
    # signal blocks stay sharded over time only (replicated per channel
    # column), and the ppermute handoff ring runs along the time axis
    # within each channel column
    pc = P(None, channel_axis) if channel_axis else P()
    fn = jax.shard_map(
        functools.partial(_stage_worker, cfg=cfg, n_dev=n_dev, G=n_groups,
                          shift=shift, axis=axis),
        mesh=mesh,
        in_specs=(P(axis), pc, pc, pc, pc, pc,
                  P(), P(), P(), P()),
        out_specs=P(axis, None, None, None, channel_axis)
        if channel_axis else P(axis),
        check_vma=False,
    )
    res = jax.jit(fn)(
        jnp.asarray(blocks),
        jax.tree_util.tree_map(jnp.asarray, state_all),
        jax.tree_util.tree_map(jnp.asarray, consts_all),
        jnp.asarray(data_g), jnp.asarray(p11_g), jnp.asarray(p61_g),
        jnp.asarray(ckd_i), jnp.asarray(ckd_f),
        jnp.asarray(ck61_i), jnp.asarray(ck61_f),
    )                                             # (n_dev, G, F, W, Cg)
    if jax.process_count() > 1:
        # time axis spans processes: fetch the remote shards over the
        # distributed backend
        from jax.experimental import multihost_utils

        out = np.asarray(multihost_utils.process_allgather(res, tiled=True))
    else:
        out = np.asarray(res)

    names = output_names(cfg)
    # (n_dev, G, F, W, Cg) -> (F, G*Cg, n_dev*W)
    out = out.transpose(2, 1, 4, 0, 3).reshape(len(names), C, n_epochs)
    return {k: out[i] for i, k in enumerate(names)}
