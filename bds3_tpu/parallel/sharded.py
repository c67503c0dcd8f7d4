"""Sharded variants of the receiver's device entry points.

Channel/PRN axes are pure fan-out, so sharding is expressed by placing
the leading axis of the per-channel inputs on the "channel" mesh axis
and jitting the *same* kernels — XLA partitions the vmapped lanes with
no communication (the domain's data parallelism, SURVEY.md section 2.5).
The Doppler axis of acquisition is sharded with `shard_map`: each device
searches its bin subset and the global (peak, bin, phase) winner is
combined with one tiny all-gather.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bds3_tpu.acquire.pcps import AcqConfig, coarse_search
from bds3_tpu.track.scan import track_block
from bds3_tpu.track.state import ChannelConsts, ChannelState, TrackConfig


def sharded_coarse_search(mesh: Mesh, signal, data_codes, pilot_codes,
                          a_bins, c1_bins, cfg: AcqConfig,
                          axis: str = "channel"):
    """Coarse PCPS with the PRN axis sharded across the mesh.

    PRN count must be a multiple of (mesh size * cfg.prn_chunk) for even
    lanes; the caller pads.  Signal and Doppler tables are replicated.
    """
    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    signal = jax.device_put(signal, rep)
    data_codes = jax.device_put(data_codes, shard)
    pilot_codes = jax.device_put(pilot_codes, shard)
    a_bins = jax.device_put(a_bins, rep)
    c1_bins = jax.device_put(c1_bins, rep)
    return coarse_search(signal, data_codes, pilot_codes, a_bins, c1_bins, cfg)


def doppler_sharded_coarse_search(mesh: Mesh, signal, data_codes,
                                  pilot_codes, a_bins, c1_bins,
                                  cfg: AcqConfig, axis: str = "channel"):
    """Coarse PCPS with the Doppler-bin axis sharded via shard_map.

    a_bins/c1_bins length must be a multiple of (mesh size * bin_chunk);
    the caller pads (padded bins are masked inside coarse_search).  Each
    device runs the standard scan over its local bins; the winners are
    combined with an all_gather of three (P,)-vectors.
    """
    n_dev = mesh.shape[axis]
    # each shard sees its local bin count as fully valid
    local_bins = a_bins.shape[0] // n_dev
    local_cfg = AcqConfig(**{**cfg.__dict__, "n_bins": local_bins})

    # check_vma off: coarse_search's internal scan carries replicated
    # constants that become device-varying once the bin axis is manual
    fn = jax.shard_map(
        functools.partial(_local_search, local_cfg=local_cfg, axis=axis),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)(signal, data_codes, pilot_codes, a_bins, c1_bins)


def _local_search(sig, d8, p8, a_loc, c1_loc, *, local_cfg, axis):
    dev = jax.lax.axis_index(axis)
    v, b, ph = coarse_search(sig, d8, p8, a_loc, c1_loc, local_cfg)
    b = b + dev * a_loc.shape[0]
    vs = jax.lax.all_gather(v, axis)
    bs = jax.lax.all_gather(b, axis)
    ps = jax.lax.all_gather(ph, axis)
    win = jnp.argmax(vs, axis=0)
    take = lambda arr: jnp.take_along_axis(arr, win[None, :], axis=0)[0]
    return take(vs), take(bs), take(ps)


def sharded_track_block(mesh: Mesh, cfg: TrackConfig, block,
                        data_tables, pilot11_tables, pilot61_tables,
                        ck_data_int, ck_data_frac, ck_p61_int, ck_p61_frac,
                        consts: ChannelConsts, state: ChannelState,
                        axis: str = "channel"):
    """One tracking block with channels sharded across the mesh.

    The signal block and code-phase coarse tables are replicated; all
    per-channel arrays (code tables, carrier tables, loop states) are
    sharded on their leading axis.  The epoch scan then runs fully
    parallel lanes; the only cross-device traffic is the initial
    placement.
    """
    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    block = jax.device_put(block, rep)
    data_tables = jax.device_put(data_tables, shard)
    pilot11_tables = jax.device_put(pilot11_tables, shard)
    pilot61_tables = jax.device_put(pilot61_tables, shard)
    ck = [jax.device_put(x, rep) for x in
          (ck_data_int, ck_data_frac, ck_p61_int, ck_p61_frac)]
    consts = ChannelConsts(*(jax.device_put(x, shard) for x in consts))
    state = ChannelState(*(jax.device_put(x, shard) for x in state))
    return track_block(cfg, block, data_tables, pilot11_tables,
                       pilot61_tables, *ck, consts, state)


def shard_map_track_block(mesh: Mesh, cfg: TrackConfig, block,
                          data_tables, pilot11_tables, pilot61_tables,
                          ck_data_int, ck_data_frac, ck_p61_int,
                          ck_p61_frac, consts: ChannelConsts,
                          state: ChannelState, axis: str = "channel"):
    """Channel-sharded tracking via `shard_map`: each device runs the
    full per-block program on its local channel slice, with the
    partitioning stated explicitly instead of left to XLA.  No
    cross-device traffic inside the block; equivalent to
    `sharded_track_block`."""
    from bds3_tpu.track.scan import output_names

    n_dev = mesh.shape[axis]
    if data_tables.shape[0] % n_dev:
        raise ValueError("channel count must divide the mesh axis")

    def local(blk, dt, p11t, p61t, ci, cf, c2i, c2f, cns, st):
        ns, outs = track_block(cfg, blk, dt, p11t, p61t, ci, cf, c2i, c2f,
                               ChannelConsts(*cns), ChannelState(*st))
        return tuple(ns), outs

    ch = P(axis)
    rep = P()
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(rep, ch, ch, ch, rep, rep, rep, rep,
                  tuple([ch] * len(consts)), tuple([ch] * len(state))),
        out_specs=(tuple([ch] * len(state)),
                   {k: P(None, axis) for k in output_names(cfg)}),
        check_vma=False,
    )
    new_state, outs = jax.jit(fn)(
        block, data_tables, pilot11_tables, pilot61_tables,
        ck_data_int, ck_data_frac, ck_p61_int, ck_p61_frac,
        tuple(jnp.asarray(x) for x in consts),
        tuple(jnp.asarray(x) for x in state))
    return ChannelState(*new_state), outs
