"""Cascade evaluation kernel for the GPU (Pallas through Triton).

One program evaluates the cascade for one image and one (TU, TV) tile of
window origins.  Stage node tables are RUNTIME arrays (the same padded
:class:`~waldboost_tpu.ops.cascade.Cascade` the XLA evaluator takes), so a
new model or a growing training cascade reuses the compiled kernel, and
cascade depth is bounded only by the table size.

Per stage, every internal node of the (complete, heap-ordered) tree is one
shifted ``(TU, TV)`` load of the channel canvas at
``(ch, r0 + fr, c0 + fc)`` compared with the node threshold; the leaf value
comes from a select tree.  SPRT rejection is tile-granular: a
``lax.while_loop`` walks groups of ``GROUP`` stages while any window of the
tile is alive, so a tile whose windows are all rejected stops loading.
Rejection is monotone per window, so survivors and their scores are
bitwise those of the lockstep evaluator (:func:`ops.cascade.
cascade_response_grid`): the same f32 leaf sums in the same stage order.

Outputs follow the serving-extraction contract: a ``-inf``-masked score map
over the tile-padded window grid, per-image survivor counts and the exact
weak-evaluation counter ``n_weak``.  Tiles write per-row partial counts that
XLA sums, so results are deterministic (no atomics).

Reference semantics anchor: the reference's waldboost/model.py:216-259.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..platform import kernel_interpret
from .cascade import Cascade, CascadeMeta, cascade_response_grid

__all__ = ["TILE", "GROUP", "cascade_grid", "cascade_masked",
           "cascade_dense", "kernel_supported"]

#: window-origin tile of one program (rows, cols); powers of two (Triton)
TILE = (16, 64)
#: stages evaluated between two tile-level early-exit checks
GROUP = 4
#: Triton launch settings: warps per program, software-pipeline stages
NUM_WARPS = 4
NUM_STAGES = 1


def cascade_grid(content_hw: Tuple[int, int], window: Tuple[int, int],
                 tile: Tuple[int, int] = TILE):
    """``(TU, TV, gi, gj)``: the kernel's tile shape and grid for a canvas
    with ``content_hw`` content and an (m, n) window.  The masked output map
    covers ``(gi * TU, gj * TV)`` window origins (the true grid is
    ``(U - m, V - n)``; the rest is dead padding)."""
    U, V = content_hw
    m, n = window
    gu, gv = max(U - m, 0), max(V - n, 0)
    TU, TV = tile
    return TU, TV, max(-(-gu // TU), 1), max(-(-gv // TV), 1)


def kernel_supported(meta) -> bool:
    """Whether the kernel can evaluate a cascade with this metadata: it
    routes canonical complete heap trees (every cascade whose trees are at
    most ``ops.cascade.MAX_COMPLETE_DEPTH`` deep)."""
    return isinstance(meta, CascadeMeta) and meta.complete


def _kernel(nact_ref, fch_ref, fr_ref, fc_ref, thr_ref, leaf_ref, theta_ref,
            mask_ref, canvas_ref, out_ref, cnt_ref, nw_ref, *hs_ref,
            depth: int, hw: Tuple[int, int], with_n_weak: bool):
    TU, TV = out_ref.shape
    H, W = hw
    n_int = 2 ** depth - 1
    r0 = pl.program_id(1) * TU
    c0 = pl.program_id(2) * TV
    rows = r0 + jax.lax.broadcasted_iota(jnp.int32, (TU, TV), 0)
    cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (TU, TV), 1)
    n_active = nact_ref[0]

    def stage(t, hs, alive, nw):
        bins = []
        for h in range(n_int):
            fr = fr_ref[t, h]
            fc = fc_ref[t, h]
            # reads past the canvas only feed statically dead windows
            ok = jnp.logical_and(rows + fr < H, cols + fc < W)
            x = plgpu.load(canvas_ref.at[fch_ref[t, h], pl.ds(r0 + fr, TU),
                                         pl.ds(c0 + fc, TV)],
                           mask=ok, other=0)
            bins.append(x.astype(jnp.float32) <= thr_ref[t, h])

        def route(h, d):
            if d == depth:
                return leaf_ref[t, h - n_int]
            return jnp.where(bins[h], route(2 * h + 1, d + 1),
                             route(2 * h + 2, d + 1))

        resp = route(0, 0)
        live = alive > 0
        if with_n_weak:
            counts = jnp.logical_and(live, t < n_active)
            nw = nw + counts.astype(jnp.int32)
        hs = hs + jnp.where(live, resp, 0.0)
        alive = jnp.where(hs >= theta_ref[t], alive, 0)
        return hs, alive, nw

    def cond(carry):
        g, _, alive, _ = carry
        any_alive = jnp.max(jnp.max(alive, axis=1), axis=0) > 0
        return jnp.logical_and(g * GROUP < n_active, any_alive)

    def body(carry):
        g, hs, alive, nw = carry
        for k in range(GROUP):
            hs, alive, nw = stage(g * GROUP + k, hs, alive, nw)
        return g + 1, hs, alive, nw

    carry = (jnp.int32(0), jnp.zeros((TU, TV), jnp.float32), mask_ref[...],
             jnp.zeros((TU, TV), jnp.int32))
    _, hs, alive, nw = jax.lax.while_loop(cond, body, carry)
    live = alive > 0
    out_ref[...] = jnp.where(live, hs, -jnp.inf)
    cnt_ref[...] = jnp.sum(live.astype(jnp.int32), axis=1)
    nw_ref[...] = jnp.sum(nw, axis=1)
    if hs_ref:
        hs_ref[0][...] = hs


def _tables(casc: Cascade, depth: int):
    """Kernel operands from a complete-tree cascade: internal-node tables
    ``(T, 2^D - 1)``, leaf table ``(T, 2^D)``, thetas, stage count padded
    to a multiple of GROUP with inert stages, and the active-stage count
    (``Cascade.active`` is a prefix)."""
    n_int = 2 ** depth - 1
    T = casc.n_stages
    pad = (-T) % GROUP
    fch, fr, fc, thr = (a[:, :n_int] for a in (casc.fch, casc.fr, casc.fc,
                                               casc.thr))
    leaf = casc.pred[:, n_int:2 * n_int + 1]
    theta = casc.theta
    if pad:
        fch, fr, fc, thr, leaf = (jnp.pad(a, ((0, pad), (0, 0)))
                                  for a in (fch, fr, fc, thr, leaf))
        theta = jnp.pad(theta, (0, pad), constant_values=-jnp.inf)
    n_active = jnp.sum(casc.active, dtype=jnp.int32)[None]
    return (n_active, fch.astype(jnp.int32), fr.astype(jnp.int32),
            fc.astype(jnp.int32), thr.astype(jnp.float32),
            leaf.astype(jnp.float32), theta.astype(jnp.float32))


def _call(canvas, casc: Cascade, meta: CascadeMeta, valid_mask, window,
          with_n_weak: bool, dense: bool, tile):
    B, C, U, V = canvas.shape
    m, n = window
    gu, gv = max(U - m, 0), max(V - n, 0)
    TU, TV, gi, gj = cascade_grid((U, V), window, tile)
    mask = jnp.pad(valid_mask.astype(jnp.int32),
                   ((0, gi * TU - gu), (0, gj * TV - gv)))
    tabs = _tables(casc, meta.depth)
    full = lambda a: pl.BlockSpec(a.shape, lambda b, i, j: (0,) * a.ndim)
    kernel = functools.partial(_kernel, depth=meta.depth, hw=(U, V),
                               with_n_weak=with_n_weak)
    map_spec = pl.BlockSpec((None, TU, TV), lambda b, i, j: (b, i, j))
    row_spec = pl.BlockSpec((None, TU, None), lambda b, i, j: (b, i, j))
    out_shape = [jax.ShapeDtypeStruct((B, gi * TU, gj * TV), jnp.float32),
                 jax.ShapeDtypeStruct((B, gi * TU, gj), jnp.int32),
                 jax.ShapeDtypeStruct((B, gi * TU, gj), jnp.int32)]
    out_specs = [map_spec, row_spec, row_spec]
    if dense:
        out_shape.append(out_shape[0])
        out_specs.append(map_spec)
    outs = pl.pallas_call(
        kernel,
        grid=(B, gi, gj),
        in_specs=[full(a) for a in tabs] + [
            pl.BlockSpec((TU, TV), lambda b, i, j: (i, j)),
            pl.BlockSpec((None, C, U, V), lambda b, i, j: (b, 0, 0, 0)),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=kernel_interpret(),
        name="waldboost_cascade",
    )(*tabs, mask, canvas)
    masked, cnt, nw = outs[:3]
    count = jnp.sum(cnt.reshape(B, -1), axis=1)
    n_weak = jnp.sum(nw.reshape(B, -1), axis=1)
    if dense:
        return masked, count, n_weak, outs[3]
    return masked, count, n_weak


def _lockstep(canvas, casc, meta, valid_mask, window):
    """XLA lockstep evaluation for cascades the kernel cannot route (trees
    deeper than ``MAX_COMPLETE_DEPTH``): ``(hs, alive, n_weak)`` per image
    on the true window grid."""
    f = lambda cv: cascade_response_grid(cv, casc, window, meta,
                                         init_alive=valid_mask)
    return jax.vmap(f)(canvas)


@functools.partial(jax.jit, static_argnames=("meta", "window", "with_n_weak",
                                             "tile"))
def cascade_masked(canvas: jax.Array, casc: Cascade, meta,
                   valid_mask: jax.Array, window: Tuple[int, int],
                   with_n_weak: bool = True, tile: Tuple[int, int] = TILE):
    """Serving form: ``(masked, n_weak, count)`` for a (B, C, H, W) canvas
    batch (any float dtype; bf16 canvases are compared in f32).

    ``masked`` is the (B, gi*TU, gj*TV) f32 map of survivor scores with
    ``-inf`` elsewhere (see :func:`cascade_grid`); ``n_weak`` and ``count``
    are per-image weak-evaluation and survivor totals.
    ``with_n_weak=False`` drops the evaluation counter (zeros)."""
    if not kernel_supported(meta):
        hs, alive, n_weak = _lockstep(canvas, casc, meta, valid_mask, window)
        TU, TV, gi, gj = cascade_grid(canvas.shape[2:], window, tile)
        gu, gv = alive.shape[1:]
        masked = jnp.pad(jnp.where(alive, hs, -jnp.inf),
                         ((0, 0), (0, gi * TU - gu), (0, gj * TV - gv)),
                         constant_values=-jnp.inf)
        count = jnp.sum(alive, axis=(1, 2), dtype=jnp.int32)
        return masked, (n_weak if with_n_weak else n_weak * 0), count
    masked, count, n_weak = _call(canvas, casc, meta, valid_mask, window,
                                  with_n_weak, False, tile)
    return masked, n_weak, count


@functools.partial(jax.jit, static_argnames=("meta", "window", "tile"))
def cascade_dense(canvas: jax.Array, casc: Cascade, meta,
                  valid_mask: jax.Array, window: Tuple[int, int],
                  tile: Tuple[int, int] = TILE):
    """Drop-in batched equivalent of :func:`ops.cascade.
    cascade_response_grid`: ``(hs, alive, n_weak)`` with leading batch dim
    on the true (U - m, V - n) window grid, bitwise equal to the lockstep
    evaluator (dead windows keep the score they were rejected with)."""
    if not kernel_supported(meta):
        return _lockstep(canvas, casc, meta, valid_mask, window)
    U, V = canvas.shape[2:]
    m, n = window
    gu, gv = max(U - m, 0), max(V - n, 0)
    masked, _, n_weak, hs = _call(canvas, casc, meta, valid_mask, window,
                                  True, True, tile)
    return (hs[:, :gu, :gv], masked[:, :gu, :gv] > -jnp.inf, n_weak)
