"""Space-to-depth ("channel folding") conv algebra — exact reformulations.

The full-resolution levels of the reference architectures run 3^3 convs
with 1–64 channels (reference: unet3d/model/unet.py::unet_model_3d level-0
blocks; isensee2017.py entry/context modules per SURVEY §2 rows 7–8). Thin
channel counts underfill a matrix unit that wants wide operands — SURVEY
§7 hard-part #1.

The algebraic remedy: fold 2× spatial blocks into the channel dimension (space-to-depth) so the same math runs with 2–8× the
channels on a 2–8× smaller grid. This module implements that folding
EXACTLY — same multiply-accumulates, reassociated — for the ops the
level-0 blocks need:

- ``fold``/``unfold``: layout transforms, per-axis factors in {1, 2}.
- ``conv3_folded``: SAME 3^3 stride-1 conv computed in folded space, in
  three formulations (see below).
- ``conv3_folded_stride2``: the stride-2 "entry" conv (Isensee's
  down-sampling context path), which folds with no parity split at all.
- ``pool_folded``: MaxPool(2) along folded axes is a free per-cell
  reduction (the pool windows ARE the fold cells).
- ``up_conv3_folded`` / ``upsample_nearest_folded`` / ``concat_folded``:
  the decoder ops emitted directly in folded layout (the parity
  sub-grids ARE the channel blocks, so the interleave transposes vanish).

Formulations of the stride-1 folded conv (all exact; FLOP multipliers for
a fully-folded axis set F = prod(factors)):

- ``parity``: one small conv per output sub-voxel parity (window 2 cells
  per folded axis), outputs concatenated as folded channels. Dense-FLOP
  cost (4/3)^n_folded of the unfolded conv (n_folded = #axes with f=2).
- ``parity_batched``: the same parity convs merged into ONE conv by
  stacking the shifted input windows on the batch axis — identical FLOPs,
  8× the GEMM M dimension, single XLA op.
- ``dense``: one conv over 3^3 folded cells with the parity kernels
  embedded at their cell offsets (zeros elsewhere). 2^n_folded× dense
  FLOPs — only plausible for 1 folded axis.

Which (if any) wins is an empirical question per backend — see
docs/PERF.md ("H100 bring-up"; tools/bench_forms.py) for the measurements
and models/layers.py FOLD_BACKENDS for the integration decision.

Conventions: NDHWC layout; fold order is sub-voxel-major
(folded channel = ((b1*f2 + b2)*f3 + b3)*C + c), and parity outputs are
concatenated in the same order, so ``unfold(conv3_folded(fold(x), W)) ==
conv3_same(x, W)`` bit-for-bit in fp32 up to reassociation.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Factors = Tuple[int, int, int]

_DN = ("NDHWC", "DHWIO", "NDHWC")


def _check_factors(factors: Sequence[int]) -> Factors:
    f = tuple(int(v) for v in factors)
    if len(f) != 3 or any(v not in (1, 2) for v in f):
        raise ValueError(f"fold factors must be three values in {{1,2}}, got {f}")
    return f  # type: ignore[return-value]


def fold(x: jnp.ndarray, factors: Sequence[int]) -> jnp.ndarray:
    """(B, D, H, W, C) -> (B, D/f1, H/f2, W/f3, f1*f2*f3*C), sub-voxel-major.

    Pure layout (reshape + transpose); XLA fuses it into neighbors.
    """
    f1, f2, f3 = _check_factors(factors)
    b, d, h, w, c = x.shape
    if d % f1 or h % f2 or w % f3:
        raise ValueError(f"spatial {(d, h, w)} not divisible by factors {(f1, f2, f3)}")
    x = x.reshape(b, d // f1, f1, h // f2, f2, w // f3, f3, c)
    x = jnp.transpose(x, (0, 1, 3, 5, 2, 4, 6, 7))
    return x.reshape(b, d // f1, h // f2, w // f3, f1 * f2 * f3 * c)


def unfold(y: jnp.ndarray, factors: Sequence[int]) -> jnp.ndarray:
    """Inverse of :func:`fold`."""
    f1, f2, f3 = _check_factors(factors)
    b, d, h, w, fc = y.shape
    c = fc // (f1 * f2 * f3)
    y = y.reshape(b, d, h, w, f1, f2, f3, c)
    y = jnp.transpose(y, (0, 1, 4, 2, 5, 3, 6, 7))
    return y.reshape(b, d * f1, h * f2, w * f3, c)


# Per-axis tap-routing tensors for a FOLDED axis (factor 2), kernel 3:
# output voxel p = 2i+s reads taps k in {0,1,2} at input voxel 2i+s-1+k,
# which lands in window-cell a (window = cells {i-1, i} for s=0, {i, i+1}
# for s=1) at sub-voxel b. T[s][a, b, k] = 1 iff tap k routes to (a, b).
_T_FOLDED = np.zeros((2, 2, 2, 3), np.float32)
_T_FOLDED[0, 0, 1, 0] = 1  # s=0: k=0 -> cell i-1 (a=0), sub 1
_T_FOLDED[0, 1, 0, 1] = 1  # s=0: k=1 -> cell i   (a=1), sub 0
_T_FOLDED[0, 1, 1, 2] = 1  # s=0: k=2 -> cell i   (a=1), sub 1
_T_FOLDED[1, 0, 0, 0] = 1  # s=1: k=0 -> cell i   (a=0), sub 0
_T_FOLDED[1, 0, 1, 1] = 1  # s=1: k=1 -> cell i   (a=0), sub 1
_T_FOLDED[1, 1, 0, 2] = 1  # s=1: k=2 -> cell i+1 (a=1), sub 0

# An UNFOLDED axis keeps its 3 taps: window 3 cells, one sub-voxel.
_T_UNFOLDED = np.eye(3, dtype=np.float32).reshape(3, 1, 3)

# Stride-2 SAME conv, folded axis: XLA/Keras pad SAME stride-2 on an even
# axis with (0 left, 1 right), so output q reads taps at voxels 2q, 2q+1,
# 2q+2 = cells {q, q+1} — exactly the s=1 routing, no parity split.
_T_STRIDE2 = _T_FOLDED[1]


@functools.lru_cache(maxsize=None)
def _parities(factors: Factors) -> Tuple[Tuple[int, int, int], ...]:
    f1, f2, f3 = factors
    return tuple((s1, s2, s3)
                 for s1 in range(f1) for s2 in range(f2) for s3 in range(f3))


def _axis_T(factor: int, s: int) -> np.ndarray:
    return _T_UNFOLDED if factor == 1 else _T_FOLDED[s]


def _parity_kernel(kernel: jnp.ndarray, factors: Factors,
                   parity: Tuple[int, int, int]) -> jnp.ndarray:
    """(3,3,3,Cin,Cout) -> (w1,w2,w3, F*Cin, Cout) for one output parity.

    wj = 2 on folded axes (2-cell window), 3 on unfolded. Routing is an
    outer product of the per-axis T tensors — every original tap appears
    exactly once, so the conv is the same sum, reassociated.
    """
    t1, t2, t3 = (_axis_T(f, s) for f, s in zip(factors, parity))
    wf = jnp.einsum("auk,bvl,cwm,klmio->abcuvwio",
                    jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(t3),
                    kernel.astype(jnp.float32))
    # wf: (w1, w2, w3, b1, b2, b3, Cin, Cout) -> merge subvoxel-major channels
    w1, w2, w3 = wf.shape[:3]
    cin, cout = kernel.shape[3], kernel.shape[4]
    F = factors[0] * factors[1] * factors[2]
    return wf.reshape(w1, w2, w3, F * cin, cout).astype(kernel.dtype)


def _padded(xf: jnp.ndarray) -> jnp.ndarray:
    return jnp.pad(xf, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))


def _parity_window(xpad: jnp.ndarray, factors: Factors,
                   parity: Tuple[int, int, int]) -> jnp.ndarray:
    """Slice of the cell-padded input covering this parity's taps.

    Folded axis: offset s, length d+1 (VALID 2-window -> d outputs).
    Unfolded axis: offset 0, length d+2 (VALID 3-window -> d outputs).
    """
    b = xpad.shape[0]
    c = xpad.shape[-1]
    dims = [n - 2 for n in xpad.shape[1:4]]
    starts = [0] + [s if f == 2 else 0 for f, s in zip(factors, parity)] + [0]
    sizes = [b] + [d + (1 if f == 2 else 2)
                   for f, d in zip(factors, dims)] + [c]
    limits = [st + sz for st, sz in zip(starts, sizes)]
    return jax.lax.slice(xpad, starts, limits)


def conv3_folded(xf: jnp.ndarray, kernel: jnp.ndarray,
                 bias: Optional[jnp.ndarray], factors: Sequence[int],
                 formulation: str = "parity") -> jnp.ndarray:
    """SAME 3^3 stride-1 conv, computed in folded space. Exact.

    xf: folded input (B, d, h, w, F*Cin); kernel: the UNFOLDED (3,3,3,
    Cin, Cout) parameter (checkpoint layout unchanged); returns the folded
    output (B, d, h, w, F*Cout).
    """
    factors = _check_factors(factors)
    pars = _parities(factors)
    if len(pars) == 1:  # no folded axis: plain SAME conv
        y = jax.lax.conv_general_dilated(xf, kernel.astype(xf.dtype),
                                         (1, 1, 1), "SAME",
                                         dimension_numbers=_DN)
        return y if bias is None else y + bias.astype(y.dtype)

    xpad = _padded(xf)
    if formulation == "parity":
        outs = [jax.lax.conv_general_dilated(
                    _parity_window(xpad, factors, p),
                    _parity_kernel(kernel, factors, p).astype(xf.dtype),
                    (1, 1, 1), "VALID", dimension_numbers=_DN)
                for p in pars]
        y = jnp.concatenate(outs, axis=-1)
    elif formulation == "parity_batched":
        # Every parity window has the same SHAPE (2-window on folded axes,
        # 3-window on unfolded) at a different offset, and each parity has
        # its own kernel — a vmapped conv over the stacked (window, kernel)
        # pairs, which XLA lowers as ONE grouped convolution instead of P
        # separate ops.
        stack = jnp.stack(
            [_parity_window(xpad, factors, p) for p in pars], axis=0)
        kstack = jnp.stack(
            [_parity_kernel(kernel, factors, p) for p in pars], axis=0)
        y = jax.vmap(
            lambda xw, kw: jax.lax.conv_general_dilated(
                xw, kw.astype(xf.dtype), (1, 1, 1), "VALID",
                dimension_numbers=_DN))(stack, kstack.astype(xf.dtype))
        # (P, B, d, h, w, Cout) -> (B, d, h, w, P*Cout)
        p_, b_, d_, h_, w_, co = y.shape
        y = jnp.transpose(y, (1, 2, 3, 4, 0, 5)).reshape(b_, d_, h_, w_,
                                                         p_ * co)
    elif formulation == "dense":
        ker = _dense_kernel(kernel, factors)
        y = jax.lax.conv_general_dilated(xpad, ker.astype(xf.dtype),
                                         (1, 1, 1), "VALID",
                                         dimension_numbers=_DN)
    else:
        raise ValueError(f"unknown formulation {formulation!r}")
    if bias is not None:
        F = factors[0] * factors[1] * factors[2]
        y = y + jnp.tile(bias, F).astype(y.dtype)
    return y


def _dense_kernel(kernel: jnp.ndarray, factors: Factors) -> jnp.ndarray:
    """Embed every parity kernel at its cell offset in one 3^3-cell kernel.

    Folded axis: parity s=0's 2-window covers dense cells {0,1}, s=1's
    covers {1,2}. Unfolded axis: the 3-window is the dense window.
    Density (27/64 per fully-folded pair) -> 2^n_folded x dense FLOPs.
    """
    cin, cout = kernel.shape[3], kernel.shape[4]
    F = factors[0] * factors[1] * factors[2]
    pars = _parities(factors)
    out = jnp.zeros((3, 3, 3, F * cin, len(pars) * cout), jnp.float32)
    for pi, p in enumerate(pars):
        kp = _parity_kernel(kernel, factors, p).astype(jnp.float32)
        w1, w2, w3 = kp.shape[:3]
        o1, o2, o3 = (s if f == 2 else 0 for f, s in zip(factors, p))
        out = jax.lax.dynamic_update_slice(
            out,
            jnp.pad(kp, ((o1, 3 - w1 - o1), (o2, 3 - w2 - o2),
                         (o3, 3 - w3 - o3), (0, 0), (0, 0))),
            (0, 0, 0, 0, pi * cout))
    return out.astype(kernel.dtype)


def conv3_folded_stride2(xf: jnp.ndarray, kernel: jnp.ndarray,
                         bias: Optional[jnp.ndarray],
                         factors: Sequence[int]) -> jnp.ndarray:
    """Stride-2 SAME 3^3 conv with the stride absorbed into the fold.

    On a folded axis the stride-2 outputs ARE the cell grid (one parity —
    the s=1 routing, since SAME stride-2 over an even axis pads (0, 1) so
    output q reads voxels 2q..2q+2), so there is no parity split and no
    output folding: returns (B, D/2, H/2, W/2, Cout) — the natural
    resolution of the next level. Unfolded axes run a normal stride-2
    SAME conv. Exact match of ``lax.conv(x, k, strides=2, SAME)`` for
    even input sizes (reference: isensee2017 strided
    create_convolution_block, Keras SAME semantics).
    """
    factors = _check_factors(factors)
    # the (0, 1) SAME padding below is the EVEN-axis rule; on an odd axis
    # XLA/Keras SAME pads (1, 1) and this routing would silently compute a
    # different (and shorter) output — refuse instead. Folded axes are
    # even by construction (original dim = 2 x cells); unfolded axes carry
    # the original dim and must be checked.
    for ax, (f, d) in enumerate(zip(factors, xf.shape[1:4])):
        if f == 1 and d % 2:
            raise ValueError(
                f"conv3_folded_stride2 requires even spatial dims (SAME "
                f"stride-2 pads odd axes differently); axis {ax} has {d}")
    cin, cout = kernel.shape[3], kernel.shape[4]
    t = [(_T_STRIDE2 if f == 2 else _T_UNFOLDED) for f in factors]
    wf = jnp.einsum("auk,bvl,cwm,klmio->abcuvwio",
                    jnp.asarray(t[0]), jnp.asarray(t[1]), jnp.asarray(t[2]),
                    kernel.astype(jnp.float32))
    F = factors[0] * factors[1] * factors[2]
    w1, w2, w3 = wf.shape[:3]
    ker = wf.reshape(w1, w2, w3, F * cin, cout).astype(xf.dtype)
    # SAME stride-2 over an even axis pads (0 lo, 1 hi). Folded axes: pad
    # 1 cell RIGHT (the q = D/2-1 window cell q+1), VALID 2-window with
    # stride 1 on the cell grid; unfolded axes: explicit (0, 1) pad,
    # stride 2.
    pads = [(0, 1) for _ in factors]
    strides = tuple(1 if f == 2 else 2 for f in factors)
    y = jax.lax.conv_general_dilated(
        jnp.pad(xf, ((0, 0),) + tuple(pads) + ((0, 0),)),
        ker, strides, "VALID", dimension_numbers=_DN)
    return y if bias is None else y + bias.astype(y.dtype)


def pool_folded(xf: jnp.ndarray, factors: Sequence[int]) -> jnp.ndarray:
    """MaxPool(2, stride 2) with folded axes reduced per-cell (free).

    Fully-folded (2,2,2): a pure reshape + max over the sub-voxel axis —
    the pool windows are exactly the fold cells. Partially-folded axes
    reduce per-cell on folded axes and window-pool the rest. Output is
    UNFOLDED (the natural next-level resolution), channels back to C.
    """
    factors = _check_factors(factors)
    b, d, h, w, fc = xf.shape
    f1, f2, f3 = factors
    F = f1 * f2 * f3
    c = fc // F
    x = xf.reshape(b, d, h, w, f1, f2, f3, c)
    x = x.max(axis=(4, 5, 6))  # per-cell max over present sub-voxels
    # axes not folded still need their spatial 2-window pool
    window = tuple(1 if f == 2 else 2 for f in factors)
    if any(s != 1 for s in window):
        x = jax.lax.reduce_window(
            x, -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating)
            else jnp.iinfo(x.dtype).min,
            jax.lax.max, (1,) + window + (1,), (1,) + window + (1,), "VALID")
    return x


def up_conv3_folded(x_deep: jnp.ndarray, kernel_up: jnp.ndarray,
                    factors: Sequence[int]) -> jnp.ndarray:
    """conv3^3(upsample_nearest2(x_deep)) emitted directly in folded space.

    The parity decomposition of layers.up_concat_conv3x3 (output parity r
    reads only 2 source voxels per axis, 8 effective 2^3 kernels) already
    computes one output sub-grid per parity — in folded space those
    sub-grids ARE the channel blocks, so the interleave transpose
    disappears. Folded axes keep parity as channels; unfolded axes still
    interleave spatially. x_deep is at cell resolution (B, d, h, w, Cin);
    returns (B, d*, h*, w*, F*Cout) with dj* = dj on folded axes, 2*dj on
    unfolded ones. No bias (callers add it once after the skip half).
    """
    factors = _check_factors(factors)
    # per-axis merge matrices: S[r][j, k] = 1 iff kernel tap k lands on
    # source offset j for output parity r (see layers.up_concat_conv3x3)
    S = jnp.asarray([[[1, 0, 0], [0, 1, 1]],
                     [[1, 1, 0], [0, 0, 1]]], jnp.float32)
    b, d, h, w, cin = x_deep.shape
    co = kernel_up.shape[-1]
    xpad = jnp.pad(x_deep, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    outs = []
    for r1 in range(2):
        for r2 in range(2):
            for r3 in range(2):
                weff = jnp.einsum("ak,bl,cm,klmio->abcio",
                                  S[r1], S[r2], S[r3],
                                  kernel_up.astype(jnp.float32)
                                  ).astype(x_deep.dtype)
                xs = jax.lax.slice(
                    xpad, (0, r1, r2, r3, 0),
                    (b, r1 + d + 1, r2 + h + 1, r3 + w + 1, cin))
                outs.append(jax.lax.conv_general_dilated(
                    xs, weff, (1, 1, 1), "VALID", dimension_numbers=_DN))
    # outs indexed by (r1, r2, r3); route each axis's parity to channels
    # (folded) or spatial interleave (unfolded)
    y = jnp.stack(outs, axis=1).reshape(b, 2, 2, 2, d, h, w, co)
    # target order: spatial dims with unfolded parities interleaved, then
    # folded parities sub-voxel-major ahead of channels
    f1, f2, f3 = factors
    perm = [0]
    shape = [b]
    for ax, f in zip(range(3), factors):  # spatial part
        perm.append(4 + ax)
        if f == 1:
            perm.append(1 + ax)
    # shapes for spatial
    dims = (d, h, w)
    for ax, f in zip(range(3), factors):
        shape.append(dims[ax] * (1 if f == 2 else 2))
    for ax, f in zip(range(3), factors):  # folded parities -> channels
        if f == 2:
            perm.append(1 + ax)
    perm.append(7)
    F = f1 * f2 * f3
    shape.append(F * co)
    return jnp.transpose(y, perm).reshape(shape)


def concat_folded(a: jnp.ndarray, b: jnp.ndarray,
                  factors: Sequence[int]) -> jnp.ndarray:
    """Channel-concat of two folded tensors, preserving the folded layout.

    Folded channels are sub-voxel-major ((b1,b2,b3), c) — a plain
    jnp.concatenate would interleave whole tensors instead of per-cell
    channels, so split the sub axis out, concat on c, and re-merge.
    (Reference: isensee2017.py decoder `concatenate([up, skip])`.)
    """
    factors = _check_factors(factors)
    F = factors[0] * factors[1] * factors[2]
    sa, sb = a.shape, b.shape
    ar = a.reshape(sa[:4] + (F, sa[4] // F))
    br = b.reshape(sb[:4] + (F, sb[4] // F))
    out = jnp.concatenate([ar, br], axis=-1)
    return out.reshape(sa[:4] + (F * (sa[4] // F + sb[4] // F),))


def upsample_nearest_folded(src: jnp.ndarray,
                            factors: Sequence[int]) -> jnp.ndarray:
    """UpSampling3D(2) emitted directly in folded layout.

    src is at cell resolution, unfolded channels (B, d, h, w, C). For a
    folded axis the x2 upsample maps output cell i sub b to source index
    (2i+b)//2 == i — both sub-voxels copy the SAME source, so the sub
    axis is a broadcast (channel tile); unfolded axes jnp.repeat as
    usual. Output: folded (B, d1*, d2*, d3*, F*C) with dj* = dj on folded
    axes, 2*dj on unfolded ones. Exact: unfold(result) ==
    upsample_nearest(src).
    """
    factors = _check_factors(factors)
    x = src
    for ax, f in zip((1, 2, 3), factors):
        if f == 1:
            x = jnp.repeat(x, 2, axis=ax)
    F = factors[0] * factors[1] * factors[2]
    if F > 1:
        x = jnp.tile(x[..., None, :],
                     (1,) * 4 + (F, 1)).reshape(x.shape[:4] + (F * x.shape[4],))
    return x


def conv1_folded(xf: jnp.ndarray, kernel: jnp.ndarray,
                 bias: Optional[jnp.ndarray],
                 factors: Sequence[int]) -> jnp.ndarray:
    """1^3 conv in folded space: a per-sub-voxel matmul. Exact.

    kernel: the UNFOLDED (1,1,1,Cin,Cout) nn.Conv parameter. Computation
    dtype follows xf (cast the kernel before calling for bf16 paths);
    returns the folded (B, d, h, w, F*Cout) output. Shared by the folded
    model heads (unet head, Isensee localization tails and seg heads).
    """
    factors = _check_factors(factors)
    F = factors[0] * factors[1] * factors[2]
    b, d, h, w, fc = xf.shape
    cin = fc // F
    xs = xf.reshape(b, d, h, w, F, cin)
    y = jnp.einsum("bdhwsc,co->bdhwso", xs,
                   kernel[0, 0, 0].astype(xf.dtype))
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y.reshape(b, d, h, w, F * kernel.shape[-1])
