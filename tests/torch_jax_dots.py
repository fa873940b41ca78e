"""XLA:CPU's float64 convolutions as sums of matrix products, for the JAX
references of the port's tests.

XLA:CPU runs a float64 convolution as a plain loop nest, far slower than
its float64 matrix product, so the float64 JAX train steps of PSMNet and
PSMNet-basic that the port's tests hold the port to spent most of their
time in it (``tests/torch_jax_ref_cost.py`` times one step both ways).
Inside ``f64_convs_as_dots()``, a float64 ``lax.conv_general_dilated``
lowers on the CPU to the same sum written as matrix products on strided
slices of the padded, dilated input: a loop over the kernel's taps with
one ``dot_general`` over the input channels a step, or, where the output
has fewer positions than the kernel has taps (a kernel gradient), one
``dot_general`` over the taps and channels of every output position's
window.  The JAX package's code, its primitives and their derivatives are
unchanged; only XLA's lowering of this one primitive is replaced by the
same products summed in another order (``test_torch_grads.py`` holds the
two to 1e-12, forward and both VJPs, in the forms the models use).
Grouped convolutions, other dtypes and convolutions of fewer than
``MIN_MACS`` multiply-adds keep XLA's own lowering.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import jax.numpy as jnp
import numpy as np
from jax import lax
from jax._src.interpreters import mlir
from jax._src.lax import convolution as _convolution


def conv_as_dots(lhs, rhs, *, window_strides, padding, lhs_dilation, rhs_dilation,
                 dimension_numbers, preferred_element_type=None, **_):
    """``lax.conv_general_dilated`` (no groups) as sums of ``dot_general``s."""
    lhs_spec, rhs_spec, out_spec = dimension_numbers
    nd = len(lhs_spec) - 2
    x = jnp.transpose(lhs, (lhs_spec[0], *lhs_spec[2:], lhs_spec[1]))  # N, S..., C
    k = jnp.transpose(rhs, (*rhs_spec[2:], rhs_spec[1], rhs_spec[0]))  # K..., C, O
    x = lax.pad(x, np.zeros((), x.dtype),
                [(0, 0, 0)] + [(lo, hi, d - 1) for (lo, hi), d in zip(padding, lhs_dilation)]
                + [(0, 0, 0)])
    taps, size = k.shape[:nd], x.shape[1:1 + nd]
    out_size = [max(0, (p - (t - 1) * r - 1) // s + 1)
                for p, t, r, s in zip(size, taps, rhs_dilation, window_strides)]
    n, c, o = x.shape[0], x.shape[-1], k.shape[-1]
    dtype = preferred_element_type
    if not math.prod(out_size):
        out = jnp.zeros((n, *out_size, o), dtype or x.dtype)
    elif math.prod(taps) <= math.prod(out_size):
        out = _tap_loop(x, k, taps, out_size, window_strides, rhs_dilation, dtype)
    else:
        # fewer output positions than taps: each position's window, stacked
        wins = []
        for pos in itertools.product(*map(range, out_size)):
            lo = [p * s for p, s in zip(pos, window_strides)]
            wins.append(lax.slice(x, [0, *lo, 0],
                                  [n, *[a + (t - 1) * r + 1 for a, t, r in
                                        zip(lo, taps, rhs_dilation)], c],
                                  [1, *rhs_dilation, 1]))
        out = lax.dot_general(jnp.stack(wins, 1), k,
                              ((tuple(range(2, nd + 3)), tuple(range(nd + 1))), ((), ())),
                              preferred_element_type=dtype).reshape(n, *out_size, o)
    # (N, S..., O) -> out_spec's layout
    perm = [0] * (nd + 2)
    for i, d in enumerate((out_spec[0], *out_spec[2:], out_spec[1])):
        perm[d] = i
    return jnp.transpose(out, perm)


def _tap_loop(x, k, taps, out_size, strides, dilation, dtype):
    """sum over the kernel's taps t of x[:, s o + r t, :] @ k[t]: one matrix
    product a step of a loop, so that the program stays small.  Each
    dimension of x is split by the stride into phases, so that a tap's
    strided rows are one dynamic slice."""
    nd, n, c, o = len(taps), x.shape[0], x.shape[-1], k.shape[-1]
    starts = [[t * r for t in range(tn)] for tn, r in zip(taps, dilation)]
    lengths = [q + max(st) // s for q, st, s in zip(out_size, starts, strides)]
    # x (N, S..., C) -> (s..., N, L..., C): phase p of dim d holds rows p, p + s, ...
    x = x[(slice(None), *[slice(0, L * s) for L, s in zip(lengths, strides)])]
    x = lax.pad(x, np.zeros((), x.dtype),
                [(0, 0, 0)] + [(0, L * s - w, 0) for L, s, w in zip(lengths, strides, x.shape[1:])]
                + [(0, 0, 0)])
    x = x.reshape(n, *itertools.chain(*[(L, s) for L, s in zip(lengths, strides)]), c)
    x = jnp.transpose(x, (*range(2, 2 * nd + 1, 2), 0, *range(1, 2 * nd, 2), 2 * nd + 1))
    grid = list(itertools.product(*starts))
    phase = jnp.asarray([[st % s for st, s in zip(g, strides)] for g in grid], np.int32)
    offset = jnp.asarray([[st // s for st, s in zip(g, strides)] for g in grid], np.int32)
    kt = k.reshape(len(grid), c, o)
    zero = jnp.zeros((), np.int32)

    def step(j, acc):
        rows = lax.dynamic_slice(x, [*phase[j], zero, *offset[j], zero],
                                 [1] * nd + [n, *out_size, c])
        return acc + lax.dot_general(rows.reshape(-1, c), kt[j], (((1,), (0,)), ((), ())),
                                     preferred_element_type=dtype)

    acc = jnp.zeros((n * math.prod(out_size), o), dtype or x.dtype)
    return lax.fori_loop(0, len(grid), step, acc).reshape(n, *out_size, o)


# below this many multiply-adds XLA's loop costs less than compiling the
# products (PSMNet's step at 256x256 compiles and runs fastest from here)
MIN_MACS = 10 ** 7


@contextlib.contextmanager
def f64_convs_as_dots():
    """While open, a float64 ``conv_general_dilated`` without groups of at
    least ``MIN_MACS`` multiply-adds lowers on the CPU as ``conv_as_dots``;
    every other case keeps its rule."""
    prim = _convolution.conv_general_dilated_p
    table = mlir._platform_specific_lowerings["cpu"]
    old = table[prim]
    dots = mlir.lower_fun(conv_as_dots, multiple_results=False)

    def rule(ctx, lhs, rhs, **params):
        (a, b), (out,) = ctx.avals_in, ctx.avals_out
        kernel_out = b.shape[params["dimension_numbers"].rhs_spec[0]]
        macs = math.prod(out.shape) * math.prod(b.shape) // max(kernel_out, 1)
        if (a.dtype == b.dtype == out.dtype == np.float64 and params["feature_group_count"] == 1
                and params["batch_group_count"] == 1 and macs >= MIN_MACS):
            return dots(ctx, lhs, rhs, **params)
        return old.rule(ctx, lhs, rhs, **params)

    table[prim] = mlir.LoweringRuleEntry(rule, old.inline)
    try:
        yield
    finally:
        table[prim] = old
