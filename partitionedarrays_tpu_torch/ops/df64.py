"""Double-float ("df64") arithmetic: about 49 bits of precision from pairs
of float32 words.

A plain-torch copy of ``partitionedarrays_tpu/ops/df64.py``.  A df64 value
is an unevaluated sum ``hi + lo`` of two float32 tensors of one shape with
``|lo| <= ulp(hi)/2``; the Dekker and Knuth error-free transformations below
carry the rounding error of every float32 operation into the low word.

The reference wraps every input of an error-free transformation in
``_pin`` (``df64.py:39-65``), a barrier against XLA's fusion, contraction
and reassociation.  Eager PyTorch rounds every operation on its own, so no
pin is needed; the rule that replaces it is that no line here may fuse or
contract: no ``addcmul``, ``lerp``, ``torch.compile`` or other fused
operator.  The CUDA kernel K7 (``csrc/dia_spmv_df.cu``) keeps the same rule
with ``__fadd_rn``/``__fmul_rn`` and an exact ``fmaf`` two-product.  So the
reference's unpinned ``*_raw`` forms are the same functions here, and its
``dot_spmd`` is ``dot_parts`` over the stacked part axis.

On the H100 df64 exists for parity only: the card has native float64.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]

# Dekker split constant for float32 (24-bit significand -> 12 + 12)
_SPLIT = 4097.0  # 2**12 + 1


# -- error-free transformations ---------------------------------------------

def two_sum(a, b):
    """Error-free a + b = s + e (Knuth, 6 flops, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker split, 17 flops)."""
    p = a * b
    a1 = a * _SPLIT
    ah = a1 - (a1 - a)
    al = a - ah
    b1 = b * _SPLIT
    bh = b1 - (b1 - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# the reference's unpinned forms for its kernels (df64.py:68-94); nothing is
# pinned here (torch fuses no op of this module), so they are the same
two_sum_raw = two_sum
quick_two_sum_raw = quick_two_sum
two_prod_raw = two_prod


# -- pair arithmetic ----------------------------------------------------------

def add(a: Pair, b: Pair) -> Pair:
    """df64 + df64 (accurate variant, ~20 flops)."""
    s1, s2 = two_sum(a[0], b[0])
    t1, t2 = two_sum(a[1], b[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def sub(a: Pair, b: Pair) -> Pair:
    return add(a, (-b[0], -b[1]))


def mul(a: Pair, b: Pair) -> Pair:
    """df64 * df64 (~25 flops); a pair of 0-d tensors broadcasts."""
    p1, p2 = two_prod(a[0], b[0])
    p2 = p2 + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p1, p2)


def div(a: Pair, b: Pair) -> Pair:
    """df64 / df64 (two correction steps, ~1 ulp of df64)."""
    q1 = a[0] / b[0]
    r = sub(a, mul((q1, torch.zeros_like(q1)), b))
    q2 = r[0] / b[0]
    r = sub(r, mul((q2, torch.zeros_like(q2)), b))
    q3 = r[0] / b[0]
    q1, q2 = quick_two_sum(q1, q2)
    return quick_two_sum(q1, q2 + q3)


def sqrt(a: Pair) -> Pair:
    """df64 square root: a float32 seed and one df64 Newton step."""
    s = torch.sqrt(torch.clamp(a[0], min=0.0))
    zero = torch.zeros_like(s)
    q = div(a, (torch.where(s > 0, s, torch.ones_like(s)), zero))
    h, l = add((s, zero), q)
    return 0.5 * h, 0.5 * l  # exact halving


def scale(v: Pair, s: Pair) -> Pair:
    """df64 vector times a df64 scalar (0-d tensors broadcast)."""
    return mul(v, s)


def neg(a: Pair) -> Pair:
    return -a[0], -a[1]


# -- reductions ---------------------------------------------------------------

def tree_sum(pair: Pair) -> Pair:
    """df64 sum over the last dim: the reference's fold (pad to even, add
    the upper half to the lower half, repeat), batched over leading dims.
    Returns a pair of shape ``pair[0].shape[:-1]``."""
    ph, pl = pair
    n = ph.shape[-1]
    if n == 0:
        z = ph.new_zeros(ph.shape[:-1])
        return z, z.clone()
    while n > 1:
        half = (n + 1) // 2
        if 2 * half != n:
            pad = ph.new_zeros(ph.shape[:-1] + (1,))
            ph = torch.cat([ph, pad], dim=-1)
            pl = torch.cat([pl, pad], dim=-1)
        ph, pl = add((ph[..., :half], pl[..., :half]), (ph[..., half:], pl[..., half:]))
        n = half
    return ph[..., 0], pl[..., 0]


def dot(a: Pair, b: Pair) -> Pair:
    """df64 dot product over all elements, as 0-d tensors."""
    return tree_sum(mul((a[0].reshape(-1), a[1].reshape(-1)),
                        (b[0].reshape(-1), b[1].reshape(-1))))


def dot_parts(a: Pair, b: Pair, backend=None) -> Pair:
    """df64 dot of part-stacked vectors ``[P_local, n]``: each part's
    compensated dot, the partial pairs of every process gathered in part
    order (``backend.allgather_parts``; nothing is sent on one process),
    then one df64 fold over all P: the reference's ``dot_spmd`` (:213,
    all-gather then ``tree_sum``), bit-equal on any number of processes
    to the serial backend.  A plain sum of the hi words would re-round in
    float32 and lose the compensation."""
    P = a[0].shape[0]
    ph, pl = tree_sum(mul((a[0].reshape(P, -1), a[1].reshape(P, -1)),
                          (b[0].reshape(P, -1), b[1].reshape(P, -1))))
    if backend is not None and backend.is_multiprocess:
        ph, pl = backend.allgather_parts(torch.stack([ph, pl], dim=1)).unbind(dim=1)
    return tree_sum((ph, pl))


def dot_spmd(a: Pair, b: Pair, axis_name=None, backend=None) -> Pair:
    """The reference's ``dot_spmd`` (:213): its per-part dots and fold over
    the SPMD axis ``axis_name`` are ``dot_parts`` over the part axis and
    the processes of ``backend`` here, which needs no axis name."""
    return dot_parts(a, b, backend)


# -- conversions --------------------------------------------------------------

def from_f64(v: torch.Tensor) -> Pair:
    """Split a float64 tensor into (hi, lo) float32 on its device: the
    reference's host split (``df64.py:223-229``), bit for bit."""
    v = v.to(torch.float64)
    hi = v.to(torch.float32)
    lo = (v - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def to_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The pair as float64 (exact: float32 embeds in float64)."""
    return hi.to(torch.float64) + lo.to(torch.float64)


def zeros(shape, device=None) -> Pair:
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


# -- plain df64 SpMVs ---------------------------------------------------------

def dia_spmv_df_plain(
    offsets: Sequence[int], vals_hi: torch.Tensor, vals_lo: torch.Tensor, x: Pair
) -> Pair:
    """The plain version of kernel K7: y = A @ x in df64 over DIA values
    ``vals_hi``, ``vals_lo`` ``[P, n_off, R]`` and x ``[P, n_cols]`` (zero
    outside ``[0, n_cols)``); returns a pair of ``[P, R]``.

    Per tap it runs the TPU kernel body's order (``spmv_pallas.py:
    157-191``), as the CUDA kernel does: an exact two-product of the hi
    words, the cross terms into its error, a two-sum into the hi
    accumulator and the low terms into the lo accumulator; one
    ``quick_two_sum`` at the end.  The reference's XLA ``dia_spmv_df``
    (``df64.py:244``) adds a full ``mul`` pair per tap instead: the two
    agree to about 2^-48 of ``sum |A||x|``, not bit for bit."""
    P, _, R = vals_hi.shape
    if not offsets:
        return zeros((P, R), vals_hi.device)
    n_cols = x[0].shape[-1]
    lo_off = min(min(offsets), 0)
    hi_off = max(max(offsets) + R, n_cols)

    def pad(v):
        vp = v.new_zeros((P, hi_off - lo_off))
        vp[:, -lo_off : -lo_off + n_cols] = v
        return vp

    xh, xl = pad(x[0]), pad(x[1])
    acc_h = vals_hi.new_zeros((P, R))
    acc_l = vals_hi.new_zeros((P, R))
    for d, off in enumerate(offsets):
        sh = xh[:, off - lo_off : off - lo_off + R]
        sl = xl[:, off - lo_off : off - lo_off + R]
        vh, vl = vals_hi[:, d], vals_lo[:, d]
        p, e = two_prod(vh, sh)
        e = e + (vh * sl + vl * sh)
        acc_h, c = two_sum(acc_h, p)
        acc_l = acc_l + (c + e)
    return quick_two_sum(acc_h, acc_l)


def ell_spmv_df(
    rows: torch.Tensor, cols: torch.Tensor, vals_hi: torch.Tensor,
    vals_lo: torch.Tensor, x: Pair, n_rows: int,
) -> Pair:
    """df64 SpMV of a compressed-row block (the layout of K5,
    ``ops/ghost_spmv.py``): rows ``[P, Nr]``, cols and the value pair
    ``[P, K, Nr]``, padding lanes at column -1.  Returns a pair of
    ``[P, n_rows]``, zero on the rows without entries.

    The reference's ``ell_spmv_df`` (``df64.py:271``), which it runs in XLA
    and not in a TPU kernel: the lane products are error-free, and the
    lanes of a row are accumulated in order with a compensated sum.  The
    products run over all lanes at once; only the accumulation loops over
    the K lanes."""
    P, K, Nr = cols.shape
    yh = vals_hi.new_zeros((P, n_rows))
    yl = vals_hi.new_zeros((P, n_rows))
    if Nr == 0 or K == 0 or x[0].shape[-1] == 0:
        return yh, yl
    live = cols >= 0
    idx = cols.clamp(min=0).reshape(P, K * Nr).to(torch.int64)

    def gather(v):
        g = torch.gather(v, 1, idx).reshape(P, K, Nr)
        return torch.where(live, g, torch.zeros_like(g))

    gh, gl = gather(x[0]), gather(x[1])
    p, e = two_prod(vals_hi, gh)
    e = e + (vals_hi * gl + vals_lo * gh)
    acc_h = vals_hi.new_zeros((P, Nr))
    acc_l = vals_hi.new_zeros((P, Nr))
    for k in range(K):
        acc_h, c = two_sum(acc_h, p[:, k])
        acc_l = acc_l + (c + e[:, k])
    sh, sl = quick_two_sum(acc_h, acc_l)
    # each live row gets exactly one value added to an exact zero; a
    # padding row (-1, all lanes padding) adds an exact zero to row 0
    flat = (torch.arange(P, device=rows.device).unsqueeze(1) * n_rows
            + rows.clamp(min=0)).reshape(-1).to(torch.int64)
    yh.view(-1).index_add_(0, flat, sh.reshape(-1))
    yl.view(-1).index_add_(0, flat, sl.reshape(-1))
    return yh, yl
