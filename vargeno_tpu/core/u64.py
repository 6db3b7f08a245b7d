"""64-bit integer arithmetic as (hi, lo) uint32 pairs for the device path.

JAX runs with 64-bit types disabled by default, so every 64-bit quantity in
the device compute path is carried as a pair of uint32 arrays ``(hi, lo)``
with value ``hi * 2**32 + lo``.

These helpers are pure jnp ops (add/mul/xor/shift on uint32), so they work in
any jitted code, and they vectorize over any leading batch shape.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_U32 = jnp.uint32
# numpy scalar, NOT jnp: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed.initialize ordering
_MASK16 = np.uint32(0xFFFF)


def u64(hi, lo):
    """Bundle a (hi, lo) pair; purely a documentation aid."""
    return (jnp.asarray(hi, _U32), jnp.asarray(lo, _U32))


def from_py(x: int):
    return (jnp.uint32((x >> 32) & 0xFFFFFFFF), jnp.uint32(x & 0xFFFFFFFF))


def xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def shr(a, n: int):
    """Logical right shift by a static amount 0 <= n < 64."""
    hi, lo = a
    if n == 0:
        return (hi, lo)
    if n < 32:
        new_lo = (lo >> n) | (hi << (32 - n))
        new_hi = hi >> n
        return (new_hi, new_lo)
    if n == 32:
        return (jnp.zeros_like(hi), hi)
    return (jnp.zeros_like(hi), hi >> (n - 32))


def shl(a, n: int):
    """Left shift (mod 2**64) by a static amount 0 <= n < 64."""
    hi, lo = a
    if n == 0:
        return (hi, lo)
    if n < 32:
        new_hi = (hi << n) | (lo >> (32 - n))
        new_lo = lo << n
        return (new_hi, new_lo)
    if n == 32:
        return (lo, jnp.zeros_like(lo))
    return (lo << (n - 32), jnp.zeros_like(lo))


def add(a, b):
    """(a + b) mod 2**64."""
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(_U32)
    hi = a[0] + b[0] + carry
    return (hi, lo)


def _mul32_wide(a, b):
    """Full 32x32 -> 64 multiply of uint32 arrays, via 16-bit limbs."""
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    # partial products, each < 2**32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    # mid = p01 + p10 + (p00 >> 16); may carry into bit 33
    mid = p01 + (p00 >> 16)
    carry1 = (mid < p01).astype(_U32)
    mid2 = mid + p10
    carry2 = (mid2 < mid).astype(_U32)
    lo = (p00 & _MASK16) | (mid2 << 16)
    hi = p11 + (mid2 >> 16) + ((carry1 + carry2) << 16)
    return (hi, lo)


def mul(a, b):
    """(a * b) mod 2**64 for two u64 pairs."""
    hi, lo = _mul32_wide(a[1], b[1])
    hi = hi + a[1] * b[0] + a[0] * b[1]
    return (hi, lo)


def mod_u31(a, m: int, nbits: int = 64):
    """a mod m where m is a static Python int < 2**31.

    Restoring binary long division over the top ``nbits`` bits of ``a``.
    Vector-friendly: ``nbits`` unrolled steps of shift/compare/subtract on
    uint32 lanes. Use a smaller ``nbits`` when the value is known to fit.
    """
    assert 0 < m < (1 << 31)
    hi, lo = a
    mm = jnp.uint32(m)
    r = jnp.zeros_like(lo)
    for i in range(nbits - 1, -1, -1):
        bit = ((hi >> (i - 32)) if i >= 32 else (lo >> i)) & jnp.uint32(1)
        r = (r << 1) | bit
        r = jnp.where(r >= mm, r - mm, r)
    return r


def _add_c(a, b):
    """u64 pair addition with carry-out (0/1 uint32)."""
    lo = a[1] + b[1]
    c = (lo < a[1]).astype(_U32)
    hi = a[0] + b[0]
    c_hi = (hi < a[0]).astype(_U32)
    hi2 = hi + c
    c_hi2 = (hi2 < hi).astype(_U32)
    return (hi2, lo), c_hi + c_hi2


def _mulhi64(a, b):
    """floor(a*b / 2**64) of two u64 pairs, as a u64 pair."""
    a1, a0 = a
    b1, b0 = b
    t0 = _mul32_wide(a0, b0)
    t1 = _mul32_wide(a0, b1)
    t2 = _mul32_wide(a1, b0)
    t3 = _mul32_wide(a1, b1)
    # mid = t1 + t2 + (t0 >> 32); < 3 * 2**64, carries counted explicitly
    m1, c1 = _add_c(t1, t2)
    m2, c2 = _add_c(m1, (jnp.zeros_like(a0), t0[0]))
    cc = c1 + c2                       # 0..2 -> bits [64,65] of mid
    # hi128 = t3 + (mid >> 32)  where mid >> 32 = (cc<<32 | m2hi) : m2lo>>32
    mid_hi = (cc, m2[0])               # u64: floor(mid / 2**32)
    out, _ = _add_c(t3, mid_hi)
    return out


def mod_const(a, m: int):
    """Exact ``a mod m`` for a u64 pair ``a`` and a static int 1 < m < 2**31.

    Reciprocal multiply-high: with s = ceil(log2 m) and
    M = floor(2**(64+s) / m), q_hat = floor(a*M / 2**(64+s)) satisfies
    q - 2 <= q_hat <= q (q = floor(a/m)): a*M <= a*2**(64+s)/m gives the
    upper bound, and a*M > a*2**(64+s)/m - a with a/2**(64+s) < 2**-s <= 1
    gives the lower.  Two conditional subtracts finish.  ~35 vector ops
    replacing the 64-step restoring division (mod_u31).
    """
    assert 1 < m < (1 << 31)
    if m & (m - 1) == 0:  # power of two
        return a[1] & _U32(m - 1)
    s = max(1, (m - 1).bit_length())
    M = ((1 << (64 + s)) // m)
    if M < (1 << 64):
        q = shr(_mulhi64(a, from_py(M)), s)
    else:
        # M in [2**64, 2**65): aM/2**64 = a*(M - 2**64)/2**64 + a; the +a
        # may carry past 2**64, injected back above the shift.  Nested
        # flooring costs at most one more unit: q - q_hat <= 3.
        h = _mulhi64(a, from_py(M - (1 << 64)))
        ssum, carry = _add_c(h, a)
        q = shr(ssum, s)
        # the carry contributes carry * 2**(64 - s) to q
        if (64 - s) >= 32:
            q = (q[0] + (carry << (64 - s - 32)), q[1])
        else:
            q, _ = _add_c(q, (jnp.zeros_like(carry), carry << (64 - s)))
    qm = mul(q, from_py(m))            # q*m <= a < 2**64: low 64 exact
    # r = a - q*m  (fits u64; r < 4m < 2**33)
    borrow = (a[1] < qm[1]).astype(_U32)
    r_lo = a[1] - qm[1]
    r_hi = a[0] - qm[0] - borrow
    mm = _U32(m)
    for _ in range(3):
        ge = (r_hi > 0) | (r_lo >= mm)
        new_lo = r_lo - mm
        new_hi = r_hi - (r_lo < mm).astype(_U32)
        r_lo = jnp.where(ge, new_lo, r_lo)
        r_hi = jnp.where(ge, new_hi, r_hi)
    return r_lo


def to_u64_np(pair):
    """Host-side: reassemble a numpy uint64 from a (hi, lo) pair."""
    import numpy as np

    hi = np.asarray(pair[0], dtype=np.uint64)
    lo = np.asarray(pair[1], dtype=np.uint64)
    return (hi << np.uint64(32)) | lo
