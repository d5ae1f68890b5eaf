"""Batched prime-field arithmetic on limb tensors (PyTorch).

Port of keyless_zk_tpu/fields/jax_field.py. An element is a little-endian
vector of 16 limbs of 16 bits, shape (..., 16), held as int32 (CPU torch has
no uint32 add, sub, shift or compare). Arithmetic widens to int64, where a
16x16-bit product and a sum of 16 of them are exact. Every op is batched
over the leading dims and has no data-dependent control flow, so the same
code runs on CPU and CUDA tensors.

Semantics match the JAX package exactly: Montgomery form with R = 2^256,
canonical reduction to [0, p). Outputs are canonical, so the two packages
agree bit for bit.

Carry resolution differs from the JAX Kogge-Stone scan but computes the
same thing: after two compression passes every column is < 2^17, so each
limb either generates a carry, kills one, or propagates its carry-in; the
carry into limb i is the generate bit of the nearest non-propagating limb
below i, found with one cummax over limb positions.

`mont_mul` and `mont_pow` dispatch through ops/cuda_field.py: a CUDA tensor
launches the hand-written kernel, a CPU tensor takes its plain version
(`mont_mul_plain` there, the port of `_mont_mul_xla`, built from the helpers
below, and `mont_pow_plain`, a loop over it).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from . import bn254
from .limbs import LIMB_BITS, LIMB_MASK, NUM_LIMBS, int_to_limbs, ints_to_limbs, limbs_to_ints

MASK = LIMB_MASK


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Host-side description of a prime field in limb form."""

    name: str
    p: int
    p_limbs: np.ndarray = field(init=False)
    n0_limbs: np.ndarray = field(init=False)  # -p^-1 mod 2^256 (full width)
    r_mod_p: int = field(init=False)  # R = 2^256 mod p  (Montgomery one)
    r2_mod_p: int = field(init=False)  # R^2 mod p
    r_inv: int = field(init=False)  # R^-1 mod p

    def __hash__(self):
        return hash((self.name, self.p))

    def __eq__(self, other):
        return isinstance(other, FieldSpec) and (self.name, self.p) == (other.name, other.p)

    def __post_init__(self):
        object.__setattr__(self, "p_limbs", int_to_limbs(self.p))
        R = 1 << (LIMB_BITS * NUM_LIMBS)
        object.__setattr__(self, "n0_limbs", int_to_limbs((-pow(self.p, -1, R)) % R))
        object.__setattr__(self, "r_mod_p", R % self.p)
        object.__setattr__(self, "r2_mod_p", (R * R) % self.p)
        object.__setattr__(self, "r_inv", pow(R, -1, self.p))

    def to_mont_int(self, x: int) -> int:
        return (x << (LIMB_BITS * NUM_LIMBS)) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.r_inv) % self.p


FQ = FieldSpec("fq", bn254.Q)
FR = FieldSpec("fr", bn254.R_SCALAR)


@functools.lru_cache(maxsize=64)
def _limb_const(value: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A host int as a (16,) limb tensor on `device` (cached: constants are
    immutable and a fresh host-to-device copy per op would stall the card)."""
    return torch.tensor(int_to_limbs(value).astype(np.int64), device=device, dtype=dtype)


def consts(spec: FieldSpec, value: int, shape=(), device="cpu") -> torch.Tensor:
    """Broadcast a host int (already in the desired representation) to a batch."""
    v = _limb_const(value % spec.p, torch.device(device), torch.int32)
    return v.expand(*shape, NUM_LIMBS)


# ---- carry machinery --------------------------------------------------------

def _shift(x: torch.Tensor, s: int, fill: int = 0) -> torch.Tensor:
    """Shift the limb axis toward higher indices by s, filling with `fill`."""
    if s == 0:
        return x
    return F.pad(x[..., :-s], (s, 0), value=fill)


def _carry(v: torch.Tensor, carry_in: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact carry resolution for int64 limbs with values < 2^17 - 1.

    Returns (normalized 16-bit limbs, carry-out of the top limb)."""
    g = v >> LIMB_BITS  # 0/1
    stop = (g != 0) | ((v & MASK) != MASK)
    pos = torch.arange(v.shape[-1], device=v.device).expand_as(v)
    last = torch.cummax(torch.where(stop, pos, -1), dim=-1).values
    gl = torch.gather(g, -1, last.clamp(min=0))
    cout = torch.where(last >= 0, gl, carry_in)  # carry out of each limb
    out = (v + _shift(cout, 1, carry_in)) & MASK
    return out, cout[..., -1]


def _normalize(cols: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """int64 columns of 16-bit weight (< 2^56) -> canonical 16-bit limbs,
    mod 2^(16*out_limbs)."""
    k = cols.shape[-1]
    if k < out_limbs:
        cols = F.pad(cols, (0, out_limbs - k))
    v = cols[..., :out_limbs]
    for _ in range(3):  # < 2^56 -> < 2^16 + 2^40 -> < 2^16 + 2^24 -> < 2^16 + 2^8
        v = (v & MASK) + _shift(v >> LIMB_BITS, 1)
    out, _ = _carry(v)
    return out


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook limb convolution of int64 limb vectors: (..., La) x (..., Lb)
    -> (..., La + Lb - 1) int64 columns (< 2^36 for 16-bit limbs).

    One windowed product: b reversed and zero-padded, unfolded into La-wide
    windows, so that column m pairs a[i] with b[m - i]. Few ops, which is
    what costs at the small batches this path serves."""
    la = a.shape[-1]
    win = F.pad(b.flip(-1), (la - 1, la - 1)).unfold(-1, la, 1)  # (..., la+lb-1, la)
    return (win * a[..., None, :]).sum(-1).flip(-1)


def _csub_p(limbs: torch.Tensor, spec: FieldSpec, overflow=None) -> torch.Tensor:
    """Conditionally subtract p: int64 canonical limbs (+ optional 0/1
    overflow limb) of a value < 2p -> int64 limbs < p."""
    pbar = MASK - _limb_const(spec.p, limbs.device, torch.int64)
    diff, carry = _carry(limbs + pbar, carry_in=1)
    geq = carry if overflow is None else carry + overflow
    return torch.where((geq >= 1)[..., None], diff, limbs)


def _redc(t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery reduction of a value < p*R given as int64 columns of
    16-bit weight (< 2^36 each, normalized or not): m = t * (-p^-1) mod R;
    (t + m*p) / R; one conditional subtract. The low 16 columns determine t
    mod R whether or not carries have been resolved."""
    dev = t.device
    n0 = _limb_const((-pow(spec.p, -1, 1 << 256)) % (1 << 256), dev, torch.int64)
    p_row = _limb_const(spec.p, dev, torch.int64)
    m = _normalize(_conv(t[..., :NUM_LIMBS], n0), NUM_LIMBS)
    width = 2 * NUM_LIMBS + 1
    mp = _conv(m, p_row)
    s = F.pad(mp, (0, width - mp.shape[-1])) + F.pad(t, (0, width - t.shape[-1]))
    s = _normalize(s, width)
    # t + m*p == 0 mod R exactly: the low 16 limbs vanish
    return _csub_p(s[..., NUM_LIMBS : 2 * NUM_LIMBS], spec, s[..., 2 * NUM_LIMBS])


# ---- limb-major path for large batches ----------------------------------------
#
# At a few hundred elements and up, the vectorized carry resolution above
# is dominated by its (N, 32)-wide temporaries. There the same arithmetic
# runs on limb-major (L, N) rows with a plain carry ripple: more, but
# contiguous and narrow, ops. Below the threshold the per-op cost dominates
# and the vectorized path's fewer ops win (CPU times on both sides, one
# thread: PERF.md, "Plain field ops"). The choice depends on the batch size
# only and both paths give the same canonical values. The large batches are
# the main path's (NTT levels, coefficient folds, the witness merges; on the
# card only the Montgomery product has a kernel, K1); the small ones are the
# plain group law at the lane counts of the CPU tests and of the final
# to-affine.

_ROWS_MIN = 512  # batch elements from which the limb-major path is taken


def _rows(a: torch.Tensor, shape) -> torch.Tensor:
    """(..., 16) limbs broadcast to `shape` -> (16, n) int64 rows."""
    return a.expand(shape).reshape(-1, NUM_LIMBS).T.long().contiguous()


def _ripple(cols: torch.Tensor, carry_in=0) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, n) int64 columns of 16-bit weight (< 2^40) -> canonical limbs and
    the carry out of the top one."""
    out = torch.empty_like(cols)
    c = carry_in
    for i in range(cols.shape[0]):
        v = cols[i] + c
        out[i] = v & MASK
        c = v >> LIMB_BITS
    return out, c


def _const_col(value: int, device) -> torch.Tensor:
    return _limb_const(value, device, torch.int64)[:, None]


def _csub_rows(res: torch.Tensor, spec: FieldSpec, top=0) -> torch.Tensor:
    d, c = _ripple(res + (MASK - _const_col(spec.p, res.device)), carry_in=1)
    return torch.where((c + top) >= 1, d, res)


def _redc_rows(t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """REDC of 32 limb rows (value < p*R, columns < 2^36, normalized or not)
    -> 16 rows < p."""
    n0 = _const_col((-pow(spec.p, -1, 1 << 256)) % (1 << 256), t.device)
    p_col = _const_col(spec.p, t.device)
    m = torch.zeros((NUM_LIMBS, t.shape[1]), dtype=torch.int64, device=t.device)
    for i in range(NUM_LIMBS):
        m[i:] += t[i] * n0[: NUM_LIMBS - i]
    m, _ = _ripple(m)  # mod R
    s = torch.zeros((2 * NUM_LIMBS + 1, t.shape[1]), dtype=torch.int64, device=t.device)
    s[: 2 * NUM_LIMBS] = t
    for i in range(NUM_LIMBS):
        s[i : i + NUM_LIMBS] += m[i] * p_col
    s, _ = _ripple(s)
    return _csub_rows(s[NUM_LIMBS : 2 * NUM_LIMBS], spec, s[2 * NUM_LIMBS])


def _mont_mul_rows(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec, shape, n: int) -> torch.Tensor:
    ar, br = _rows(a, shape), _rows(b, shape)
    cols = torch.zeros((2 * NUM_LIMBS, n), dtype=torch.int64, device=ar.device)
    for i in range(NUM_LIMBS):
        cols[i : i + NUM_LIMBS] += ar[i] * br
    return _redc_rows(cols, spec)  # unnormalized columns: see _redc


def _batch_size(a: torch.Tensor, b: torch.Tensor) -> tuple[tuple, int]:
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = 1
    for d in shape[:-1]:
        n *= d
    return shape, n


def _from_rows(rows: torch.Tensor, shape) -> torch.Tensor:
    return rows.T.reshape(shape).int()


def mont_mul_limbs(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a*b*R^-1 mod p in plain torch (full product, then REDC), broadcasting.
    The plain version of kernel K1 (see ops/cuda_field.mont_mul_plain)."""
    shape, n = _batch_size(a, b)
    if n >= _ROWS_MIN:
        return _from_rows(_mont_mul_rows(a, b, spec, shape, n), shape)
    return _redc(_conv(a.long(), b.long()), spec).int()


# ---- field ops ---------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(a + b) mod p for canonical inputs in [0, p)."""
    shape, n = _batch_size(a, b)
    if n >= _ROWS_MIN:
        s, _ = _ripple(_rows(a, shape) + _rows(b, shape))  # a + b < 2p < 2^256
        return _from_rows(_csub_rows(s, spec), shape)
    s, _ = _carry(a.long() + b.long())
    return _csub_p(s, spec).int()


def sub(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(a - b) mod p for canonical inputs in [0, p)."""
    shape, n = _batch_size(a, b)
    if n >= _ROWS_MIN:
        d, c = _ripple(_rows(a, shape) + (MASK - _rows(b, shape)), carry_in=1)  # c <=> a >= b
        d2, _ = _ripple(d + _const_col(spec.p, d.device))
        return _from_rows(torch.where(c >= 1, d, d2), shape)
    d, carry = _carry(a.long() + (MASK - b.long()), carry_in=1)  # carry <=> a >= b
    # wrapped case: d == a - b + 2^256; adding p and dropping 2^256 fixes it
    d2, _ = _carry(d + _limb_const(spec.p, d.device, torch.int64))
    return torch.where((carry >= 1)[..., None], d, d2).int()


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b, with mask of batch shape (no limb dim)."""
    return torch.where(mask[..., None], a, b)


def neg(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(-a) mod p; maps 0 to 0."""
    return torch.where(is_zero(a)[..., None], a, sub(torch.zeros_like(a), a, spec))


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p, canonical in and out, broadcasting.

    The operands are arranged so that the first has the full broadcast shape
    and the second repeats over its leading rows (the only broadcast the
    kernel takes); multiplication commutes, so swapping them is free."""
    from ..ops.cuda_field import mont_mul as kernel_mont_mul

    shape = torch.broadcast_shapes(a.shape, b.shape)
    if tuple(a.shape) != tuple(shape):
        a, b = b, a
    if tuple(a.shape) != tuple(shape):
        a = a.expand(shape)
    bs = list(b.shape)
    while len(bs) > 1 and bs[0] == 1:
        bs.pop(0)
    if len(bs) > len(shape) or tuple(shape[len(shape) - len(bs):]) != tuple(bs):
        b = b.expand(shape)
        bs = list(shape)
    return kernel_mont_mul(a.contiguous(), b.reshape(bs).contiguous(), spec)


def to_mont(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return mont_mul(a, consts(spec, spec.r2_mod_p, (), a.device), spec)


def from_mont(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return mont_mul(a, consts(spec, 1, (), a.device), spec)


def mont_pow(a: torch.Tensor, e: int, spec: FieldSpec) -> torch.Tensor:
    """a^e with a in Montgomery form (output Montgomery), e a host int.

    MSB-first square-and-multiply, dispatched through ops/cuda_field.py: a
    CUDA tensor runs the whole chain in one launch of `kzk_mont_pow`, a CPU
    tensor takes `mont_pow_plain` (one plain product per step)."""
    from ..ops.cuda_field import mont_pow as kernel_mont_pow

    return kernel_mont_pow(a.contiguous(), e, spec)


def mont_inv(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a^-1 in Montgomery form via Fermat (a^(p-2)); 0 maps to 0."""
    return mont_pow(a, spec.p - 2, spec)


# ---- exact modular segment sums ----------------------------------------------

def split8(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 16) 16-bit limbs -> (lo, hi) 8-bit halves as int64, for exact
    integer accumulation (terms <= 255 per column)."""
    v = values.long()
    return v & 0xFF, v >> 8


def fold_split8_mod(sum_lo: torch.Tensor, sum_hi: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Fold accumulated 8-bit-split column sums (int64, < 2^31 per column)
    back to canonical limbs mod p. Output scaled by R^-1 (one REDC)."""
    ext = 2 * NUM_LIMBS  # value < 2^23 * p < 2^278

    def at(arr, limb_offset):
        return F.pad(arr, (limb_offset, ext - NUM_LIMBS - limb_offset))

    # sum_lo = d0 + 2^16 d1; sum_hi * 2^8 = (hi & 0xFF) 2^8 + ((hi >> 8) & M) 2^16 + (hi >> 24) 2^32
    cols = (
        at(sum_lo & MASK, 0)
        + at(sum_lo >> LIMB_BITS, 1)
        + at((sum_hi & 0xFF) << 8, 0)
        + at((sum_hi >> 8) & MASK, 1)
        + at(sum_hi >> 24, 2)
    )
    n = cols.numel() // ext
    if n >= _ROWS_MIN:
        return _from_rows(_redc_rows(cols.reshape(n, ext).T.contiguous(), spec), (*cols.shape[:-1], NUM_LIMBS))
    return _redc(cols, spec).int()


def segment_diffs(vals: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Exact segment sums of an int64 (n, k) array partitioned by `bounds`
    (ascending positions): out[j] = vals[bounds[j]:bounds[j+1]].sum(0),
    returned as a (len(bounds) - 1, k) view.

    One cumsum, one boundary gather and a shifted difference. The scan runs
    along the last axis of the transposed array: on the card a cumsum along
    dim 0 of an (n, 16) array scans only 16 sequences in parallel and was
    seconds per call at a million rows."""
    s = F.pad(torch.cumsum(vals.T.contiguous(), dim=1), (1, 0))
    b = s.index_select(1, bounds.long())
    return (b[:, 1:] - b[:, :-1]).T


def sorted_segment_sum_mod(values: torch.Tensor, bounds: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Segment sums of a PRE-SORTED value sequence partitioned by `bounds`
    (k+1 ascending positions): out[k] = sum(values[bounds[k]:bounds[k+1]])
    mod p, scaled by R^-1 (the REDC of fold_split8_mod). values (m, ..., 16):
    axes between the first and the limbs are independent columns.

    The int64 cumsum makes the differences exact without the JAX version's
    u32 wrap-around."""
    m = values.shape[0]

    def sums(v):
        return segment_diffs(v.reshape(m, -1), bounds).reshape(-1, *values.shape[1:])

    lo, hi = split8(values)
    return fold_split8_mod(sums(lo), sums(hi), spec)


# ---- host-side conversions ---------------------------------------------------

def encode_ints(xs, spec: FieldSpec, mont: bool = False, device="cpu") -> torch.Tensor:
    """Host ints -> limb batch (int32), optionally into Montgomery form."""
    if mont:
        xs = [spec.to_mont_int(x % spec.p) for x in xs]
    else:
        xs = [x % spec.p for x in xs]
    return torch.from_numpy(ints_to_limbs(xs).astype(np.int32)).to(device)


def decode_ints(arr: torch.Tensor, spec: FieldSpec, mont: bool = False) -> list[int]:
    """Limb batch -> host ints, optionally out of Montgomery form."""
    vals = limbs_to_ints(np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr).astype(np.int64))
    if mont:
        vals = [spec.from_mont_int(v) for v in vals]
    return vals
