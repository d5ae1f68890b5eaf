"""K10: the NTT over BN254 Fr as shared-memory butterfly passes
(csrc/ntt.cu), the plan that runs it, its plain version and its wrapper.

The plan (`CudaNTTPlan`) has the interface of ops/ntt.py's `NTTPlan`
(`ntt`, `intt`, `coset_powers`; natural order in and out, (..., n, 16) int32
Montgomery limbs) and one more method, `h_scalars`: the prover's iNTT ->
coset shift -> NTT chain over the a|b vectors, fused into the passes. The
prover takes it on every device and for every domain (groth16/prover.py
`Groth16Prover`); on the card it replaces the matmul NTT (ops/mxu_ntt.py,
with K8).

A transform of n = 2^D points runs as P passes (`split`: D cut into P
parts of at most MAX_LOG bits, as even as they go), each one launch of
the wrapper `ntt_pass`: pass p runs an N_p-point DIF butterfly DFT over
every line of points S_p = N_(p+1) * ... apart, in shared memory, and
then, except in the last pass, multiplies output k of the line at offset
`suf` by the four-step twiddle w_M^(suf * k) (M = N_p * S_p), the product
of two small tables' entries; the last pass writes its lines' outputs to
their natural indices. Between passes the
elements are 8 32-bit words each (`pack_words`), at the boundary 16 limbs.

`ntt_pass` dispatches on its tensors' device: a CPU tensor takes the plain
version `ntt_pass_plain`, which walks the same pass in whole-tensor torch
ops (the kernel's split, tables, stage order and bit-reversed positions
in the line); a CUDA tensor launches the kernel or raises. So the plan on
the CPU is a simulation of the kernel's passes, and the tests hold it
against the JAX package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as devices
from ..fields import bn254
from ..fields import torch_field as tf
from ..fields.limbs import NUM_LIMBS
from ..fields.torch_field import FR
from . import _build
from .cuda_eval_ab import WORDS, pack_words, unpack_words
from .ntt import geometric_powers

# the most points a pass's line holds: 2^11 elements of 32 bytes = 64 KB of
# shared memory
MAX_LOG = 11
# elements a block holds in shared memory (csrc/ntt.cu): lines of a vector
# side by side up to this many, or three vectors' lines in the h chain's
# last pass
TILE = 1 << 11

# formats of a pass's input and output (csrc/ntt.cu InFormat, OutFormat)
IN_WORDS, IN_LIMBS, IN_AB = 0, 1, 2
OUT_WORDS, OUT_LIMBS, OUT_H = 0, 1, 2
SCALE_NONE, SCALE_CONST, SCALE_TABLE = 0, 1, 2


def split(domain_pow: int, max_log: int = MAX_LOG) -> list[int]:
    """log2 of each pass's line: ceil(domain_pow / max_log) passes (at least
    one), the bits spread as evenly as they go, the first passes the larger."""
    passes = max(1, -(-domain_pow // max_log))
    base, extra = divmod(domain_pow, passes)
    return [base + (i < extra) for i in range(passes)]


@dataclass
class NttPass:
    """One pass of one direction of a 2^log_n transform.

    log_line: L, the line's 2^L points; log_stride: log2 of the distance
    between them (0 in the last pass); la, lb: the last pass's line of
    prefix t is ((t mod 2^la) << lb) | (t >> la); line: (max(1, N/2), 8)
    words w_N^i; lo (2^lo_bits, 8), hi (M >> lo_bits, 8): w_M^i and
    w_M^(i << lo_bits), the four-step twiddle's two factors (None in the
    last pass)."""

    log_n: int
    log_line: int
    log_stride: int
    la: int
    lb: int
    line: torch.Tensor
    lo: torch.Tensor | None
    hi: torch.Tensor | None
    lo_bits: int

    @property
    def final(self) -> bool:
        return self.lo is None


def _powers_words(base: int, m: int, device) -> torch.Tensor:
    """[1, g, ..., g^(m-1)] as (m, 8) Montgomery words, built on `device`."""
    return pack_words(geometric_powers(tf.encode_ints([base], FR, mont=True, device=device)[0], m))


def build_passes(domain_pow: int, w: int, device, max_log: int = MAX_LOG) -> list[NttPass]:
    """The passes of a 2^domain_pow transform with root w (w^-1 for the
    inverse), tables on `device`."""
    logs = split(domain_pow, max_log)
    p_int = FR.p
    passes = []
    for i, lp in enumerate(logs):
        log_stride = sum(logs[i + 1 :])
        log_m = lp + log_stride
        w_m = pow(w, 1 << (domain_pow - log_m), p_int)  # primitive 2^log_m-th root
        line = _powers_words(pow(w_m, 1 << log_stride, p_int), max(1, (1 << lp) >> 1), device)
        lo = hi = None
        lo_bits = 0
        if i + 1 < len(logs):
            lo_bits = (log_m + 1) // 2
            lo = _powers_words(w_m, 1 << lo_bits, device)
            hi = _powers_words(pow(w_m, 1 << lo_bits, p_int), 1 << (log_m - lo_bits), device)
        la, lb = (logs[0], logs[1]) if len(logs) == 3 else (logs[0], 0) if len(logs) == 2 else (0, 0)
        passes.append(NttPass(domain_pow, lp, log_stride, la, lb, line, lo, hi, lo_bits))
    return passes


def _bit_reverse(bits: int) -> torch.Tensor:
    idx = np.arange(1 << bits)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return torch.from_numpy(rev)


def ntt_pass_plain(src: torch.Tensor, p: NttPass, batch: int, in_format: int, out_format: int,
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    """One pass in whole-tensor torch ops, in the kernel's order: the lines
    gathered as the kernel's blocks hold them, the DIF stages (twiddle
    w_N^(j << s), none in the last stage), the outputs read from their
    bit-reversed positions, then the four-step twiddle (a middle pass) or
    the scale and the natural-order write (the last pass)."""
    n, lp = 1 << p.log_n, p.log_line
    nl, s_len = 1 << lp, 1 << p.log_stride
    dev = src.device
    if in_format == IN_AB:
        a, b = src[:n], src[n:]
        x = torch.stack([a, b, tf.mont_mul(a, b, FR)])
    elif in_format == IN_WORDS:
        x = unpack_words(src)
    else:
        x = src
    if p.final:  # (batch, line prefix t, point, 1): the line of prefix t
        t = torch.arange(n >> lp, device=dev)
        lines = ((t & ((1 << p.la) - 1)) << p.lb) | (t >> p.la)
        v = x.reshape(batch, n >> lp, nl, 1, NUM_LIMBS).index_select(1, lines)
    else:  # (batch, prefix, point, suffix)
        v = x.reshape(batch, n // (nl * s_len), nl, s_len, NUM_LIMBS)
    line = unpack_words(p.line)
    for s in range(lp):
        half = nl >> (s + 1)
        u = v.reshape(*v.shape[:2], nl // (2 * half), 2, half, *v.shape[3:])
        e, o = u[:, :, :, 0], u[:, :, :, 1]
        hi = tf.sub(e, o, FR)
        if half > 1:
            hi = tf.mont_mul(hi, line[torch.arange(half, device=dev) << s][:, None, :], FR)
        v = torch.stack([tf.add(e, o, FR), hi], dim=3).reshape(v.shape)
    v = v.index_select(2, _bit_reverse(lp).to(dev))  # output k from position bitrev(k)
    if not p.final:
        ex = (torch.arange(nl, device=dev)[:, None] * torch.arange(s_len, device=dev)[None, :]).reshape(-1)
        tw = tf.mont_mul(unpack_words(p.lo[ex & ((1 << p.lo_bits) - 1)]), unpack_words(p.hi[ex >> p.lo_bits]), FR)
        out = tf.mont_mul(v, tw.reshape(nl, s_len, NUM_LIMBS), FR).reshape(batch, n, NUM_LIMBS)
    else:  # output k of the line of prefix t is element t + (n / N) * k
        if scale is not None:
            sc = unpack_words(scale)
            sc = sc if sc.shape[0] == 1 else sc.reshape(nl, n >> lp, NUM_LIMBS).transpose(0, 1)[:, :, None]
            v = tf.mont_mul(v, sc, FR)
        out = v.reshape(batch, n >> lp, nl, NUM_LIMBS).transpose(1, 2).reshape(batch, n, NUM_LIMBS)
    if out_format == OUT_H:
        out = tf.from_mont(tf.sub(tf.mont_mul(out[0], out[1], FR), out[2], FR), FR)
    elif out_format == OUT_WORDS:
        out = pack_words(out)
    return out.contiguous()


def _expected_src(p: NttPass, batch: int, in_format: int) -> tuple:
    n = 1 << p.log_n
    if in_format == IN_AB:
        return (2 * n, NUM_LIMBS)
    return (batch, n, WORDS if in_format == IN_WORDS else NUM_LIMBS)


@_build.counted
def ntt_pass(src: torch.Tensor, p: NttPass, batch: int, in_format: int, out_format: int,
             scale: torch.Tensor | None = None) -> torch.Tensor:
    """One pass of K10 over `batch` vectors. src: (batch, n, 8) int32 words,
    (batch, n, 16) int32 limbs, or with IN_AB the (2n, 16) a|b vectors
    (batch 3: a, b, a * b). Returns (batch, n, 8) words, (batch, n, 16)
    limbs, or with OUT_H (last pass, batch 3) h = A * B - C out of
    Montgomery form, (n, 16). scale (last pass): None, (1, 8) or (n, 8)
    words by the natural output index."""
    n = 1 << p.log_n
    if src.dtype != torch.int32:
        raise TypeError("ntt_pass: the input must be int32")
    if (in_format == IN_AB or out_format == OUT_H) and batch != 3:
        raise ValueError("ntt_pass: the a|b input and the h output take a batch of 3")
    if out_format == OUT_H and not p.final:
        raise ValueError("ntt_pass: h is written by the last pass")
    if scale is not None and (not p.final or scale.shape not in ((1, WORDS), (n, WORDS))):
        raise ValueError("ntt_pass: a scale is one entry or n entries of the last pass")
    if tuple(src.shape) != _expected_src(p, batch, in_format):
        raise ValueError(f"ntt_pass: input shape {tuple(src.shape)}, not {_expected_src(p, batch, in_format)}")
    if not src.is_contiguous():
        raise ValueError("ntt_pass: the input must be contiguous")
    if src.device != p.line.device or (scale is not None and scale.device != src.device):
        raise ValueError(f"ntt_pass: input on {src.device}, tables on {p.line.device}")
    if src.device.type == "cpu":
        return ntt_pass_plain(src, p, batch, in_format, out_format, scale)
    if src.device.type != "cuda":
        raise ValueError(f"ntt_pass: tensor on {src.device}")
    vecs = 3 if out_format == OUT_H else 1
    per_block = (n >> p.log_line) if p.final else (1 << p.log_stride)
    log_cols = min(per_block.bit_length() - 1, max(0, (TILE // (vecs << p.log_line)).bit_length() - 1))
    if out_format == OUT_H:
        out = torch.empty((n, NUM_LIMBS), dtype=torch.int32, device=src.device)
    else:
        out = torch.empty((batch, n, WORDS if out_format == OUT_WORDS else NUM_LIMBS), dtype=torch.int32,
                          device=src.device)
    scale_mode = SCALE_NONE if scale is None else SCALE_CONST if scale.shape[0] == 1 else SCALE_TABLE

    def ptr(t):
        return None if t is None else t.data_ptr()

    ntt_pass.launches += 1
    err = _build.library().kzk_ntt_pass(
        src.data_ptr(), out.data_ptr(), n, batch, vecs, p.log_line, p.log_stride, int(p.final), p.la, p.lb,
        log_cols, p.line.data_ptr(), ptr(p.lo), ptr(p.hi), p.lo_bits, ptr(scale), scale_mode,
        in_format, out_format, torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(err, "ntt_pass")
    return out


class CudaNTTPlan:
    """K10's passes for one 2^domain_pow domain, tables resident on `device`
    (the card unless the caller asks for the CPU, where every pass runs its
    plain version). `max_log` caps a pass's line (MAX_LOG, the kernel's
    shared memory; the tests lower it to force more passes)."""

    def __init__(self, domain_pow: int, device=devices.DEFAULT, max_log: int = MAX_LOG):
        if domain_pow > bn254.TWO_ADICITY:
            raise ValueError("domain size too big for the curve")
        self.domain_pow = domain_pow
        self.n = 1 << domain_pow
        self.device = devices.resolve(device)
        w = bn254.fr_root_of_unity(domain_pow)
        self.passes = build_passes(domain_pow, w, self.device, max_log)
        self.passes_inv = build_passes(domain_pow, pow(w, -1, FR.p), self.device, max_log)
        self.n_inv = pack_words(tf.encode_ints([pow(self.n, -1, FR.p)], FR, mont=True, device=self.device))
        self._coset = None
        self._coset_n_inv = None

    def _run(self, x: torch.Tensor, passes: list[NttPass], batch: int, in_format: int, out_format: int,
             scale: torch.Tensor | None) -> torch.Tensor:
        for i, p in enumerate(passes):
            last = i == len(passes) - 1
            x = ntt_pass(x, p, batch, in_format if i == 0 else IN_WORDS, out_format if last else OUT_WORDS,
                         scale if last else None)
        return x

    def _transform(self, x: torch.Tensor, passes: list[NttPass], scale: torch.Tensor | None) -> torch.Tensor:
        shape = x.shape
        flat = x.reshape(-1, self.n, NUM_LIMBS).contiguous()
        return self._run(flat, passes, flat.shape[0], IN_LIMBS, OUT_LIMBS, scale).reshape(shape)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        return self._transform(x, self.passes, None)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        return self._transform(x, self.passes_inv, self.n_inv)

    def coset_powers(self) -> torch.Tensor:
        """eta^i for i < n, eta the 2^(domain_pow+1)-th root of unity, (n, 16)
        limbs. Memoized."""
        if self._coset is None:
            eta = bn254.fr_root_of_unity(self.domain_pow + 1)
            self._coset = geometric_powers(tf.encode_ints([eta], FR, mont=True, device=self.device)[0], self.n)
        return self._coset

    def h_scalars(self, ab: torch.Tensor) -> torch.Tensor:
        """The a|b vectors (2n, 16) -> the MSM_H scalars (n, 16), out of
        Montgomery form: c = a * b in the first pass's load, the iNTT of
        (a, b, c) with n^-1 and the coset shift (groth16.cpp:182-190) in
        its last pass's store, the NTT, and h = A * B - C with from_mont
        in the last pass's store (groth16.cpp:264-279)."""
        if self._coset_n_inv is None:
            self._coset_n_inv = pack_words(tf.mont_mul(self.coset_powers(), unpack_words(self.n_inv), FR))
        x = self._run(ab.contiguous(), self.passes_inv, 3, IN_AB, OUT_WORDS, self._coset_n_inv)
        return self._run(x, self.passes, 3, IN_WORDS, OUT_H, None)


@functools.lru_cache(maxsize=4)
def get_cuda_plan(domain_pow: int, device=devices.DEFAULT) -> CudaNTTPlan:
    return CudaNTTPlan(domain_pow, device)
