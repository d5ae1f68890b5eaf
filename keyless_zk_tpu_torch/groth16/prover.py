"""Groth16 prover (PyTorch): port of keyless_zk_tpu/groth16/prover.py.

Per proof, on the prover's device:

  1. upload the witness (n_vars, 16) limbs;
  2. sum the scalars of duplicate table rows (`_merge_scalars`);
  3. four MSMs over the witness (A, B1, C on G1; B2 on G2)   [ops/msm.py]
  4. the h scalars (`_h_scalars`): coefficient-table evaluation into the
     a|b vectors [ops/cuda_eval_ab.py], c = a*b, one batched (3, n)
     iNTT -> coset shift -> NTT, h = a*b - c, from_mont
                                         [ops/cuda_ntt.py on the card: K10's
                                          butterfly passes, the chain fused
                                          into them; ops/ntt.py on the CPU]
  5. the H MSM;
  6. decode the five results to affine (one batched inversion per group,
     one readback each);

then a host tail blinds with r, s (groth16.cpp:288-353) in native code
(`blind`); `blind_plain`, the same in host ints, is the tests' oracle.

The polynomial phase runs in the reference's raw representation exactly as
the JAX package does (coefficients pre-scaled by R^2 at load), so the
output of every phase equals the JAX package's bit for bit. The JAX package's
compact witness upload (`_witness_to_device`) is not carried over: the
witness goes up as dense (n_vars, 16) limbs after a check that every limb
is below 2^16.

On a CUDA device each phase of `prove` is timed with CUDA events into
`phase_ms` (milliseconds, read after the proof's final readback).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as devices
from ..curves import ref_curve
from ..curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from ..fields import bn254
from ..fields import torch_field as tf
from ..fields.limbs import NUM_LIMBS
from ..fields.torch_field import FR
from ..ops import cuda_eval_ab
from ..ops.cuda_ntt import CudaNTTPlan, get_cuda_plan
from ..ops.msm import msm
from ..ops.ntt import NTTPlan
from . import pairing_native
from .zkey import ProvingKey


@dataclass
class Proof:
    """Proof points in standard-form host ints, snarkjs shapes."""

    pi_a: tuple
    pi_b: tuple
    pi_c: tuple

    def to_json_dict(self) -> dict:
        """snarkjs proof JSON (reference groth16.cpp:362-410)."""
        return {
            "pi_a": [str(self.pi_a[0]), str(self.pi_a[1]), "1"],
            "pi_b": [
                [str(self.pi_b[0][0]), str(self.pi_b[0][1])],
                [str(self.pi_b[1][0]), str(self.pi_b[1][1])],
                ["1", "0"],
            ],
            "pi_c": [str(self.pi_c[0]), str(self.pi_c[1]), "1"],
            "protocol": "groth16",
        }


# Window bits of the four witness MSMs. Their scalars are ~94% bit-valued,
# so the stream length is nearly independent of c while the bucket tables
# (and K6's walk over them) grow as ceil(254/c) * 2^(c-1): a narrower
# window than the dense-optimal one. The H MSM's uniform scalars take
# ops.msm.fused_window_bits.
_SPARSE_C = 12


def _dedup_point_table(x: np.ndarray, y: np.ndarray, inf: np.ndarray):
    """Collapse duplicate rows of a point table (host numpy).

    Two copies of one point adjacent in a bucket run would hit the P == Q
    case the scan's mixed add skips (csrc/ec.cuh madd_core), so the prover sums
    the duplicate rows' scalars instead (correct by bilinearity).

    Returns ((ux, uy, uinf), merge) where merge is None when the table has
    no duplicates, else (order, bounds, n_unique) host arrays for a sorted
    segment-sum of scalars (out[k] = sum of scalars whose row maps to k).
    """
    n = inf.shape[0]
    flat = np.concatenate(
        [
            np.ascontiguousarray(x).reshape(n, -1),
            np.ascontiguousarray(y).reshape(n, -1),
            inf.reshape(n, 1).astype(x.dtype),
        ],
        axis=1,
    )
    view = np.ascontiguousarray(flat).view([("", flat.dtype)] * flat.shape[1])
    _, first_idx, inv = np.unique(view.ravel(), return_index=True, return_inverse=True)
    n_unique = first_idx.shape[0]
    if n_unique == n:
        return (x, y, inf), None
    order = np.argsort(inv, kind="stable").astype(np.int64)
    seg = inv[order].astype(np.int64)
    bounds = np.searchsorted(seg, np.arange(n_unique + 1)).astype(np.int64)
    return (x[first_idx], y[first_idx], inf[first_idx]), (order, bounds, int(n_unique))


def _sample_fr() -> int:
    """Rejection-sample a uniform scalar < r (groth16.cpp:288-316)."""
    while True:
        v = int.from_bytes(secrets.token_bytes(32), "little") & ((1 << 254) - 1)
        if v < bn254.R_SCALAR:
            return v


def _limbs(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)


def _pick_plan(domain_pow: int, device: torch.device):
    """K10's plan (ops/cuda_ntt.py) on the card, for every domain; the
    butterfly plan on the CPU. Decided by the device, as the JAX package
    decides by backend (keyless_zk_tpu/groth16/prover.py `_pick_plan`)."""
    if device.type == "cuda":
        return get_cuda_plan(domain_pow, device)
    return NTTPlan(domain_pow, device)


class Groth16Prover:
    """Proving key resident on `device` (the card unless the caller asks
    for the CPU) + the prove pipeline.

    Construct once per key, call :meth:`prove` per witness. After a proof,
    `last_h` holds its h scalars (the MSM_H input, for checks such as the
    discrete-log oracle) and, on a CUDA device, `phase_ms` its phase times."""

    def __init__(self, pk: ProvingKey, device=devices.DEFAULT):
        if pk.q != bn254.Q or pk.r != bn254.R_SCALAR:
            raise ValueError("zkey curve is not BN254")  # fullprover.cpp:154-158
        if not pairing_native.available():  # `blind` needs it: built now, not inside the first proof
            raise RuntimeError(f"native pairing unavailable: {pairing_native.build_error()}")
        self.pk = pk
        self.device = devices.resolve(device)
        self.domain_pow = (pk.domain_size - 1).bit_length()
        if (1 << self.domain_pow) != pk.domain_size:
            raise ValueError("domain size must be a power of two")
        self.plan = _pick_plan(self.domain_pow, self.device)
        self.phase_ms: dict[str, float] = {}
        self.last_h: torch.Tensor | None = None
        dev = self.device

        def dedup_dev(x, y, inf):
            (ux, uy, uinf), merge = _dedup_point_table(x, y, inf)
            if merge is not None:
                order, bounds, nu = merge
                merge = (torch.from_numpy(order).to(dev), torch.from_numpy(bounds).to(dev), nu)
            return (_limbs(ux, dev), _limbs(uy, dev), torch.from_numpy(np.asarray(uinf, bool)).to(dev)), merge

        self.points_a, self._merge_a = dedup_dev(pk.points_a.x, pk.points_a.y, pk.points_a.inf)
        self.points_b1, self._merge_b1 = dedup_dev(pk.points_b1.x, pk.points_b1.y, pk.points_b1.inf)
        self.points_b2, self._merge_b2 = dedup_dev(pk.points_b2.x, pk.points_b2.y, pk.points_b2.inf)
        # Front-pad C with nPublic+1 infinity rows: pointsC[i] pairs with
        # wtns[i + nPublic + 1] (groth16.cpp:104-112), so row i pairs with w[i]
        pad_c = pk.n_vars - pk.points_c.x.shape[0]
        self.points_c, self._merge_c = dedup_dev(
            np.pad(pk.points_c.x, [(pad_c, 0), (0, 0)]),
            np.pad(pk.points_c.y, [(pad_c, 0), (0, 0)]),
            np.pad(pk.points_c.inf, [(pad_c, 0)], constant_values=True),
        )
        self.points_h, self._merge_h = dedup_dev(pk.points_h.x, pk.points_h.y, pk.points_h.inf)

        # Coefficient table sorted by destination row once (host), laid out
        # for the coefficient evaluation (ops/cuda_eval_ab.py: K9 on the
        # card, its plain version on the CPU)
        dest = pk.coef_m.astype(np.int64) * pk.domain_size + pk.coef_c
        order = np.argsort(dest, kind="stable")
        self.coef_table = cuda_eval_ab.coef_table(2 * pk.domain_size, dest[order], pk.coef_s[order], pk.coef_val,
                                                  order, dev)
        self.coset = self.plan.coset_powers()

    # ---- device phases -------------------------------------------------

    @staticmethod
    def _merge_scalars(scalars: torch.Tensor, merge) -> torch.Tensor:
        """Sum the scalars of duplicate table rows (see _dedup_point_table),
        for (n, 16) scalars or a batch (B, n, 16) at once (the batch's
        columns ride along in one segment sum). Lifting to Montgomery form
        first cancels the segment sum's REDC: sum(w*R) * R^-1 = sum(w) mod r."""
        if merge is None:
            return scalars
        order, bounds, _ = merge
        vals = tf.to_mont(scalars.movedim(-2, 0).index_select(0, order), FR)  # (m, ..., 16)
        return tf.sorted_segment_sum_mod(vals, bounds, FR).movedim(0, -2)

    def _eval_ab(self, witness: torch.Tensor) -> torch.Tensor:
        """witness -> concatenated a|b evaluation vectors (2*domain, 16)
        (replaces the reference's 1024-spinlock scatter, groth16.cpp:135-156)."""
        return cuda_eval_ab.eval_ab(witness, self.coef_table)

    def _h_scalars(self, witness: torch.Tensor) -> torch.Tensor:
        """Witness -> MSM_H scalar vector (the NTT phase), on the device.
        Under K10's plan the chain after the evaluation runs fused into the
        plan's passes (`CudaNTTPlan.h_scalars`)."""
        n = self.pk.domain_size
        ab = self._eval_ab(witness)
        if isinstance(self.plan, CudaNTTPlan):
            return self.plan.h_scalars(ab)
        a, b = ab[:n], ab[n:]
        c = tf.mont_mul(a, b, FR)
        # one batched (3, n, 16) iNTT -> coset shift -> NTT sweep
        abc = self.plan.intt(torch.stack([a, b, c]))
        abc = tf.mont_mul(abc, self.coset, FR)  # shift: groth16.cpp:182-190
        abc = self.plan.ntt(abc)
        h = tf.sub(tf.mont_mul(abc[0], abc[1], FR), abc[2], FR)
        return tf.from_mont(h, FR)  # groth16.cpp:264-279

    def _msm(self, table, scalars: torch.Tensor, curve, c: int | None = None) -> JacPoint:
        """One MSM of `prove` over a resident point table (the sharded
        prover spreads it over a process group)."""
        return msm(*table, scalars, curve=curve, c=c)

    # ---- full prove ------------------------------------------------------

    def prove(self, witness_limbs: np.ndarray, r: int | None = None, s: int | None = None) -> Proof:
        """witness_limbs: (nVars, 16) standard-form 16-bit limb rows."""
        wl = check_witness_limbs(self.pk, witness_limbs)
        timer = PhaseTimer(self.device)
        w = _limbs(wl, self.device)
        timer.mark("upload")
        wa = self._merge_scalars(w, self._merge_a)
        wb1 = self._merge_scalars(w, self._merge_b1)
        wb2 = self._merge_scalars(w, self._merge_b2)
        wc = self._merge_scalars(w, self._merge_c)
        timer.mark("merges")
        msm_a = self._msm(self.points_a, wa, G1_CURVE, c=_SPARSE_C)
        timer.mark("msm_a")
        msm_b1 = self._msm(self.points_b1, wb1, G1_CURVE, c=_SPARSE_C)
        timer.mark("msm_b1")
        msm_b2 = self._msm(self.points_b2, wb2, G2_CURVE, c=_SPARSE_C)
        timer.mark("msm_b2")
        # the public rows of the padded C table are infinity
        msm_c = self._msm(self.points_c, wc, G1_CURVE, c=_SPARSE_C)
        timer.mark("msm_c")
        h = self._h_scalars(w)
        self.last_h = h
        timer.mark("h_scalars")
        msm_h = self._msm(self.points_h, self._merge_scalars(h, self._merge_h), G1_CURVE)
        timer.mark("msm_h")
        g1_batch = JacPoint(*(torch.stack(cs) for cs in zip(msm_a, msm_b1, msm_c, msm_h)))
        a_pt, b1_pt, c_pt, h_pt = G1_CURVE.decode_jacobian(g1_batch)
        b2_pt = G2_CURVE.decode_jacobian(JacPoint(*(v[None] for v in msm_b2)))[0]
        timer.mark("decode")
        if timer.timed:
            self.phase_ms = timer.phase_ms()
        return blind(self.pk, a_pt, b1_pt, b2_pt, c_pt, h_pt, r, s)


def check_witness_limbs(pk: ProvingKey, witness_limbs) -> np.ndarray:
    """The witness as an (nVars, 16) array of limbs in [0, 2^16), or raise."""
    wl = np.asarray(witness_limbs)
    if wl.shape != (pk.n_vars, NUM_LIMBS):
        raise ValueError(f"witness shape {wl.shape} != ({pk.n_vars}, {NUM_LIMBS})")
    if wl.size and (wl.min() < 0 or wl.max() >= (1 << 16)):
        raise ValueError("witness limbs must lie in [0, 2^16)")
    return wl


class PhaseTimer:
    """CUDA events between the phases of a proof (nothing on the CPU);
    `phase_ms` waits for the last event and returns {phase: ms}."""

    def __init__(self, device: torch.device):
        self.timed = device.type == "cuda"
        self.marks: list = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    def phase_ms(self) -> dict[str, float]:
        self.marks[-1][1].synchronize()
        return {name: prev.elapsed_time(ev) for (_, prev), (name, ev) in zip(self.marks, self.marks[1:])}


def blind(pk: ProvingKey, a_pt, b1_pt, b2_pt, c_pt, h_pt, r: int | None = None, s: int | None = None) -> Proof:
    """The host tail of a proof: blinding with r, s (sampled when None, r
    then s) and the final point assembly (groth16.cpp:288-353), in native
    code (native/bn254_pairing.c `bn254_groth16_blind`); raises if its
    library did not build."""
    r = _sample_fr() if r is None else r
    s = _sample_fr() if s is None else s
    pi_a, pi_b, pi_c = pairing_native.groth16_blind(a_pt, b1_pt, b2_pt, c_pt, h_pt, pk.vk_alpha1, pk.vk_beta1,
                                                    pk.vk_beta2, pk.vk_delta1, pk.vk_delta2, r, s)
    return Proof(pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)


def blind_plain(pk: ProvingKey, a_pt, b1_pt, b2_pt, c_pt, h_pt, r: int, s: int) -> Proof:
    """`blind` in host ints (curves/ref_curve.py, affine double-and-add):
    the tests' oracle."""
    g1, g2 = ref_curve.G1, ref_curve.G2
    pi_a = g1.add(g1.add(a_pt, pk.vk_alpha1), g1.mul(pk.vk_delta1, r))
    pi_b = g2.add(g2.add(b2_pt, pk.vk_beta2), g2.mul(pk.vk_delta2, s))
    pib1 = g1.add(g1.add(b1_pt, pk.vk_beta1), g1.mul(pk.vk_delta1, s))
    pi_c = g1.add(c_pt, h_pt)
    pi_c = g1.add(pi_c, g1.mul(pi_a, s))
    pi_c = g1.add(pi_c, g1.mul(pib1, r))
    pi_c = g1.add(pi_c, g1.neg(g1.mul(pk.vk_delta1, (r * s) % bn254.R_SCALAR)))
    return Proof(pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)
