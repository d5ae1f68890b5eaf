"""Groth16 prover (PyTorch): port of keyless_zk_tpu/groth16/prover.py.

`Groth16Prover.prove_batch` proves B witnesses in one sweep of the
prover's device (`prove` is its batch of one):

  1. upload the witnesses into one (B, n_vars, 16) limb tensor;
  2. sum the scalars of duplicate table rows (`_merge_scalars`), all B
     vectors in one segment sum per table;
  3. four MSMs over the witnesses (A, B1, C on G1; B2 on G2), each one
     batched MSM over its table                           [ops/msm.py]
  4. the h scalars (`_h_scalars`), per element: coefficient-table
     evaluation into the a|b vectors [ops/cuda_eval_ab.py], then c = a*b,
     one batched (3, n) iNTT -> coset shift -> NTT, h = a*b - c, from_mont,
     fused into K10's butterfly passes           [ops/cuda_ntt.py: the
                                                  kernel on the card, its
                                                  plain passes on the CPU]
  5. the H MSM;
  6. decode the 5B results to affine (one batched inversion per group,
     one readback each);

then a host tail blinds each proof with its r, s (groth16.cpp:288-353) in
native code (`blind`); `blind_plain`, the same in host ints, is the
tests' oracle.

The polynomial phase runs in the reference's raw representation exactly as
the JAX package does (coefficients pre-scaled by R^2 at load), so the
output of every phase equals the JAX package's bit for bit. The JAX package's
compact witness upload (`_witness_to_device`) is not carried over: the
witness goes up as dense (n_vars, 16) limbs after a check that every limb
is below 2^16.

On a CUDA device each device phase is timed with CUDA events into
`phase_ms` (milliseconds, read after the final readback); `blind` is the
host tail on the host clock, on any device.
"""

from __future__ import annotations

import secrets
import time
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
from ..ops.cuda_ntt import get_cuda_plan
from ..ops.msm import msm_batch
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


class Groth16Prover:
    """Proving key resident on `device` (the card unless the caller asks
    for the CPU) + the prove pipeline.

    Construct once per key, call :meth:`prove` per witness or
    :meth:`prove_batch` per batch. After a call, `last_h` holds its
    (B, domain, 16) h scalars (the MSM_H input, for checks such as the
    discrete-log oracle) and `phase_ms` its phase times: on a CUDA device
    the device phases (CUDA events), and on any device `blind`, the host's
    blinding tail that follows them (host clock)."""

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
        self.plan = get_cuda_plan(self.domain_pow, self.device)  # K10; its plain passes on the CPU
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
        """Witness -> MSM_H scalar vector (the NTT phase), on the device:
        the chain after the evaluation runs fused into K10's passes
        (`CudaNTTPlan.h_scalars`)."""
        return self.plan.h_scalars(self._eval_ab(witness))

    def _msm(self, table, scalars: torch.Tensor, curve, c: int | None = None) -> JacPoint:
        """The MSMs of a batch, scalars (B, n, 16), over a resident point
        table (the sharded prover spreads them over a process group)."""
        return msm_batch(*table, scalars, curve=curve, c=c)

    # ---- full prove ------------------------------------------------------

    def prove(self, witness_limbs: np.ndarray, r: int | None = None, s: int | None = None) -> Proof:
        """witness_limbs: (nVars, 16) standard-form 16-bit limb rows; r and
        s are sampled when None. `prove_batch` of one."""
        return self.prove_batch([witness_limbs], [(r, s)])[0]

    def prove_batch(self, witnesses: list[np.ndarray], rs: list[tuple] | None = None) -> list[Proof]:
        """Prove B witnesses in one device sweep. `rs` gives each proof's
        (r, s); where it is None, or an entry's r or s is, that value is
        sampled per proof, in order (r then s), as the JAX package samples
        them."""
        wls = [check_witness_limbs(self.pk, w) for w in witnesses]
        B = len(wls)
        if rs is not None and len(rs) != B:
            raise ValueError(f"{len(rs)} (r, s) pairs for {B} witnesses")
        if B == 0:
            return []
        timer = PhaseTimer(self.device)
        w = torch.empty((B, *wls[0].shape), dtype=torch.int32, device=self.device)
        for i, wl in enumerate(wls):  # element by element: no (B, n_vars, 16) host copy
            w[i] = _limbs(wl, self.device)
        timer.mark("upload")
        # the deduplicated tables hold n_unique rows: one segment sum each
        merged = [self._merge_scalars(w, m) for m in (self._merge_a, self._merge_b1, self._merge_b2, self._merge_c)]
        timer.mark("merges")
        outs = {}
        for (name, table, curve), scalars in zip((("msm_a", self.points_a, G1_CURVE),
                                                  ("msm_b1", self.points_b1, G1_CURVE),
                                                  ("msm_b2", self.points_b2, G2_CURVE),
                                                  ("msm_c", self.points_c, G1_CURVE)), merged):
            outs[name] = self._msm(table, scalars, curve, c=_SPARSE_C)
            timer.mark(name)
        del merged
        h = torch.stack([self._h_scalars(w[i]) for i in range(B)])
        self.last_h = h
        timer.mark("h_scalars")
        outs["msm_h"] = self._msm(self.points_h, self._merge_scalars(h, self._merge_h), G1_CURVE)
        timer.mark("msm_h")
        g1 = JacPoint(*(torch.cat(cs) for cs in zip(outs["msm_a"], outs["msm_b1"], outs["msm_c"], outs["msm_h"])))
        g1_pts = G1_CURVE.decode_jacobian(g1)  # 4B points: a, b1, c, h per element
        b2_pts = G2_CURVE.decode_jacobian(outs["msm_b2"])
        timer.mark("decode")
        phase_ms = timer.phase_ms() if timer.timed else {}

        t0 = time.perf_counter()
        proofs = []
        for i, (r, s) in enumerate(rs or [(None, None)] * B):
            r = _sample_fr() if r is None else r
            s = _sample_fr() if s is None else s
            a_pt, b1_pt, c_pt, h_pt = (g1_pts[k * B + i] for k in range(4))
            proofs.append(blind(self.pk, a_pt, b1_pt, b2_pts[i], c_pt, h_pt, r, s))
        phase_ms["blind"] = (time.perf_counter() - t0) * 1e3
        self.phase_ms = phase_ms
        return proofs


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


def blind(pk: ProvingKey, a_pt, b1_pt, b2_pt, c_pt, h_pt, r: int, s: int) -> Proof:
    """The host tail of a proof: blinding with r, s and the final point
    assembly (groth16.cpp:288-353), in native code
    (native/bn254_pairing.c `bn254_groth16_blind`); raises if its library
    did not build."""
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
