"""K9: the coefficient evaluation of the h scalars (eval_ab), its table
layout, its plain version, a simulation of its partition and its wrapper.

eval_ab turns a witness into the concatenated a|b evaluation vectors
(2 * domain, 16): row d is the sum over the coefficient entries aimed at d
of w[src] * c * R^-1 mod r (c the zkey's Montgomery-stored coefficient),
which replaces the reference's 1024-spinlock scatter (groth16.cpp:135-156).
The kernel (csrc/eval_ab.cu) replaces no Pallas kernel: the JAX package
runs this step in XLA (keyless_zk_tpu/groth16/prover.py `_eval_ab_fused`),
whose port in plain PyTorch, `eval_ab_plain`, was the card's largest cost
in a proof. The wrapper dispatches on the witness's device: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

`CoefTable` is the one layout both read, built once per key from the
entries sorted by row: the row offsets, the witness row of each entry, the
coefficient times R mod r as 8 packed 32-bit words, and the kernel's
merge-path partition (the row each thread starts in).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import torch_field as tf
from ..fields.limbs import NUM_LIMBS, ints_to_limbs, limbs_to_ints
from ..fields.torch_field import FR
from . import _build

# merge-path items (row ends and entries) per thread of the kernel: the
# fastest share on the keyless table's shape on the H100 (PERF.md: 2.24 /
# 2.11 / 2.30 ms at 2 / 3 / 4)
ITEMS_PER_THREAD = 3
# threads per block (csrc/eval_ab.cu kThreads)
BLOCK_THREADS = 128
# entries per pass of the plain version: a 2^22-entry chunk holds 256 MB of
# gathered witness rows, 256 MB of products and 1 GB of int64 sums
PLAIN_CHUNK = 1 << 22
# rows the plain version's 8-bit split sums hold exactly
MAX_ROW_ENTRIES = (1 << 23) - 1

WORDS = NUM_LIMBS // 2


@dataclass
class CoefTable:
    """The coefficient table on its device, sorted by destination row.

    n_src: a bound on the witness rows the table reads (every src is below it);
    row_ptr: (n_rows + 1,) int32, row d's entries are [row_ptr[d], row_ptr[d + 1]);
    src: (nnz,) int32, the witness row of each entry;
    val: (nnz, 8) int32, each coefficient times R mod r (the zkey's value
      pre-scaled by R^2 through a Montgomery product), little-endian words;
    part_row: (ceil((n_rows + nnz) / items),) int32, the row in which
      kernel thread t starts: the number of row ends among the first t * items
      items of the merge path (row d's end follows its entries);
    items: merge-path items per kernel thread."""

    n_src: int
    row_ptr: torch.Tensor
    src: torch.Tensor
    val: torch.Tensor
    part_row: torch.Tensor
    items: int

    @property
    def n_rows(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.src.shape[0]


def pack_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 16) int32 16-bit limbs -> (..., 8) int32 holding 32-bit words."""
    v = limbs.long()
    words = v[..., 0::2] | (v[..., 1::2] << 16)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).int()


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int32 16-bit limbs."""
    lo, hi = words & 0xFFFF, (words >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=-1).reshape(*words.shape[:-1], NUM_LIMBS)


def merge_path_starts(row_ptr: torch.Tensor, items: int) -> torch.Tensor:
    """The row each thread of `items` merge-path items starts in, as int32 on
    row_ptr's device: row d's end is item row_ptr[d + 1] + d, so thread t,
    starting at item t * items, starts in the row that counts the row ends
    before that item."""
    row_ptr = row_ptr.long()
    n_rows = row_ptr.shape[0] - 1
    ends = row_ptr[1:] + torch.arange(n_rows, device=row_ptr.device)
    starts = torch.arange(0, n_rows + int(row_ptr[-1]), items, device=row_ptr.device)
    return torch.searchsorted(ends, starts).int()


def coef_table(n_rows: int, dest: np.ndarray, src: np.ndarray, coef_val: np.ndarray, order: np.ndarray,
               device) -> CoefTable:
    """The layout from a zkey's table: `dest` the sorted destination rows,
    `src` the sorted witness rows, `coef_val` the zkey's (nnz, 16)
    Montgomery-form values in file order and `order` the sort. Values are
    pre-scaled on `device` in PLAIN_CHUNK slices."""
    dev = torch.device(device)
    nnz = dest.shape[0]
    row_ptr = np.searchsorted(dest, np.arange(n_rows + 1)).astype(np.int64)
    if nnz and int(np.diff(row_ptr).max()) > MAX_ROW_ENTRIES:
        raise ValueError("coefficient row too dense for 8-bit split sums")
    r2 = tf.consts(FR, FR.r2_mod_p, (), dev)
    val = torch.empty((nnz, WORDS), dtype=torch.int32, device=dev)
    for e0 in range(0, nnz, PLAIN_CHUNK):
        rows = np.ascontiguousarray(coef_val[order[e0 : e0 + PLAIN_CHUNK]]).astype(np.int32)
        val[e0 : e0 + rows.shape[0]] = pack_words(tf.mont_mul(torch.from_numpy(rows).to(dev), r2, FR))
    row_ptr = torch.from_numpy(row_ptr.astype(np.int32)).to(dev)
    return CoefTable(
        n_src=int(src.max()) + 1 if nnz else 0,
        row_ptr=row_ptr,
        src=torch.from_numpy(np.asarray(src, np.int64).astype(np.int32)).to(dev),
        val=val,
        part_row=merge_path_starts(row_ptr, ITEMS_PER_THREAD),
        items=ITEMS_PER_THREAD,
    )


def eval_ab_plain(witness: torch.Tensor, table: CoefTable) -> torch.Tensor:
    """The a|b vectors in plain torch, PLAIN_CHUNK entries a pass: per
    chunk one Montgomery product per entry (w * cR * R^-1 = w c), the
    products split into 8-bit halves and summed exactly per row in int64
    (`segment_diffs`), added into the rows' accumulators; one REDC of the
    sums at the end (`fold_split8_mod`) gives sum w c R^-1 mod r."""
    m2 = table.n_rows
    dev = witness.device
    acc_lo = torch.zeros((m2, NUM_LIMBS), dtype=torch.int64, device=dev)
    acc_hi = torch.zeros((m2, NUM_LIMBS), dtype=torch.int64, device=dev)
    row_ptr = table.row_ptr.long()
    for e0 in range(0, table.nnz, PLAIN_CHUNK):
        e1 = min(e0 + PLAIN_CHUNK, table.nnz)
        # the rows of the chunk's first and last entries, and their bounds in it
        ends = torch.searchsorted(row_ptr, torch.tensor([e0, e1 - 1], device=dev), right=True) - 1
        d_lo, d_hi = (int(x) for x in ends)
        bounds = row_ptr[d_lo : d_hi + 2].clamp(e0, e1) - e0
        av = tf.mont_mul(witness.index_select(0, table.src[e0:e1]), unpack_words(table.val[e0:e1]), FR)
        lo, hi = tf.split8(av)
        del av
        acc_lo[d_lo : d_hi + 1] += tf.segment_diffs(lo, bounds)
        acc_hi[d_lo : d_hi + 1] += tf.segment_diffs(hi, bounds)
    return tf.fold_split8_mod(acc_lo, acc_hi, FR)


def eval_ab_sim(witness: torch.Tensor, table: CoefTable, threads: int = BLOCK_THREADS) -> torch.Tensor:
    """The kernel's walk in host ints, for small tables: its witness packing
    (w R^-1), each thread's share of the merge path, the block's runs of
    carries and the second kernel's runs of block carries, in the kernel's
    order. A row read before the thread that ends it has written it raises."""
    p = FR.p
    r_inv = FR.r_inv
    x = [v * r_inv % p for v in limbs_to_ints(witness.cpu().numpy())]
    row_ptr = table.row_ptr.tolist()
    src = table.src.tolist()
    val = limbs_to_ints(unpack_words(table.val).cpu().numpy())
    part = table.part_row.tolist()
    n_rows, d = table.n_rows, table.items
    total = n_rows + table.nnz
    n_blocks = -(-len(part) // threads)
    out: list = [None] * n_rows
    carry_row, carry_val = [n_rows] * n_blocks, [0] * n_blocks
    for b in range(n_blocks):
        s_row, s_val = [], []
        for j in range(threads):
            d0 = (b * threads + j) * d
            row, acc = n_rows, 0
            if d0 < total:
                row = part[b * threads + j]
                e = d0 - row
                for _ in range(d0, min(d0 + d, total)):
                    if row < n_rows and e < row_ptr[row + 1]:
                        acc = (acc + x[src[e]] * val[e] * r_inv) % p
                        e += 1
                    else:
                        out[row] = acc
                        acc, row = 0, row + 1
            s_row.append(row)
            s_val.append(acc)
        for j, row in enumerate(s_row):
            if row >= n_rows or (j > 0 and s_row[j - 1] == row):
                continue
            k = j
            while k < threads and s_row[k] == row:
                k += 1
            total_run = sum(s_val[j:k]) % p
            if k < threads:
                if out[row] is None:
                    raise AssertionError(f"row {row} read before it was written (block {b})")
                out[row] = (out[row] + total_run) % p
            else:
                carry_row[b], carry_val[b] = row, total_run
    for i, row in enumerate(carry_row):
        if row >= n_rows or (i > 0 and carry_row[i - 1] == row):
            continue
        k = i
        while k < n_blocks and carry_row[k] == row:
            k += 1
        if out[row] is None:
            raise AssertionError(f"row {row} carried into before it was written")
        out[row] = (out[row] + sum(carry_val[i:k])) % p
    if any(v is None for v in out):
        raise AssertionError("a row was never written")
    return torch.from_numpy(ints_to_limbs(out).astype(np.int32)).reshape(n_rows, NUM_LIMBS)


@_build.counted
def eval_ab(witness: torch.Tensor, table: CoefTable) -> torch.Tensor:
    """witness: (n, 16) int32 standard-form limbs, n >= table.n_src,
    contiguous, on the table's device -> (n_rows, 16) int32 canonical limbs. One call of the
    kernel's entry point: the witness packing, the merge-path pass and the
    pass over the block carries."""
    if witness.dtype != torch.int32:
        raise TypeError("eval_ab: the witness must be int32 limbs")
    if witness.dim() != 2 or witness.shape[1] != NUM_LIMBS or witness.shape[0] < table.n_src:
        raise ValueError(f"eval_ab: witness shape {tuple(witness.shape)}, not (n >= {table.n_src}, {NUM_LIMBS})")
    if not witness.is_contiguous():
        raise ValueError("eval_ab: the witness must be contiguous")
    if witness.device != table.src.device:
        raise ValueError(f"eval_ab: witness on {witness.device}, table on {table.src.device}")
    if witness.device.type == "cpu":
        return eval_ab_plain(witness, table)
    if witness.device.type != "cuda":
        raise ValueError(f"eval_ab: tensor on {witness.device}")
    dev = witness.device
    n_threads = table.part_row.shape[0]
    n_blocks = -(-n_threads // BLOCK_THREADS)
    out = torch.empty((table.n_rows, NUM_LIMBS), dtype=torch.int32, device=dev)
    n_vars = witness.shape[0]
    wpk = torch.empty((n_vars, WORDS), dtype=torch.int32, device=dev)
    carry_row = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    carry_val = torch.empty((n_blocks, WORDS), dtype=torch.int32, device=dev)
    lib = _build.library()
    eval_ab.launches += 1
    err = lib.kzk_eval_ab(
        witness.data_ptr(), n_vars, wpk.data_ptr(), table.src.data_ptr(), table.val.data_ptr(),
        table.row_ptr.data_ptr(), table.part_row.data_ptr(), table.n_rows, table.nnz, table.items,
        BLOCK_THREADS, carry_row.data_ptr(), carry_val.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "eval_ab")
    return out
