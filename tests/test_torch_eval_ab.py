"""K9, the coefficient evaluation (ops/cuda_eval_ab.py), on the CPU: the
plain version and `Groth16Prover._eval_ab` against the JAX package's
`_eval_ab` on a key whose table has the keyless key's layout (an a half and
a b half, each with empty rows at its tail) with planted skew; the kernel's
merge-path partition, walked in host ints by `eval_ab_sim`, at partition
sizes 1, 3 and 8 items per thread and 1, 3 and 4 threads per block; the
layout's partition against a walk of the merge path; the wrapper's checks."""

import numpy as np
import pytest
import torch

from keyless_zk_tpu_torch.fields import bn254
from keyless_zk_tpu_torch.fields.limbs import NUM_LIMBS, ints_to_limbs, limbs_to_ints
from keyless_zk_tpu_torch.groth16 import Groth16Prover, from_jax_proving_key
from keyless_zk_tpu_torch.ops import cuda_eval_ab, testgen

torch.set_num_threads(1)

R = bn254.R_SCALAR
DOMAIN = 64


def planted_lengths() -> np.ndarray:
    """Entries per row of the a|b vectors (2 * DOMAIN rows): row 0 empty, row
    1 longer than any block's share below (4 threads x 8 items), short rows,
    each half's tail empty, a dense last row."""
    rng = np.random.default_rng(17)
    n = np.zeros(2 * DOMAIN, np.int64)
    n[1] = 150
    n[2:41] = rng.integers(1, 4, 39)
    n[DOMAIN : DOMAIN + 37] = rng.integers(0, 6, 37)
    n[-1] = 70
    return n


def planted_key():
    """A JAX-package proving key with the planted table in shuffled file
    order (values uniform below r, point tables at infinity: eval_ab reads
    none), and a witness whose rows are near r, zero, bits or uniform."""
    from keyless_zk_tpu.groth16.zkey import G1Table, G2Table, ProvingKey

    rng = np.random.default_rng(18)
    n_vars = 40
    dest = np.repeat(np.arange(2 * DOMAIN), planted_lengths())
    perm = rng.permutation(dest.shape[0])
    dest = dest[perm]
    nnz = dest.shape[0]
    vals = ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % R for _ in range(nnz)])

    def g1(n):
        return G1Table(np.zeros((n, NUM_LIMBS), np.uint32), np.zeros((n, NUM_LIMBS), np.uint32), np.ones(n, bool))

    def g2(n):
        z = np.zeros((n, 2, NUM_LIMBS), np.uint32)
        return G2Table(z, z.copy(), np.ones(n, bool))

    gen = (1, 2)
    pk = ProvingKey(
        n8q=32, n8r=32, q=bn254.Q, r=R, n_vars=n_vars, n_public=1, domain_size=DOMAIN, n_coefs=nnz,
        vk_alpha1=gen, vk_beta1=gen, vk_beta2=((1, 0), (1, 0)), vk_gamma2=((1, 0), (1, 0)), vk_delta1=gen,
        vk_delta2=((1, 0), (1, 0)),
        coef_m=(dest // DOMAIN).astype(np.uint32), coef_c=(dest % DOMAIN).astype(np.uint32),
        coef_s=rng.integers(0, n_vars, nnz).astype(np.uint32), coef_val=vals.astype(np.uint32),
        points_a=g1(n_vars), points_b1=g1(n_vars), points_b2=g2(n_vars), points_c=g1(n_vars - 2),
        points_h=g1(DOMAIN),
    )
    witness = testgen.witness_near_r(n_vars, 19, "cpu").numpy().astype(np.uint32)
    return pk, witness


def expected(pk, witness) -> list[int]:
    """sum over each row's entries of w * c * R^-1 mod r, in host ints."""
    w = limbs_to_ints(witness)
    c = limbs_to_ints(pk.coef_val)
    out = [0] * (2 * pk.domain_size)
    for m, d, s, v in zip(pk.coef_m, pk.coef_c, pk.coef_s, c):
        row = int(m) * pk.domain_size + int(d)
        out[row] = (out[row] + w[int(s)] * v * pow(2, -256, R)) % R
    return out


@pytest.fixture(scope="module")
def planted():
    pk, witness = planted_key()
    prover = Groth16Prover(from_jax_proving_key(pk), device="cpu")
    return pk, witness, prover


def test_plain_and_prover_match_jax(planted):
    import jax.numpy as jnp

    from keyless_zk_tpu.groth16.prover import Groth16Prover as JaxProver

    pk, witness, prover = planted
    want = np.asarray(JaxProver(pk)._eval_ab(jnp.asarray(witness))).astype(np.int64)
    w = torch.from_numpy(witness.astype(np.int32))
    got = prover._eval_ab(w)
    plain = cuda_eval_ab.eval_ab_plain(w, prover.coef_table)
    assert np.array_equal(got.numpy().astype(np.int64), want)
    assert torch.equal(plain, got)
    assert limbs_to_ints(got.numpy()) == expected(pk, witness)
    # the planted shapes are there: an empty first row, empty tails, a dense last row
    lengths = np.diff(prover.coef_table.row_ptr.numpy())
    assert lengths[0] == 0 and lengths[1] == 150 and lengths[-1] == 70
    assert (lengths[41:DOMAIN] == 0).all() and (lengths[DOMAIN + 37 : -1] == 0).all()


@pytest.mark.parametrize("threads", [1, 3, 4])
@pytest.mark.parametrize("items", [1, 3, 8])
def test_sim_walks_the_kernels_partition(planted, items, threads):
    """Every row written once before a carry reaches it, each long row
    split over threads and blocks, the block carries summed: the walk
    equals the plain version bit for bit."""
    pk, witness, prover = planted
    t = prover.coef_table
    table = cuda_eval_ab.CoefTable(
        t.n_src, t.row_ptr, t.src, t.val,
        cuda_eval_ab.merge_path_starts(t.row_ptr, items), items,
    )
    w = torch.from_numpy(witness.astype(np.int32))
    assert torch.equal(cuda_eval_ab.eval_ab_sim(w, table, threads=threads), cuda_eval_ab.eval_ab_plain(w, table))


@pytest.mark.parametrize("items", [1, 3, 8])
@pytest.mark.parametrize("lengths", [
    [0, 0, 0],  # no entries
    [5],  # one row
    [0, 0, 9, 0, 0],  # one row amid empty rows
    [4, 4, 4, 4, 4, 4],  # rows that end on block boundaries (items 1, threads 4)
    [1] * 13 + [40],  # a dense last row
], ids=["no-entries", "one-row", "one-row-amid-empty", "block-aligned", "dense-last"])
def test_sim_edge_shapes(items, lengths):
    table = testgen.coef_table_of_lengths(lengths, 6, 31, "cpu", items=items)
    w = testgen.witness_near_r(6, 32, "cpu")
    plain = cuda_eval_ab.eval_ab_plain(w, table)
    for threads in (1, 4):
        assert torch.equal(cuda_eval_ab.eval_ab_sim(w, table, threads=threads), plain)


@pytest.mark.parametrize("items", [1, 3, 8])
def test_merge_path_starts_walk(items):
    """Thread t starts in the row that holds item t * items of the merge
    path (entries of row d, then row d's end)."""
    row_ptr = np.concatenate([[0], np.cumsum(planted_lengths())])
    path = []  # the row of each item
    for d in range(row_ptr.shape[0] - 1):
        path += [d] * int(row_ptr[d + 1] - row_ptr[d] + 1)
    starts = cuda_eval_ab.merge_path_starts(torch.from_numpy(row_ptr), items)
    assert starts.tolist() == path[::items]


def test_words_round_trip():
    limbs = torch.from_numpy(ints_to_limbs([0, 1, R - 1, (1 << 256) - 1, 0xFFFF0000FFFF]).astype(np.int32))
    words = cuda_eval_ab.pack_words(limbs)
    assert words.dtype == torch.int32 and words.shape == (5, 8)
    assert words[3].tolist() == [-1] * 8 and words[4].tolist() == [0xFFFF, 0xFFFF] + [0] * 6
    assert torch.equal(cuda_eval_ab.unpack_words(words), limbs)


def test_wrapper_checks(planted):
    _, witness, prover = planted
    table = prover.coef_table
    w = torch.from_numpy(witness.astype(np.int32))
    with pytest.raises(TypeError):
        cuda_eval_ab.eval_ab(w.long(), table)
    with pytest.raises(ValueError):
        cuda_eval_ab.eval_ab(w[:-1].contiguous(), table)
    with pytest.raises(ValueError):
        cuda_eval_ab.eval_ab(w.T.contiguous().T, table)
    with pytest.raises(ValueError):
        cuda_eval_ab.eval_ab(torch.empty(w.shape, dtype=torch.int32, device="meta"), table)
    before = cuda_eval_ab.eval_ab.launches
    cuda_eval_ab.eval_ab(w, table)  # a CPU tensor takes the plain version and launches nothing
    assert cuda_eval_ab.eval_ab.launches == before


def test_row_too_dense_is_refused():
    dest = np.zeros(cuda_eval_ab.MAX_ROW_ENTRIES + 1, np.int64)
    with pytest.raises(ValueError, match="too dense"):
        cuda_eval_ab.coef_table(2, dest, dest, None, None, "cpu")
