"""tools/kernel_variants.py's design variants are text edits of csrc/. Each
edit must find its anchor and change the file it edits, so that no variant
silently builds the shipped code. The edits run here on the CPU; the builds
and the timings need the card."""

import re

import pytest

from keyless_zk_tpu_torch.ops import _build
from keyless_zk_tpu_torch.tools import kernel_variants as kv

EDITED = [name for name, (edits, _) in kv.VARIANTS.items() if edits]


def _edited(name: str) -> dict:
    """{file: (shipped text, edited text)} of a variant, its edits applied
    in order."""
    out = {}
    for file, edit in kv.VARIANTS[name][0]:
        src = (_build.CSRC / file).read_text()
        out[file] = (src, edit(out.get(file, (src, src))[1]))
    return out


@pytest.mark.parametrize("name", EDITED)
def test_variant_edits_find_their_anchors(name):
    """Each edit changes the text it is given (an anchor that is missing
    raises), so the variant never builds the shipped code."""
    for file, edit in kv.VARIANTS[name][0]:
        src = (_build.CSRC / file).read_text()
        assert edit(src) != src, f"an edit of {name} leaves {file} as shipped"
    for file, (src, out) in _edited(name).items():
        assert out != src, f"{name} leaves {file} as shipped"


def _budgets(src: str) -> list[tuple[int, int, int]]:
    return [tuple(map(int, m)) for m in re.findall(r"madd = (\d+), dbl = (\d+), add = (\d+);", src)]


def test_k3_variants_edit_what_they_name():
    shipped = (_build.CSRC / "curve_ops.cu").read_text()
    assert "using G2 = Fq2K3;" in shipped and shipped.count("reinterpret_cast<const int4*>(row)") == 1
    scalar = _edited("k3_scalar")["curve_ops.cu"][1]
    assert "int4" not in scalar and "row[2 * i + 1] << 16" in scalar and "row[2 * i + 1] = " in scalar
    assert "using G2 = Fq2;" in _edited("k3_calls")["curve_ops.cu"][1]
    assert "k3_mul(const Fp<FqMod>& a, const Fp<FqMod>& b)" in _edited("k3_byref")["curve_ops.cu"][1]
    assert "__forceinline__ Fp<FqMod> k3_mul(" in _edited("k3_inline")["curve_ops.cu"][1]
    first = _edited("k3_first")["curve_ops.cu"][1]
    assert "using G2 = Fq2;" in first and "int4" not in first
    assert "using G1 = Fp<FqMod>;" in first and "k3_mul(const Fp<FqMod>& a" in first
    assert _budgets(first) == [(1, 1, 1), (1, 1, 1)]
    assert len(_budgets(shipped)) == 2
    for name in ("k3_budget_low", "k3_budget_high"):
        assert _budgets(_edited(name)["curve_ops.cu"][1]) != _budgets(shipped)


def test_variants_run_on_the_kernels_they_concern():
    assert kv.concerns("shipped", "K3 dbl fq n=2097152 (setup step)")
    assert kv.concerns("inline", "K7 horner_total fq Wn=22 c=12")
    assert kv.concerns("k3_calls", "K3 madd fq2 n=2097150, generator broadcast (setup step)")
    assert not kv.concerns("k3_calls", "K4 window_scan fq L=993 V=33792 over 16 x 32769 buckets")
    assert not kv.concerns("occupancy", "K3 dbl fq n=2097152 (setup step)")
    assert kv.concerns("sliced", "K7 horner_total fq2 Wn=22 c=12")


def test_add_and_pow_variants_edit_what_they_name():
    """The full add's variants change the add kernel's call and nothing of
    the mixed add's (whose `madd_complete(` contains `add_complete(`); the
    budgets change the add's blocks alone; `pow_bits` runs K1's power bit
    by bit, without the window table."""
    shipped = (_build.CSRC / "curve_ops.cu").read_text()
    call = "store_point<F>(ox, oy, oz, i, {}(load_point<F>(ax, ay, az, i)"
    assert call.format("add_complete") in shipped and shipped.count("madd_complete(load_point") == 1
    branch = _edited("k3_add_branch")["curve_ops.cu"][1]
    assert call.format("add_core") in branch and call.format("add_complete") not in branch
    assert branch.count("madd_complete(load_point") == 1
    any_ = _edited("k3_add_any")["curve_ops.cu"][1]
    assert call.format("add_any") in any_ and "__any_sync(__activemask(), d)" in any_
    assert any_.count("madd_complete(load_point") == 1 and "madd_any" not in any_
    for name, blocks in (("k3_add_budget_2", 2), ("k3_add_budget_4", 4)):
        edited = _budgets(_edited(name)["curve_ops.cu"][1])
        assert [b[2] for b in edited] == [blocks, blocks]
        assert [b[:2] for b in edited] == [b[:2] for b in _budgets(shipped)]
    pow_shipped = (_build.CSRC / "mont_mul.cu").read_text()
    bits = _edited("pow_bits")["mont_mul.cu"][1]
    assert "Fp<M> t[16];" in pow_shipped and "Fp<M> t[16];" not in bits
    assert "acc = mul(acc, x);" in bits and "kzk_mont_pow" in bits
    assert kv.concerns("pow_bits", "K1 mont_pow fq n=4, e = p - 2")
    assert not kv.concerns("pow_bits", "K3 add fq n=1 (the sharded combine's)")


def test_scan_variants_edit_what_they_name():
    """K4's variants: the ring variants copy rows through shared memory
    (`ring_1` with one slot, half the bytes; `ring_off` waits at once); the
    law and product variants swap one type; the distinct variants move the
    distinct kernel onto `scan_law` and leave the complete kernel as
    shipped. The complete body's variants run on K4c cases, the distinct
    body's on K4 ones."""
    shipped = (_build.CSRC / "msm_scan.cu").read_text()
    assert "cp.async.cg" not in shipped

    def scan(name):
        return _edited(name)["msm_scan.cu"][1]

    ring = scan("ring")
    assert "cp.async.cg.shared.global" in ring and "cp_async_wait<1>();" in ring
    assert "extern __shared__ int4 ring[];" in ring and "kernel<<<blocks, threads, smem, s>>>(" in ring
    assert "cp_async_wait<0>();" in scan("ring_off") and "cp_async_wait<1>();" not in scan("ring_off")
    one = scan("ring_1")
    assert "return kScanThreads *" in one and "(t + 1) & 1" not in one
    assert "cudaFuncAttributePreferredSharedMemoryCarveout" in scan("carveout")
    assert "using Coord = Fp<FqMod>;\n  using Law = JacLaw<Coord>;" in scan("g1_jac")
    g2_proj = scan("g2_proj")
    assert "using Coord = Fq2S;\n  using Law = ProjLaw<Coord>;" in g2_proj and "Fq2S mul_b3(" in g2_proj
    assert "{ return mul(a, b); }" in scan("g2_mont")
    assert "scan_mul(const Fp<FqMod>& a, const Fp<FqMod>& b)" in scan("g2_byref")
    assert "  using Coord = Fq2;" in scan("g2_fq2")
    for name, call in (("distinct_loop", "scan_law<F, CoreLaw<F>>(keys"),
                       ("distinct_ring", "scan_law<F, CoreLaw<F>>(keys"),
                       ("distinct_law", "scan_law<typename Complete<F>::Coord, typename Complete<F>::Law>(keys")):
        src = scan(name)
        assert call in src and "scan_lane<F>(keys" not in src
        assert src.count("window_scan_kernel(") == 1
    assert "ring_bytes<F>()" in scan("distinct_ring")
    for name in ("ring", "g1_jac", "g2_proj"):
        assert kv.concerns(name, "K4c window_scan_complete fq L=63 V=33792 over 81940 buckets, planted")
        assert not kv.concerns(name, "K4 window_scan fq L=993 V=33792 over 16 x 32769 buckets, random")
    for name in ("distinct_loop", "distinct_ring", "distinct_law"):
        assert kv.concerns(name, "K4 window_scan fq2 L=32 V=32768 over 22 x 2049 buckets, random")
        assert not kv.concerns(name, "K4c window_scan_complete fq L=63 V=33792 over 81940 buckets, planted")
    assert set(kv.LAW_VARIANTS) <= set(kv.VARIANTS)
