"""The build's ptxas report (ops/_build.py `ptxas_report`), which
chip_smoke.py prints for K1's mont_pow and the K3-K7 kernels: registers, spills and stack
frame read from nvcc's -Xptxas -v output."""

from keyless_zk_tpu_torch.ops import _build

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _ZN3kzkL8add_coreERKNS_3JacINS_3Fq2EEES4_
    192 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z18window_scan_kernelI2FpIN3kzk5FqModEEEvPKiS5_S5_PKhPixS7_S7_S7_S7_xx' for 'sm_90a'
ptxas info    : Function properties for _Z18window_scan_kernelI2FpIN3kzk5FqModEEEvPKiS5_S5_PKhPixS7_S7_S7_S7_xx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18window_scan_kernelIN3kzk3Fq2EEvPKiS3_S3_PKhPixS5_S5_S5_S5_xx' for 'sm_90a'
ptxas info    : Function properties for _Z18window_scan_kernelIN3kzk3Fq2EEvPKiS3_S3_PKhPixS5_S5_S5_S5_xx
    216 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18bucket_walk_kernelI2FpIN3kzk5FqModEEEvPKiPixxx' for 'sm_90a'
ptxas info    : Function properties for _Z18bucket_walk_kernelI2FpIN3kzk5FqModEEEvPKiPixxx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_Z9mont_mul_kernelPKiS0_Pixx' for 'sm_90a'
ptxas info    : Used 64 registers, 380 bytes cmem[0]
"""


def test_ptxas_report_reads_k4_and_k6_kernels():
    rep = _build.ptxas_report(LOG, ("window_scan_kernel", "bucket_walk_kernel", "point_sum_kernel"))
    assert set(rep) == {"window_scan_kernel g1", "window_scan_kernel g2", "bucket_walk_kernel g1"}
    assert rep["window_scan_kernel g1"] == {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0, "registers": 128,
                                            "blocks_of_128_per_sm": 4}
    assert rep["window_scan_kernel g2"] == {"stack_frame": 216, "spill_stores": 8, "spill_loads": 12,
                                            "registers": 96, "blocks_of_128_per_sm": 5}
    assert rep["bucket_walk_kernel g1"]["registers"] == 168
    assert rep["bucket_walk_kernel g1"]["blocks_of_128_per_sm"] == 3

K3_LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8810add_kernelINS_4FqK3EEEvPKiS3_S3_S3_S3_S3_PiS4_S4_x' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8810add_kernelINS_4FqK3EEEvPKiS3_S3_S3_S3_S3_PiS4_S4_x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 148 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8811madd_kernelINS_4FqK3EEEvPKiS3_S3_S3_S3_PKhPiS6_S6_xx' for 'sm_90a'
ptxas info    : Function properties for _ZN43_INTERNAL_f6a1ec83_12_curve_ops_cu_e8373f886k3_mulEN3kzk2FpINS0_5FqModEEES3_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8811madd_kernelINS_4FqK3EEEvPKiS3_S3_S3_S3_PKhPiS6_S6_xx
    416 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 416 bytes cumulative stack size, 16 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8811madd_kernelINS_5Fq2K3EEEvPKiS3_S3_S3_S3_PKhPiS6_S6_xx' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8811madd_kernelINS_5Fq2K3EEEvPKiS3_S3_S3_S3_PKhPiS6_S6_xx
    920 bytes stack frame, 24 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 920 bytes cumulative stack size, 16 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8810dbl_kernelINS_5Fq2K3EEEvPKiS3_S3_PiS4_S4_x' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8810dbl_kernelINS_5Fq2K3EEEvPKiS3_S3_PiS4_S4_x
    576 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 159 registers, used 1 barriers, 576 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8810dbl_kernelIN3kzk3Fq2EEEvPKiS4_S4_PiS5_S5_x' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__f6a1ec83_12_curve_ops_cu_e8373f8810dbl_kernelIN3kzk3Fq2EEEvPKiS4_S4_PiS5_S5_x
    512 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 116 registers, used 0 barriers, 512 bytes cumulative stack size
"""


def test_ptxas_report_reads_k3_kernels():
    """K3's kernels live in an anonymous namespace, on its own field types
    (FqK3, Fq2K3) or on ec.cuh's (Fq2): `add_kernel` is not `madd_kernel`,
    the stack frame is the kernel's own (not its callee's), and the field
    comes from the type."""
    rep = _build.ptxas_report(K3_LOG, ("madd_kernel", "dbl_kernel", "add_kernel"))
    assert set(rep) == {"add_kernel g1", "madd_kernel g1", "madd_kernel g2", "dbl_kernel g2"}
    assert rep["add_kernel g1"] == {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0, "registers": 148,
                                    "blocks_of_128_per_sm": 3}
    assert rep["madd_kernel g1"] == {"stack_frame": 416, "spill_stores": 0, "spill_loads": 0, "registers": 128,
                                     "blocks_of_128_per_sm": 4}
    assert rep["madd_kernel g2"] == {"stack_frame": 920, "spill_stores": 24, "spill_loads": 32, "registers": 255,
                                     "blocks_of_128_per_sm": 2}
    # two dbl_kernel g2 entries (Fq2K3, then ec.cuh's Fq2): the last one read wins
    assert rep["dbl_kernel g2"]["registers"] == 116 and rep["dbl_kernel g2"]["stack_frame"] == 512


def test_mangled_names_match_whole_identifiers():
    assert _build.mangles("madd_kernel", "_ZN12_GLOBAL__N_111madd_kernelINS_4FqK3EEEvPKi")
    assert not _build.mangles("add_kernel", "_ZN12_GLOBAL__N_111madd_kernelINS_4FqK3EEEvPKi")
    assert _build.mangles("window_scan_kernel", "_Z18window_scan_kernelIN3kzk3Fq2EEvPKiS3_S3_PKhPixS6_S6_S6_S6_xx")


POW_LOG = """\
ptxas info    : Compiling entry function '_Z15mont_pow_kernelIN3kzk5FrModEEvPK4int4PS2_x8Exponent' for 'sm_90a'
ptxas info    : Function properties for _Z15mont_pow_kernelIN3kzk5FrModEEvPK4int4PS2_x8Exponent
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 0 barriers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15mont_pow_kernelIN3kzk5FqModEEvPK4int4PS2_x8Exponent' for 'sm_90a'
ptxas info    : Function properties for _Z15mont_pow_kernelIN3kzk5FqModEEvPK4int4PS2_x8Exponent
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 412 bytes cmem[0]
"""


def test_ptxas_report_keys_fr_apart():
    """K1's kernels are built for Fr and Fq: the Fr instance has its own
    key, and neither overwrites the other."""
    rep = _build.ptxas_report(POW_LOG, ("mont_pow_kernel",))
    assert set(rep) == {"mont_pow_kernel fr", "mont_pow_kernel g1"}
    assert (rep["mont_pow_kernel fr"]["registers"], rep["mont_pow_kernel g1"]["registers"]) == (62, 64)
    assert _build.field_suffix("_Z13horner_kernelIN3kzk3Fq2EEvPKiPixxiS3_i") == " g2"
