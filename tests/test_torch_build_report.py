"""The build's ptxas report (ops/_build.py `ptxas_report`), which
chip_smoke.py prints for the K4-K7 kernels: registers, spills and stack
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
