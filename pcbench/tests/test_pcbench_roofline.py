"""The yardstick's counts against hand counts, and its peaks against the
data sheet (CPU).  Run: ``python -m pytest pcbench/tests -q``."""
import ast
import pathlib

from pcbench import roofline as rf

PCBENCH = pathlib.Path(__file__).resolve().parents[1]
DATA_SHEET = {989e12, 495e12}  # H100 SXM dense bf16, TF32


def test_st_flops_by_hand():
    assert rf.st_flops(128, 3, 64, 64, 10) == 20_120_832
    # one MAB by its terms: projections, QKᵀ and A·V, output projection
    assert rf.mab_flops(1, 128, 64, 64, 64) == (
        2 * 64 * 64 + 2 * 2 * 128 * 64 * 64 + 2 * 2 * 128 * 64 + 2 * 64 * 64)


def test_extract_bytes_by_hand():
    assert rf.extract_bytes(1024 * 220672, 44032, 128) == 1024 * 220672 * 4 + 44032 * 128 * 6
    assert abs(rf.roofline_s(0, rf.extract_bytes(1024 * 220672, 44032, 128), "bf16")
               - 0.280e-3) < 0.001e-3


def test_attention_counts_by_hand():
    # 4 MABs of 64 inducing points each way over 1,025 points, and the PMA
    assert rf.st_attention_pairs(1025, 64) == 4 * 1025 * 64 + 1025
    assert rf.attention_fwd_flops(10, 64) == 2 * 2 * 10 * 64
    assert rf.attention_bwd_flops(10, 64) == 2.5 * rf.attention_fwd_flops(10, 64)
    # Q, K, V, O of the five attends of one cloud of n points, f32
    n, m, d = 1025, 64, 64
    isab = (2 * m + 2 * n) + (2 * n + 2 * m)  # MAB0: Q, O of m rows, K, V of n; MAB1 the other way
    pma = 2 * 1 + 2 * n
    assert rf.st_attention_bytes(1, n, m, d) == (2 * isab + pma) * d * 4


def test_peaks_are_the_data_sheet():
    assert set(rf.PEAK_FLOPS.values()) <= DATA_SHEET
    assert rf.HBM_BYTES_PER_S == 3.35e12


def test_no_reader_brings_its_own_peak():
    """Every share divides by ``roofline.py``'s peaks: no reader holds a
    rate of its own or names a peak outside the data sheet's."""
    for path in (PCBENCH / "metrics").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
                assert abs(node.value) < 1e9, f"{path.name} holds the rate {node.value}"
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "roofline_s":
                peak = node.args[2]
                assert isinstance(peak, ast.Constant) and peak.value in rf.PEAK_FLOPS, path.name


def test_share_of_nothing_is_nothing():
    assert rf.share_pct(1.0, 0.0) is None
    assert rf.share_pct(1.0, 4.0) == 25.0


def test_kernel_names_as_the_profiler_gives_them():
    from pcbench.trace import kernel_base

    assert kernel_base("void (anonymous namespace)::fused_st_kernel<3, 4>(void const*, int)") \
        == "fused_st_kernel"
    assert kernel_base("(anonymous namespace)::frames_mag2_kernel(float const*, int const*)") \
        == "frames_mag2_kernel"
    assert kernel_base("void at::native::vectorized_elementwise_kernel<4, at::native::F>(int)") \
        == "vectorized_elementwise_kernel"
    assert kernel_base("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n") == "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n"


def test_busy_time_counts_overlaps_once():
    from pcbench.trace import busy_time

    assert busy_time([(0, 2), (1, 3), (5, 6)]) == 4
