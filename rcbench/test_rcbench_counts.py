"""The count functions against hand-worked shapes, among them the kernel
table's B3 call (29.5 MB) and B4 pass (1,192 MB) of `PERF.md`."""
import numpy as np

from rcbench import cell as C
from rcbench.counts import peaks
from rcbench.counts import work as WK

QWEN = WK.Shape.of(C.read_json(C.HERE / "configs" / "qwen3-8b.json"))


def test_shape_reads_the_configuration():
    assert QWEN.layer_params == 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 12288
    assert QWEN.kv_row == 8 * 128 * 4 and QWEN.mlp_mats == 3 and QWEN.act_bytes == 2
    nem = WK.Shape.of(C.read_json(C.HERE / "configs" / "nemotron-4-15b.json"))
    assert nem.mlp_mats == 2 and nem.layer_params == 2 * 6144 * 6144 + 2 * 6144 * 1024 + 2 * 6144 * 24576


def test_b3_is_the_kernel_tables_call():
    # q (8, 32, 128) bf16 over 3,585 resident slots of the fp32 arena, one layer
    one = WK.Shape(1, 4096, 12288, 32, 8, 128, 151936, 3)
    ctx = [448] * 7 + [449]
    _, nbytes = WK.b3(one, ctx)
    assert nbytes == 2 * 8 * 32 * 128 * 2 + 2 * 3585 * 8 * 128 * 4
    assert round(nbytes / 1e6, 1) == 29.5
    assert abs(WK.bound_s(*WK.b3(one, ctx)) - nbytes / peaks.HBM_BYTES) < 1e-15


def test_b4_pass_is_the_kernel_tables_pass():
    # 2,240 table entries over 797 distinct rows, layers 1..35
    _, nbytes = WK.b4_pass(QWEN, 2240, 797, 35)
    assert nbytes == 35 * (2 * 797 + 3 * 2240) * 4096
    assert round(nbytes / 1e6) == 1192


def test_b2_is_the_kernel_tables_call():
    # q (5, 320, 32, 128) bf16 against k (5, 448, 8, 128) fp32, v bf16: one layer
    one = WK.Shape(2, 4096, 12288, 32, 8, 128, 151936, 3)
    f, b = 0, 0
    for _ in range(5):
        fi, bi = WK.b2(one, 448, np.arange(128, 448))
        f, b = f + fi, b + bi
    assert b == 5 * (2 * 320 * 32 * 128 * 2 + 448 * 8 * 128 * 6)
    assert abs(WK.bound_s(f, b) * 1e3 - 0.0119) < 5e-4
    assert f == 5 * 4 * 32 * 128 * int(np.sum(np.arange(129, 449)))


def test_model_flops_by_hand():
    s = WK.Shape(3, 8, 16, 2, 1, 4, 10, 2)
    P = 2 * 8 * 8 + 2 * 8 * 4 + 2 * 8 * 16
    assert s.layer_params == P
    n, r = 5, [1, 4]
    want = 2 * n * P + 4 * 8 * 15 + 2 * (2 * 2 * P + 4 * 8 * 7) + 2 * 8 * 10
    assert WK.prefill_flops(s, n, r) == want
    assert WK.decode_flops(s, 6) == 3 * (2 * P + 4 * 8 * 6) + 2 * 8 * 10
