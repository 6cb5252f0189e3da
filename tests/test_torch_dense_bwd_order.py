"""Why the card holds the bf16 dense backward's g_{k-1} to the exact
product of its rounded operands (`chip_smoke.g_ok`) and not to one bf16
ulp of the plain version.

csrc/fused_mlp.cu computes g_{k-1} = bf16(dy_c @ bf16(W)) in bf16 on the
tensor cores: each mma step adds 16 exact products and the f32
accumulator, truncating. The plain version's f32 product (cuBLAS on the
card, a sequential sum here) adds one product at a time. Where the terms
cancel, both f32 sums miss the exact one by more than an ulp of the small
result, so the two orders disagree by more than one bf16 ulp at a few
elements per million. Shown here on the CPU with an emulated mma order at
one of cls_ssg SA1's dense shapes (Ck=128 -> Cp=64), cut to 65536 rows.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulp, g_ok

R, CK, CP = 65536, 128, 64


@pytest.fixture(scope="module")
def orders():
    """dy_c (R, Ck) bf16, W (Ck, Cp) f32 with bf16 values, and g in the
    two orders: a sequential f32 sum in ascending k, and k16 steps whose
    exact sum is added to the accumulator and truncated to f32."""
    rs = np.random.RandomState(7)
    dyc = torch.from_numpy(rs.randn(R, CK).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rs.randn(CK, CP) / np.sqrt(CK)).astype(
        np.float32)).bfloat16().float()
    d, wf = dyc.float(), w
    seq = torch.zeros(R, CP)
    for k in range(CK):  # each product is exact in f32
        seq = seq + d[:, k:k + 1] * wf[k]
    mma = torch.zeros(R, CP)
    for k0 in range(0, CK, 16):
        s = mma.double() + d[:, k0:k0 + 16].double() @ wf[k0:k0 + 16].double()
        f = s.float()
        over = f.double().abs() > s.abs()  # rounded away from zero
        mma = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return dyc, w, seq.bfloat16(), mma.bfloat16()


def test_one_ulp_of_plain_holds_one_summation_order_only(orders):
    _, _, seq, mma = orders
    d = (mma.float() - seq.float()).abs()
    over = int((d > bf16_ulp(torch, seq.float())).sum())
    assert 0 < over <= 1e-4 * d.numel()


def test_g_ok_holds_both_orders_and_fails_wrong_products(orders):
    dyc, w, seq, mma = orders
    assert g_ok(torch, seq, dyc, w) and g_ok(torch, mma, dyc, w)
    missing = (dyc[:, 16:].float() @ w[16:]).bfloat16()  # one k16 step
    for wrong in (torch.zeros_like(mma), (mma.float() * 1.02).bfloat16(),
                  missing):
        assert not g_ok(torch, wrong, dyc, w)


def test_mma_counts_reads_cuobjdump_sass():
    """`_build.mma_counts`, which phase 1 of chip_smoke.py runs on the
    built fused_mlp library, counts HMMA and HGMMA lines per kernel."""
    from pointnet2_tpu_torch.ops import _build

    sass = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_122dense_bwd_g_mma_kernelEPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a70*/                   HMMA.16816.F32.BF16 R24, R76, R84, R24 ;
        /*0a80*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
		Function : _ZN12_GLOBAL__N_118dense_bwd_g_kernelIfEEvPKT_PKfxii
        /*0000*/                   FFMA R2, R3, R4, R2 ;
        /*0010*/                   EXIT ;
"""
    assert _build.mma_counts(sass) == {
        "_ZN12_GLOBAL__N_122dense_bwd_g_mma_kernelEPK13__nv_bfloat16": 2,
        "_ZN12_GLOBAL__N_118dense_bwd_g_kernelIfEEvPKT_PKfxii": 0}
