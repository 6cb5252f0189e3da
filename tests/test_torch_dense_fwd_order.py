"""Why the card holds the bf16 dense pass's y to the exact product of its
rounded operands (`chip_smoke.y_ok`) and not to one bf16 ulp of the plain
version.

csrc/fused_mlp.cu computes y = bf16(z @ bf16(W)^T + bias), z =
bf16(relu(x*a + b)), in bf16 on the tensor cores: each mma step adds 16
exact products and the f32 accumulator, truncating. The plain version's
f32 product (cuBLAS on the card, a sequential sum here) adds one product
at a time. Where the terms cancel, both f32 sums miss the exact one by more
than an ulp of the small result, so the two orders can disagree by more
than one bf16 ulp. Shown here on the CPU with an emulated mma order at
cls_ssg's forward dense shapes (SA1 64 -> 128, SA2 128 -> 256), cut to
65536 rows.
"""

import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulp, y_ok
from pointnet2_tpu_torch.ops import fused_mlp

R = 65536


@pytest.fixture(scope="module", params=[(64, 128), (128, 256)],
                ids=["sa1_64_128", "sa2_128_256"])
def orders(request):
    """x (R, Cin) bf16, a, b, W, bias as the card's checks draw them, and y
    in the two orders: a sequential f32 sum in ascending k, and k16 steps
    whose exact sum is added to the accumulator and truncated to f32."""
    cin, cout = request.param
    rs = np.random.RandomState(cin)

    def t(v):
        return torch.from_numpy(np.asarray(v, np.float32))

    x = t(rs.randn(R, cin)).bfloat16()
    a, b = t(rs.uniform(-1.5, 1.5, cin)), t(0.1 * rs.randn(cin))
    w = t(rs.randn(cout, cin) / np.sqrt(cin))
    bias = t(0.1 * rs.randn(cout))
    z = fused_mlp._affine_relu(x, a, b).float()
    wf = w.bfloat16().float()
    seq = torch.zeros(R, cout)
    for k in range(cin):  # each product is exact in f32
        seq = seq + z[:, k:k + 1] * wf[:, k]
    mma = torch.zeros(R, cout)
    for k0 in range(0, cin, 16):
        s = (mma.double()
             + z[:, k0:k0 + 16].double() @ wf[:, k0:k0 + 16].double().t())
        f = s.float()
        over = f.double().abs() > s.abs()  # rounded away from zero
        mma = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return ((x, a, b, w, bias), (seq + bias).bfloat16(),
            (mma + bias).bfloat16())


def test_one_ulp_of_plain_holds_one_summation_order_only(orders):
    _, seq, mma = orders
    d = (mma.float() - seq.float()).abs()
    over = int((d > bf16_ulp(torch, seq.float())).sum())
    assert 0 < over <= 1e-4 * d.numel()


def test_y_ok_holds_both_orders_and_fails_wrong_products(orders):
    args, seq, mma = orders
    assert y_ok(torch, seq, *args) and y_ok(torch, mma, *args)
    x, a, b, w, bias = args
    cin = x.shape[1]
    z = fused_mlp._affine_relu(x, a, b).float()
    wf = w.bfloat16().float()
    half_k = (z[:, :cin // 2] @ wf[:, :cin // 2].t() + bias).bfloat16()
    no_bias = (z @ wf.t()).bfloat16()
    for wrong in (torch.zeros_like(mma), (mma.float() * 1.01).bfloat16(),
                  half_k, no_bias):
        assert not y_ok(torch, wrong, *args)
