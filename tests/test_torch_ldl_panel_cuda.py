"""The CUDA panel kernel vs its plain PyTorch version on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built from
``parapint_tpu_torch/csrc`` at first use); skips elsewhere.  On the card:

    python -m pytest tests/test_torch_ldl_panel_cuda.py -m cuda -q

Tolerance: none.  The kernel rounds every update as its plain version does
(product rounded before the subtraction, IEEE division), so the lower
triangle of the packed factor and W agree bit for bit; inertia then does too.
"""

import numpy as np
import pytest
import torch

from parapint_tpu_torch.ops.ldl_panel import (
    ldl_panels_slab_winv,
    ldl_panels_slab_winv_plain,
    random_panels as _panels,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape", [(64, 64, 64), (32, 56, 56), (16, 56, 56), (1, 56, 56), (64, 128, 128), (3, 8, 8)]
)
def test_kernel_matches_plain_version(cuda, shape):
    A = torch.as_tensor(_panels(*shape[:2], seed=shape[0]), device=cuda)
    before = ldl_panels_slab_winv.launches
    LD, W = ldl_panels_slab_winv(A)
    torch.cuda.synchronize()
    assert ldl_panels_slab_winv.launches == before + 1
    LDp, Wp = ldl_panels_slab_winv_plain(A)
    assert torch.equal(torch.tril(LD), torch.tril(LDp))
    assert torch.equal(W, Wp)
    assert torch.equal(torch.sign(torch.diagonal(LD, dim1=1, dim2=2)),
                       torch.sign(torch.diagonal(LDp, dim1=1, dim2=2)))
    assert torch.triu(LD, 1).abs().max().item() == 0.0


def test_kernel_reads_only_the_lower_triangle(cuda):
    A = _panels(8, 64, seed=1)
    G = A.copy()
    iu = np.triu_indices(64, 1)
    G[:, iu[0], iu[1]] = 1e3
    LD, W = ldl_panels_slab_winv(torch.as_tensor(A, device=cuda))
    LDg, Wg = ldl_panels_slab_winv(torch.as_tensor(G, device=cuda))
    assert torch.equal(LD, LDg) and torch.equal(W, Wg)


def test_kernel_rejects_float64(cuda):
    with pytest.raises(TypeError):
        ldl_panels_slab_winv(torch.zeros(2, 16, 16, dtype=torch.float64, device=cuda))
