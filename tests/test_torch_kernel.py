"""PyTorch port on the card: the encoder-attention CUDA kernel against its
plain version, and the encoder through the kernel against the encoder on
the CPU. These tests need a CUDA card and skip elsewhere. The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, L", [(2, 200), (1, 64), (3, 7)])
def test_kernel_matches_plain(cuda_device, dtype, b, L):
    rng = np.random.default_rng(L)
    heads = 6
    q, k, v = (torch.from_numpy(rng.normal(size=(b, L, heads * 64)).astype(np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    mask = torch.from_numpy((rng.random((b, L)) > 0.2).astype(np.int32)).to(cuda_device)
    mask[-1] = 0  # a row with no valid key: output 0
    rel = torch.from_numpy(rng.normal(size=(32, heads)).astype(np.float32)).to(cuda_device)
    before = tfa.KERNEL_LAUNCHES
    out = tfa.encoder_flash_attention(q, k, v, mask, rel, num_heads=heads)
    torch.cuda.synchronize()
    assert tfa.KERNEL_LAUNCHES == before + 1
    ref = tfa.encoder_attention_reference(q, k, v, mask, rel, num_heads=heads)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert out[-1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_encode_on_card_matches_cpu(cuda_device):
    """fp32 encode through the kernel equals fp32 encode on the CPU (plain
    attention) at head width 64."""
    cfg = tt5.T5Config(d_model=128, d_kv=64, d_ff=256, num_heads=2, num_encoder_layers=2,
                       num_decoder_layers=1)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(3, 259, (3, 150)))
    mask = torch.ones((3, 150), dtype=torch.int32)
    mask[1, 100:] = 0
    cpu = tt5.encode(params, cfg, ids, mask)
    on_card = tt5.place_params(params, cfg, cuda_device)
    before = tfa.KERNEL_LAUNCHES
    gpu = tt5.encode(on_card, cfg, ids.to(cuda_device), mask.to(cuda_device)).cpu()
    assert tfa.KERNEL_LAUNCHES == before + cfg.num_encoder_layers
    np.testing.assert_allclose(gpu.numpy(), cpu.numpy(), atol=1e-4, rtol=1e-4)
