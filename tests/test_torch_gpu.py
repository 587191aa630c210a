"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips with a reason where no CUDA device exists
(the kernels have no CPU mode). This file imports no JAX, so it runs on the
machine with the card: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``. Inputs are bf16 at the main path's shapes;
outputs must agree within 1e-2 x max(1, |plain|) (bf16 output rounding and
f32 sums in another order).
"""
import pytest
import torch

from repro_torch.kernels.chunk_prefill import ops as cp
from repro_torch.kernels.decode_attention import ops as da


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(python3 chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("index", [0, 511, 831, (640, 700, 783, 831)])
def test_decode_kernel_on_card(index):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(4, 28, 128, generator=g, device=dev).bfloat16()
    kc = torch.randn(4, 833, 4, 128, generator=g, device=dev).bfloat16()
    vc = torch.randn(4, 833, 4, 128, generator=g, device=dev).bfloat16()
    idx = torch.tensor(index, dtype=torch.int32, device=dev) \
        if isinstance(index, tuple) else index
    got = da.decode_attention(q, kc, vc, idx).float()
    want = da.decode_attention_ref(q.float(), kc, vc, idx)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-2 * want.abs().clamp(min=1)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("index", [0, 320])
def test_chunk_kernel_on_card(index):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(4, 640 - index, 28, 128, generator=g,
                    device=dev).bfloat16()
    kc = torch.randn(4, 640, 4, 128, generator=g, device=dev).bfloat16()
    vc = torch.randn(4, 640, 4, 128, generator=g, device=dev).bfloat16()
    got = cp.chunk_prefill_attention(q, kc, vc, index).float()
    want = cp.chunk_prefill_ref(q.float(), kc, vc, index)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-2 * want.abs().clamp(min=1)).all()


@pytest.mark.gpu
def test_chunk_kernel_chunking_invariance_on_card():
    """Rows computed in one chunk from 0 and in a chunk at 320 are
    bit-equal: each row walks the same absolute key blocks."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, 640, 28, 128, generator=g, device=dev).bfloat16()
    kc = torch.randn(2, 640, 4, 128, generator=g, device=dev).bfloat16()
    vc = torch.randn(2, 640, 4, 128, generator=g, device=dev).bfloat16()
    whole = cp.chunk_prefill_attention(q, kc, vc, 0)
    part = cp.chunk_prefill_attention(q[:, 320:].contiguous(), kc, vc, 320)
    assert torch.equal(whole[:, 320:], part)


@pytest.mark.gpu
def test_kernels_count_launches_on_card():
    dev = _cuda()
    q = torch.zeros(1, 4, 16, device=dev)
    kv = torch.zeros(1, 8, 2, 16, device=dev).bfloat16()
    before = da.decode_attention.launches, cp.chunk_prefill_attention.launches
    da.decode_attention(q, kv, kv, 3)
    cp.chunk_prefill_attention(q[:, None], kv, kv, 3)
    torch.cuda.synchronize()
    assert (da.decode_attention.launches - before[0],
            cp.chunk_prefill_attention.launches - before[1]) == (1, 1)
