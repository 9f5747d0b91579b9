"""Card-only checks of the port: the CUDA kernel against its plain version,
and the entry points on their default device.  Every test carries the
``cuda`` marker and skips without a card.  This file imports neither
``jax`` nor ``repro``, so it runs on the GPU machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.trq import make_params  # noqa: E402
from repro_torch.kernels.trq_group_mvm import kernel as k1  # noqa: E402
from repro_torch.kernels.trq_group_mvm import pack_scalars  # noqa: E402
from repro_torch.kernels.trq_group_mvm.ref import \
    trq_group_mvm_ref  # noqa: E402

REGS = [dict(n_r1=6, n_r2=6, m=4, bias=0.0),
        dict(n_r1=2, n_r2=6, m=1, bias=0.0),
        dict(n_r1=3, n_r2=5, m=4, bias=3.0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _regs(p):
    return dict(n_r1=p.n_r1, n_r2=p.n_r2, m=p.m, nu=p.nu, mode=p.mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["twin", "uniform"])
@pytest.mark.parametrize("rk", REGS, ids=["r6-6", "r2-6", "r3-5-b3"])
@pytest.mark.parametrize("m,k,n", [(3, 300, 130), (16, 256, 64),
                                   (65, 384, 200)])
def test_kernel_exact_on_integer_inputs(card, m, k, n, rk, mode):
    """Integer operands, power-of-two steps and grid: every partial sum is
    exact in f32, so kernel and plain version agree bit for bit."""
    rng = np.random.default_rng(m * k + n)
    a = torch.from_numpy(rng.integers(-8, 9, (m, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-8, 9, (k, n)).astype(np.float32))
    p = make_params(delta_r1=16.0, signed=True, mode=mode, device=card,
                    **rk)
    s = pack_scalars(p, torch.tensor(0.5), card)
    before = k1.LAUNCHES
    y, ops = k1.trq_group_mvm_cuda(a.to(card), w.to(card), s, **_regs(p))
    assert k1.LAUNCHES == before + 1
    y_r, ops_r = trq_group_mvm_ref(a.to(card), w.to(card), s, **_regs(p))
    torch.cuda.synchronize()
    assert torch.equal(y, y_r)
    assert int(ops) == int(ops_r)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    s = torch.zeros(3, device=card)
    with pytest.raises(ValueError, match="contiguous float32 CUDA"):
        k1.trq_group_mvm_cuda(torch.zeros(2, 128, device=card).half(),
                              torch.zeros(128, 4, device=card), s,
                              n_r1=4, n_r2=4, m=3)
    with pytest.raises(ValueError, match="do not contract"):
        k1.trq_group_mvm_cuda(torch.zeros(2, 128, device=card),
                              torch.zeros(64, 4, device=card), s,
                              n_r1=4, n_r2=4, m=3)


@pytest.mark.cuda
def test_runtime_defaults_to_the_card_and_launches_the_kernel(card):
    from repro_torch import runtime
    from repro_torch.models.registry import get_config, init
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        pim_backend="pallas", param_dtype="bfloat16")
    rt = runtime.compile(cfg, init(cfg, seed=0, device=card))
    assert rt.device.type == "cuda"
    before = k1.LAUNCHES
    (logits, _), rep = rt.prefill(np.zeros((1, 16), np.int32), max_len=32)
    assert k1.LAUNCHES - before == 7 * cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    assert rep.total() == 7 * 16 * cfg.n_layers * sum(
        n * -(-kk // 128) for kk, n in [(96, 96), (96, 32), (96, 32),
                                        (96, 96), (96, 192), (96, 192),
                                        (192, 96)])
